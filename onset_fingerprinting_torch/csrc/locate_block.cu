// The realtime engine's per-block locate step for Hopper, sm_90a: every
// channel that fired in a 128-sample block goes through the fixed-capacity
// locator in onset order, then the completed hits go to the event queue,
// and the engine's sample counter advances by the block.
//
// Replaces the locate half of the JAX engine's per-block program,
// onset_fingerprinting_tpu/realtime/engine.py:249-304 (the unrolled
// make_locate_update calls of locate/multilaterate.py:587 and the queue
// push).  That is no Pallas kernel: XLA fuses it into the block's program.
// In PyTorch ops it is about a thousand small operations per channel,
// several thousand kernels per block, more than the block's 1.333 ms even
// replayed from a CUDA graph; so it is this one launch.  Its plain version,
// ops/locate_block.py::locate_block_reference, is the JAX step's masks
// ported literally.
//
// What bounds it: nothing the card is short of.  It reads a few hundred
// bytes of state and, for a completing group, two lag maps (2 x 35 x 35
// floats); the rest is short dependent chains.  So the time is latency:
// the launch, a few trips to memory and whatever runs on one thread.
//
// The design, in place (the state and the queue are updated where they
// lie, so the engine's captured step needs no copies around it):
// - Every thread reads `on`, `deltas` and the counter once, into shared
//   memory; one __syncthreads_or tells every thread whether a channel
//   fired.  A quiet block (nearly every block) writes its hit outputs and
//   the counter and leaves: the locator and the queue stay untouched.
// - On a fired block warp 0 holds the locator: lane g owns slot g (G <=
//   32) in registers.  Each update's per-slot tests run across the lanes,
//   and its selections -- the seed-swap target, the oldest feasible
//   completer, the eviction slot -- are warp argmins (__reduce_min_sync,
//   then the lowest lane by ballot: torch.argmin's first minimum).  The
//   fired channels' onset order is a rank per lane (stable, as
//   jnp.argsort).
// - Only a completing group needs the CTA: its lag-map cells are scanned
//   by all threads for the least legal column-major index per tier
//   (atomicMin; the plain version's argmax over the flat mask).  One
//   barrier per update tells the CTA whether to scan, a second ends it.
// - The Newton solve (20 masked iterations) runs on lane 0 with the
//   triangle in registers and stops at the first iteration whose mask
//   freezes the iterate: the later ones change nothing.
// - With a learned locator (the JAX step's model= path,
//   locate/multilaterate.py:789-815 there) the completion evaluates the
//   FCNN instead: its BatchNorm folded into each Dense and all layers
//   packed into one buffer at LocateBlock's construction
//   (ops/locate_block.py::pack_fcnn).  Warp 0 runs one unit per lane (in
//   passes of 32, up to FCNN_MAX_W units per layer), the layer's input and
//   output vectors in shared memory, one __syncwarp per layer; the
//   features are the group's two lags ("arrival") or the adjacent
//   channel-order differences of its onsets in int32 ("by_channel").  A
//   point is emitted only where the prediction (meters x 100) is finite.
//   Each unit sums bias + W[j][k] * h[k] for k in order, every product and
//   sum rounded on its own (fcnn_packed_reference emulates it on the CPU).
// - Lane g writes its slot back only where it changed, lane 0 the queue
//   entries of the block's hits, the queue counter, next_age and the
//   sample counter.
//
// Numerics: compiled with -fmad=false, each multiply and add rounds on its
// own in the plain version's order; sqrt and division are IEEE (an
// approximate reciprocal could flip `converged` at the margin and change
// an event).  The two can differ only where the plain version's sum of
// three squares runs in another order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define MAX_CH 32
#define MAX_SLOTS 32
#define MAX_TIERS 4
#define FCNN_MAX_W 64
#define FCNN_MAX_HIDDEN 8
#define THREADS 256
#define FULL 0xffffffffu

// must match ops/locate_block.py::_LocDesc
struct LocDesc {
    int C, G, S, H, W, E, T, B;
    float radius, c_over_sr;
    float tols[MAX_TIERS];
    // the learned locator: layers = hidden + 1, widths[0..layers]
    int has_model, n_layers, act, model_input;
    int widths[FCNN_MAX_HIDDEN + 2];
};

static const int AGE_INF = 2147483647;
static const int AGE_REBASE = 1 << 30;
static const int BIG = 1000000000;

// NaN-propagating max of |a|, |b|, as torch.amax
__device__ __forceinline__ float amax2(float a, float b) {
    a = fabsf(a);
    b = fabsf(b);
    if (isnan(a) || isnan(b)) return nanf("");
    return a > b ? a : b;
}

// the lowest lane holding the least key (torch.argmin's first minimum)
__device__ __forceinline__ int argmin_lane(int key) {
    const int m = __reduce_min_sync(FULL, key);
    return __ffs(__ballot_sync(FULL, key == m)) - 1;
}

// residuals f and Jacobian j of the TDOA system at p (locate/
// trilateration.py::_residual_jac_3d); rows of s: origin, a, b
__device__ __forceinline__ void resid_jac(float px, float py,
                                          const float (&s)[3][3], float d0,
                                          float d1, float f[2],
                                          float j[2][2]) {
    float dist[3], gx[3], gy[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        float dx = px - s[r][0];
        float dy = py - s[r][1];
        float dz = 0.0f - s[r][2];
        dist[r] = sqrtf((dx * dx + dy * dy) + dz * dz);
        gx[r] = dx / dist[r];
        gy[r] = dy / dist[r];
    }
    f[0] = (dist[1] - dist[0]) - d0;
    f[1] = (dist[2] - dist[0]) - d1;
    j[0][0] = gx[1] - gx[0];
    j[0][1] = gy[1] - gy[0];
    j[1][0] = gx[2] - gx[0];
    j[1][1] = gy[2] - gy[0];
}

// the FCNN's activations (ops/locate_block.py::ACT_CODES; models/fcnn.py)
__device__ __forceinline__ float act(int code, float x) {
    switch (code) {
        case 0: return x < 0.0f ? 0.0f : x;                   // relu
        case 1: return x / (1.0f + expf(-x));                 // silu
        case 2: return x > 0.0f ? x : 0.01f * x;              // leakyrelu
        case 3: return x > 0.0f ? x : expm1f(x);              // elu
        case 4: return tanhf(x);                              // tanh
        default: return 1.0f / (1.0f + expf(-x));             // sigmoid
    }
}

// the packed FCNN on (f0, f1), by warp 0 (every lane calls it): lane l
// computes units l, l + 32 of each layer; h holds the layer's input and
// output.  Returns whether the point (meters x 100 = cm) is finite.
__device__ bool fcnn_point(const LocDesc& d, const float* __restrict__ net,
                           float (*h)[FCNN_MAX_W], int lane, float f0,
                           float f1, float* px, float* py) {
    __syncwarp();
    if (lane == 0) {
        h[0][0] = f0;
        h[0][1] = f1;
    }
    __syncwarp();
    int cur = 0;
    const float* p = net;
    for (int l = 0; l < d.n_layers; ++l) {
        const int nin = d.widths[l], nout = d.widths[l + 1];
        const float* w = p;
        const float* b = p + nin * nout;
        const bool last = l == d.n_layers - 1;
        for (int j = lane; j < nout; j += 32) {
            float acc = b[j];
            for (int k = 0; k < nin; ++k) acc = acc + w[j * nin + k] * h[cur][k];
            h[cur ^ 1][j] = last ? acc : act(d.act, acc);
        }
        __syncwarp();
        cur ^= 1;
        p += nin * nout + nout;
    }
    *px = h[cur][0] * 100.0f;
    *py = h[cur][1] * 100.0f;
    return isfinite(*px) && isfinite(*py);
}

// damped Newton, 20 masked iterations (trilateration.py::solve_tdoa,
// unroll=True); returns success.  Once `done`, an iteration changes
// nothing, so the loop ends there.
__device__ __forceinline__ bool solve_tdoa(const float (&s)[3][3],
                                           float d0, float d1, float* px,
                                           float* py) {
    const float xtol = 0.01f;
    bool done = false, ok = true;
    float x = *px, y = *py;
    float f[2], j[2][2];
    for (int it = 0; it < 20 && !done; ++it) {
        resid_jac(x, y, s, d0, d1, f, j);
        float det = j[0][0] * j[1][1] - j[0][1] * j[1][0];
        float safe = fabsf(det) < 1e-12f ? 1.0f : det;
        bool solvable = fabsf(det) >= 1e-12f;
        float s0 = (j[1][1] * f[0] - j[0][1] * f[1]) / safe;
        float s1 = ((-j[1][0]) * f[0] + j[0][0] * f[1]) / safe;
        bool converged = amax2(s0, s1) < xtol;
        x = x - s0;
        y = y - s1;
        ok = ok && solvable;
        done = converged || !solvable;
    }
    resid_jac(x, y, s, d0, d1, f, j);
    *px = x;
    *py = y;
    float bound = 0.1f * (1.0f + amax2(d0, d1));
    return ok && done && isfinite(x) && isfinite(y) && amax2(f[0], f[1]) < bound;
}

__global__ void __launch_bounds__(THREADS) locate_block_kernel(
    LocDesc d, const uint8_t* __restrict__ on, const int32_t* __restrict__ deltas,
    int32_t* sample_count, int32_t* sens_g, int32_t* ons_g, int32_t* cnt_g,
    int32_t* age_g, int32_t* next_g, const float* __restrict__ maps,
    const float* __restrict__ min_l, const float* __restrict__ max_l,
    const float* __restrict__ mml, const float* __restrict__ xyz, float* qp,
    int32_t* qo, int32_t* qe, int32_t* qc, int32_t* hit_onsets,
    float* hit_points, uint8_t* hit_emits, const float* __restrict__ fcnn) {
    __shared__ int s_on[MAX_CH], s_delta[MAX_CH], s_order[MAX_CH];
    __shared__ float s_h[2][FCNN_MAX_W];
    __shared__ int s_emit[MAX_CH];
    __shared__ float s_pts[MAX_CH][2];
    // per update: the completing groups to scan (two buffers: the next
    // update's count may be written while a warp still reads this one's)
    __shared__ int s_nscan[2];
    __shared__ int s_lm1[MAX_SLOTS], s_lm2[MAX_SLOTS];
    __shared__ float s_lag1[MAX_SLOTS], s_lag2[MAX_SLOTS];
    __shared__ int s_best[MAX_SLOTS][MAX_TIERS];
    const int tid = threadIdx.x, lane = tid & 31;
    const int C = d.C, G = d.G, S = d.S, H = d.H, W = d.W, E = d.E, T = d.T;

    // read once, by every thread, before the first barrier: the counter is
    // written after it
    int fired = 0;
    if (tid < C) {
        fired = on[tid];
        s_on[tid] = fired;
        s_delta[tid] = deltas[tid];
    }
    const int sample = sample_count[0];
    if (!__syncthreads_or(fired)) {
        // a quiet block: the block's hits and the counter, nothing else
        if (tid < C) {
            hit_onsets[tid] = sample + s_delta[tid];
            hit_points[2 * tid] = 0.0f;
            hit_points[2 * tid + 1] = 0.0f;
            hit_emits[tid] = 0;
        }
        if (tid == 0) sample_count[0] = sample + d.B;
        return;
    }
    // the number of fired channels, in every warp (the loop below is
    // uniform across the CTA: its barriers need every thread)
    const int n_fired =
        __popc(__ballot_sync(FULL, lane < C && s_on[lane] != 0));

    // warp 0: lane g holds slot g
    const bool act = lane < G;
    int s0 = -1, s1 = -1, s2 = -1, o0 = 0, o1 = 0, o2 = 0, cnt = 0, age = 0;
    int next_age = 0, q0 = 0;
    if (tid < 32) {
        if (act) {
            s0 = sens_g[lane * 3];
            s1 = sens_g[lane * 3 + 1];
            s2 = sens_g[lane * 3 + 2];
            o0 = ons_g[lane * 3];
            o1 = ons_g[lane * 3 + 1];
            o2 = ons_g[lane * 3 + 2];
            cnt = cnt_g[lane];
            age = age_g[lane];
        }
        next_age = next_g[0];
        q0 = qc[0];
        // stable rank of where(on, deltas, BIG): the onset order
        if (lane < C) {
            const int key = s_on[lane] ? s_delta[lane] : BIG;
            int rank = 0;
            for (int c = 0; c < C; ++c) {
                const int kc = s_on[c] ? s_delta[c] : BIG;
                rank += kc < key || (kc == key && c < lane);
            }
            s_order[rank] = lane;
            s_emit[lane] = 0;
            s_pts[lane][0] = s_pts[lane][1] = 0.0f;
        }
        __syncwarp();
    }
    const int os0 = s0, os1 = s1, os2 = s2, oo0 = o0, oo1 = o1, oo2 = o2,
              ocnt = cnt, oage = age;

    for (int i = 0; i < n_fired; ++i) {
        const int buf = i & 1;
        int sensor = 0, onset = 0, cslot = 0;
        bool al = false, jn = false, comp = false;
        if (tid < 32) {
            const int ch = s_order[i];
            sensor = ch;
            onset = sample + s_delta[ch];
            // negative-lag seed swap against the oldest group whose seed
            // came after this onset
            const bool sw = act && cnt > 0 && onset - o0 < 0;
            const int gswap = argmin_lane(sw ? age : AGE_INF);
            const bool any_swap = __any_sync(FULL, sw);
            const int old_s = __shfl_sync(FULL, s0, gswap);
            const int old_o = __shfl_sync(FULL, o0, gswap);
            if (any_swap) {
                if (lane == gswap) {
                    s0 = sensor;
                    o0 = onset;
                }
                sensor = old_s;
                onset = old_o;
            }
            const float lag = (float)(onset - o0);
            const int seed = max(s0, 0);
            al = act && cnt > 0 && lag <= mml[seed];
            const bool member = (s0 == sensor && 0 < cnt) ||
                                (s1 == sensor && 1 < cnt) ||
                                (s2 == sensor && 2 < cnt);
            const bool legal = min_l[seed * S + sensor] < lag &&
                               lag < max_l[seed * S + sensor];
            jn = al && !member && legal && cnt < 3;
            comp = jn && cnt == 2;
            const unsigned cmask = __ballot_sync(FULL, comp);
            cslot = __popc(cmask & ((1u << lane) - 1u));
            if (comp) {
                s_lm1[cslot] = seed * S + max(s1, 0);
                s_lm2[cslot] = seed * S + sensor;
                s_lag1[cslot] = (float)(o1 - o0);
                s_lag2[cslot] = lag;
                for (int t = 0; t < MAX_TIERS; ++t)
                    s_best[cslot][t] = AGE_INF;
            }
            if (lane == 0) s_nscan[buf] = __popc(cmask);
        }
        __syncthreads();
        const int nscan = s_nscan[buf];
        if (nscan > 0) {
            // the least column-major cell index where both lags fit, per
            // completing group and tier
            for (int k = 0; k < nscan; ++k) {
                const float* lm1 = maps + (size_t)s_lm1[k] * H * W;
                const float* lm2 = maps + (size_t)s_lm2[k] * H * W;
                const float lag1 = s_lag1[k], lag2 = s_lag2[k];
                for (int f = tid; f < H * W; f += THREADS) {
                    const int col = f / H, row = f % H;
                    const float a = lm1[row * W + col], b = lm2[row * W + col];
                    for (int t = 0; t < T; ++t) {
                        const float tol = d.tols[t];
                        if (a < lag1 + tol && a > lag1 - tol &&
                            b < lag2 + tol && b > lag2 - tol)
                            atomicMin(&s_best[k][t], f);
                    }
                }
            }
            __syncthreads();
        }
        if (tid >= 32) continue;

        // the oldest feasible completer; a tier is feasible where its least
        // legal index is a cell other than (0, 0)
        int tier = -1;
        if (comp)
            for (int t = 0; t < T && tier < 0; ++t)
                if (s_best[cslot][t] != AGE_INF && s_best[cslot][t] != 0)
                    tier = t;
        const bool feas = comp && tier >= 0;
        const int gidx = argmin_lane(feas ? age : AGE_INF);
        const bool returned = __any_sync(FULL, feas);
        const int cell =
            __shfl_sync(FULL, feas ? s_best[cslot][tier] : 0, gidx);
        const int seed_s = __shfl_sync(FULL, s0, gidx);
        const int seed_o = __shfl_sync(FULL, o0, gidx);
        const int g_s1 = __shfl_sync(FULL, s1, gidx);
        const int g_o1 = __shfl_sync(FULL, o1, gidx);
        const int age_g = __shfl_sync(FULL, age, gidx);
        bool emit = false;
        float px = 0.0f, py = 0.0f;
        if (returned && d.has_model) {
            // returned is uniform across warp 0: every lane takes part
            float f0, f1;
            if (d.model_input == 1) {
                int by_ch[3] = {0, 0, 0};
                by_ch[max(seed_s, 0)] = seed_o;
                by_ch[max(g_s1, 0)] = g_o1;
                by_ch[sensor] = onset;
                f0 = (float)(by_ch[1] - by_ch[0]);
                f1 = (float)(by_ch[2] - by_ch[1]);
            } else {
                f0 = (float)(g_o1 - seed_o);
                f1 = (float)(onset - seed_o);
            }
            emit = fcnn_point(d, fcnn, s_h, lane, f0, f1, &px, &py);
        } else if (returned && lane == 0) {
            const int a0 = max(seed_s, 0), a1 = max(g_s1, 0);
            const float lag1 = (float)(g_o1 - seed_o);
            const float lag2 = (float)(onset - seed_o);
            float tri[3][3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                tri[0][k] = xyz[a0 * 3 + k];
                tri[1][k] = xyz[a1 * 3 + k];
                tri[2][k] = xyz[sensor * 3 + k];
            }
            px = (float)(cell / H) - d.radius;
            py = (float)(cell % H) - d.radius;
            emit = solve_tdoa(tri, lag1 * d.c_over_sr, lag2 * d.c_over_sr,
                              &px, &py);
        }
        emit = __shfl_sync(FULL, emit, 0);
        // joins (an infeasible completer keeps its third member), then the
        // drops of the completion path
        const bool same_seed = s0 == seed_s && o0 == seed_o;
        const bool later_or_self = age >= age_g;
        int n = cnt;
        if (jn) {
            const int pos = min(max(cnt, 0), 2);
            if (pos == 0) { s0 = sensor; o0 = onset; }
            if (pos == 1) { s1 = sensor; o1 = onset; }
            if (pos == 2) { s2 = sensor; o2 = onset; }
            n += 1;
        }
        const bool keep =
            al && !(returned && later_or_self) && !(emit && same_seed);
        int newcnt = keep ? n : 0;
        if (!returned) {
            // the fresh group: a free slot, else the oldest one
            const int ins = argmin_lane(
                act ? (newcnt == 0 ? age - AGE_REBASE : age) : AGE_INF);
            if (lane == ins) {
                s0 = sensor;
                s1 = -1;
                s2 = -1;
                o0 = onset;
                newcnt = 1;
                age = next_age;
            }
        }
        const int new_next = next_age + 1;
        const int base = __reduce_min_sync(
            FULL, act ? (newcnt > 0 ? age : new_next) : AGE_INF);
        const int shift = new_next > AGE_REBASE ? base : 0;
        age = newcnt > 0 ? age - shift : (shift > 0 ? 0 : age);
        cnt = newcnt;
        next_age = new_next - shift;
        if (lane == 0) {
            const int ch = s_order[i];
            s_pts[ch][0] = emit ? px : 0.0f;
            s_pts[ch][1] = emit ? py : 0.0f;
            s_emit[ch] = emit;
        }
    }
    if (tid >= 32) return;
    __syncwarp();

    // the slots that changed
    if (act) {
        if (s0 != os0) sens_g[lane * 3] = s0;
        if (s1 != os1) sens_g[lane * 3 + 1] = s1;
        if (s2 != os2) sens_g[lane * 3 + 2] = s2;
        if (o0 != oo0) ons_g[lane * 3] = o0;
        if (o1 != oo1) ons_g[lane * 3 + 1] = o1;
        if (o2 != oo2) ons_g[lane * 3 + 2] = o2;
        if (cnt != ocnt) cnt_g[lane] = cnt;
        if (age != oage) age_g[lane] = age;
    }
    if (lane < C) {
        hit_onsets[lane] = sample + s_delta[lane];
        hit_points[2 * lane] = s_pts[lane][0];
        hit_points[2 * lane + 1] = s_pts[lane][1];
        hit_emits[lane] = s_emit[lane] ? 1 : 0;
    }
    if (lane == 0) {
        // completed hits to the event queue, in channel order
        int q = q0;
        for (int c = 0; c < C; ++c) {
            if (!s_emit[c]) continue;
            const int slot = ((q % E) + E) % E;
            qp[2 * slot] = s_pts[c][0];
            qp[2 * slot + 1] = s_pts[c][1];
            qo[slot] = sample + s_delta[c];
            qe[slot] = sample;
            q += 1;
        }
        if (q != q0) qc[0] = q;
        next_g[0] = next_age;
        sample_count[0] = sample + d.B;
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// One launch per block.  The locator state, the event queue and the sample
// counter are updated in place; the block's hits go to fresh outputs.
// `fcnn` is the packed learned locator (null without one).
extern "C" int ofpt_locate_block(
    const LocDesc* hd, const uint8_t* on, const int32_t* deltas,
    int32_t* sample_count, int32_t* sens, int32_t* ons, int32_t* cnt,
    int32_t* age, int32_t* next, const float* maps, const float* min_l,
    const float* max_l, const float* mml, const float* xyz, float* qp,
    int32_t* qo, int32_t* qe, int32_t* qc, int32_t* hit_onsets,
    float* hit_points, uint8_t* hit_emits, const float* fcnn,
    void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const LocDesc d = *hd;
    if (d.C > MAX_CH || d.G < 1 || d.G > MAX_SLOTS || d.T > MAX_TIERS ||
        d.E < 1)
        return (int)cudaErrorInvalidValue;
    if (d.has_model) {
        if (fcnn == nullptr || d.n_layers < 1 ||
            d.n_layers > FCNN_MAX_HIDDEN + 1 || d.widths[0] != 2 ||
            d.widths[d.n_layers] != 2 || (d.model_input == 1 && d.S != 3))
            return (int)cudaErrorInvalidValue;
        for (int l = 0; l <= d.n_layers; ++l)
            if (d.widths[l] < 1 || d.widths[l] > FCNN_MAX_W)
                return (int)cudaErrorInvalidValue;
    }
    locate_block_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        d, on, deltas, sample_count, sens, ons, cnt, age, next, maps, min_l,
        max_l, mml, xyz, qp, qo, qe, qc, hit_onsets, hit_points, hit_emits,
        fcnn);
    return (int)cudaGetLastError();
}
