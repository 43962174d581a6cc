// The realtime engine's per-block locate step for Hopper, sm_90a: every
// channel that fired in a 128-sample block goes through the fixed-capacity
// locator in onset order, then the completed hits go to the event queue.
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
// What bounds it: nothing the card is short of.  It reads the locator
// state (a few hundred bytes), and for a completing group two lag maps
// (2 x 35 x 35 floats); the work is a short dependent chain on one thread.
// The launch itself is the floor.
//
// The design: one CTA.  Thread 0 runs the sequential part exactly as the
// plain version orders it (seed swap, join, completion, eviction, age
// rebase, twenty Newton iterations); the CTA's threads scan the lag-map
// cells of a completing group in parallel for the first feasible cell of
// each tier (the plain version's argmax over the column-major flat index
// is the least legal index, found here by atomicMin).  A channel that did
// not fire is skipped, which is what the plain version's masked select
// amounts to.  Numerics: compiled with -fmad=false, each multiply and add
// rounds on its own in the plain version's order; sqrt and division are
// IEEE.  The two can differ only where the plain version's sum of three
// squares runs in another order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define MAX_CH 32
#define MAX_SLOTS 64
#define MAX_TIERS 4
#define THREADS 256

// must match ops/locate_block.py::_LocDesc
struct LocDesc {
    int C, G, S, H, W, E, T, B;
    float radius, c_over_sr;
    float tols[MAX_TIERS];
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

// residuals f and Jacobian j of the TDOA system at p (locate/
// trilateration.py::_residual_jac_3d); rows of s: origin, a, b
__device__ void resid_jac(float px, float py, const float s[3][3], float d0,
                          float d1, float f[2], float j[2][2]) {
    float dist[3], gx[3], gy[3];
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

// damped Newton, 20 masked iterations (trilateration.py::solve_tdoa,
// unroll=True); returns success
__device__ bool solve_tdoa(const float s[3][3], float d0, float d1,
                           float* px, float* py) {
    const float xtol = 0.01f;
    bool done = false, ok = true;
    float x = *px, y = *py;
    float f[2], j[2][2];
    for (int it = 0; it < 20; ++it) {
        resid_jac(x, y, s, d0, d1, f, j);
        float det = j[0][0] * j[1][1] - j[0][1] * j[1][0];
        float safe = fabsf(det) < 1e-12f ? 1.0f : det;
        bool solvable = fabsf(det) >= 1e-12f;
        float s0 = (j[1][1] * f[0] - j[0][1] * f[1]) / safe;
        float s1 = ((-j[1][0]) * f[0] + j[0][0] * f[1]) / safe;
        bool converged = amax2(s0, s1) < xtol;
        if (!done) {
            x = x - s0;
            y = y - s1;
            ok = ok && solvable;
            done = converged || !solvable;
        }
    }
    resid_jac(x, y, s, d0, d1, f, j);
    *px = x;
    *py = y;
    float bound = 0.1f * (1.0f + amax2(d0, d1));
    return ok && done && isfinite(x) && isfinite(y) && amax2(f[0], f[1]) < bound;
}

__global__ void __launch_bounds__(THREADS) locate_block_kernel(
    LocDesc d, const uint8_t* __restrict__ on, const int32_t* __restrict__ deltas,
    const int32_t* __restrict__ sample_count,
    const int32_t* sens_in, const int32_t* ons_in, const int32_t* cnt_in,
    const int32_t* age_in, const int32_t* next_in,
    int32_t* sens_out, int32_t* ons_out, int32_t* cnt_out, int32_t* age_out,
    int32_t* next_out,
    const float* __restrict__ maps, const float* __restrict__ min_l,
    const float* __restrict__ max_l, const float* __restrict__ mml,
    const float* __restrict__ xyz,
    const float* qp_in, const int32_t* qo_in, const int32_t* qe_in,
    const int32_t* qc_in, float* qp_out, int32_t* qo_out, int32_t* qe_out,
    int32_t* qc_out, int32_t* hit_onsets, float* hit_points,
    uint8_t* hit_emits) {
    __shared__ int sens[MAX_SLOTS][3], ons[MAX_SLOTS][3], cnt[MAX_SLOTS],
        age[MAX_SLOTS];
    __shared__ int next_age, sample;
    __shared__ int order[MAX_CH], onset_abs[MAX_CH], emitted[MAX_CH];
    __shared__ float pts[MAX_CH][2];
    // per update: the (possibly swapped) incoming event and each slot's
    // tests
    __shared__ int u_sensor, u_onset;
    __shared__ int alive[MAX_SLOTS], joinable[MAX_SLOTS], completes[MAX_SLOTS];
    __shared__ int best[MAX_SLOTS][MAX_TIERS];
    const int tid = threadIdx.x;
    const int C = d.C, G = d.G, S = d.S, H = d.H, W = d.W, E = d.E, T = d.T;

    for (int g = tid; g < G; g += THREADS) {
        for (int k = 0; k < 3; ++k) {
            sens[g][k] = sens_in[g * 3 + k];
            ons[g][k] = ons_in[g * 3 + k];
        }
        cnt[g] = cnt_in[g];
        age[g] = age_in[g];
    }
    for (int e = tid; e < E; e += THREADS) {
        qp_out[2 * e] = qp_in[2 * e];
        qp_out[2 * e + 1] = qp_in[2 * e + 1];
        qo_out[e] = qo_in[e];
        qe_out[e] = qe_in[e];
    }
    if (tid == 0) {
        next_age = next_in[0];
        sample = sample_count[0];
        for (int c = 0; c < C; ++c) {
            onset_abs[c] = sample + deltas[c];
            hit_onsets[c] = onset_abs[c];
            pts[c][0] = pts[c][1] = 0.0f;
            emitted[c] = 0;
            // stable insertion sort of where(on, deltas, BIG)
            int key = on[c] ? deltas[c] : BIG;
            int i = c;
            while (i > 0) {
                int o = order[i - 1];
                int ko = on[o] ? deltas[o] : BIG;
                if (ko <= key) break;
                order[i] = o;
                --i;
            }
            order[i] = c;
        }
    }
    __syncthreads();

    for (int i = 0; i < C; ++i) {
        const int ch = order[i];
        if (!on[ch]) continue;  // uniform: every thread reads the same flag
        if (tid == 0) {
            int sensor = ch, onset = onset_abs[ch];
            // negative-lag seed swap against the oldest group whose seed
            // came after this onset
            int gswap = 0, kbest = AGE_INF;
            bool any_swap = false;
            for (int g = 0; g < G; ++g) {
                bool sw = cnt[g] > 0 && onset - ons[g][0] < 0;
                any_swap = any_swap || sw;
                int key = sw ? age[g] : AGE_INF;
                if (g == 0 || key < kbest) {
                    kbest = key;
                    gswap = g;
                }
            }
            int old_s = sens[gswap][0], old_o = ons[gswap][0];
            if (any_swap) {
                sens[gswap][0] = sensor;
                ons[gswap][0] = onset;
                sensor = old_s;
                onset = old_o;
            }
            u_sensor = sensor;
            u_onset = onset;
            for (int g = 0; g < G; ++g) {
                float lag = (float)(onset - ons[g][0]);
                int seed = max(sens[g][0], 0);
                bool al = cnt[g] > 0 && lag <= mml[seed];
                bool member = false;
                for (int k = 0; k < 3; ++k)
                    member = member || (sens[g][k] == sensor && k < cnt[g]);
                bool legal = min_l[seed * S + sensor] < lag &&
                             lag < max_l[seed * S + sensor];
                bool jn = al && !member && legal && cnt[g] < 3;
                alive[g] = al;
                joinable[g] = jn;
                completes[g] = jn && cnt[g] == 2;
            }
        }
        for (int k = tid; k < G * MAX_TIERS; k += THREADS)
            best[k / MAX_TIERS][k % MAX_TIERS] = AGE_INF;
        __syncthreads();

        // the least column-major cell index where both lags fit, per
        // completing group and tier
        for (int g = 0; g < G; ++g) {
            if (!completes[g]) continue;
            const int seed = max(sens[g][0], 0);
            const int s1 = max(sens[g][1], 0);
            const float lag1 = (float)(ons[g][1] - ons[g][0]);
            const float lag2 = (float)(u_onset - ons[g][0]);
            const float* lm1 = maps + (size_t)(seed * S + s1) * H * W;
            const float* lm2 = maps + (size_t)(seed * S + u_sensor) * H * W;
            for (int f = tid; f < H * W; f += THREADS) {
                const int col = f / H, row = f % H;
                const float a = lm1[row * W + col], b = lm2[row * W + col];
                for (int t = 0; t < T; ++t) {
                    const float tol = d.tols[t];
                    if (a < lag1 + tol && a > lag1 - tol && b < lag2 + tol &&
                        b > lag2 - tol)
                        atomicMin(&best[g][t], f);
                }
            }
        }
        __syncthreads();

        if (tid == 0) {
            const int sensor = u_sensor, onset = u_onset;
            // the oldest feasible completer; a tier is feasible where its
            // least legal index is a cell other than (0, 0)
            bool returned = false;
            int gidx = 0, kbest = AGE_INF;
            float cx = 0.0f, cy = 0.0f;
            for (int g = 0; g < G; ++g) {
                int tier = -1;
                for (int t = 0; t < T && tier < 0; ++t)
                    if (best[g][t] != AGE_INF && best[g][t] != 0) tier = t;
                bool feasible = completes[g] && tier >= 0;
                returned = returned || feasible;
                int key = feasible ? age[g] : AGE_INF;
                if (g == 0 || key < kbest) {
                    kbest = key;
                    gidx = g;
                    if (feasible) {
                        cx = (float)(best[g][tier] / H);
                        cy = (float)(best[g][tier] % H);
                    }
                }
            }
            bool emit = false;
            float px = 0.0f, py = 0.0f;
            if (returned) {
                int s0 = max(sens[gidx][0], 0), s1 = max(sens[gidx][1], 0);
                float lag1 = (float)(ons[gidx][1] - ons[gidx][0]);
                float lag2 = (float)(onset - ons[gidx][0]);
                float tri[3][3];
                for (int k = 0; k < 3; ++k) {
                    tri[0][k] = xyz[s0 * 3 + k];
                    tri[1][k] = xyz[s1 * 3 + k];
                    tri[2][k] = xyz[sensor * 3 + k];
                }
                px = cx - d.radius;
                py = cy - d.radius;
                emit = solve_tdoa(tri, lag1 * d.c_over_sr, lag2 * d.c_over_sr,
                                  &px, &py);
            }
            // joins (an infeasible completer keeps its third member), then
            // the drops of the completion path
            const int seed_s = sens[gidx][0], seed_o = ons[gidx][0];
            const int age_g = age[gidx];
            int newcnt[MAX_SLOTS];
            for (int g = 0; g < G; ++g) {
                bool same_seed = sens[g][0] == seed_s && ons[g][0] == seed_o;
                bool later_or_self = age[g] >= age_g;
                int n = cnt[g];
                if (joinable[g]) {
                    int pos = min(max(cnt[g], 0), 2);
                    sens[g][pos] = sensor;
                    ons[g][pos] = onset;
                    n += 1;
                }
                bool keep = alive[g] && !(returned && later_or_self) &&
                            !(emit && same_seed);
                newcnt[g] = keep ? n : 0;
            }
            if (!returned) {
                // the fresh group: a free slot, else the oldest one
                int ins = 0, kmin = 0;
                for (int g = 0; g < G; ++g) {
                    int key = newcnt[g] == 0 ? age[g] - AGE_REBASE : age[g];
                    if (g == 0 || key < kmin) {
                        kmin = key;
                        ins = g;
                    }
                }
                sens[ins][0] = sensor;
                sens[ins][1] = -1;
                sens[ins][2] = -1;
                ons[ins][0] = onset;
                newcnt[ins] = 1;
                age[ins] = next_age;
            }
            int new_next = next_age + 1;
            int base = new_next;
            bool first = true;
            for (int g = 0; g < G; ++g) {
                int v = newcnt[g] > 0 ? age[g] : new_next;
                if (first || v < base) base = v;
                first = false;
            }
            int shift = new_next > AGE_REBASE ? base : 0;
            for (int g = 0; g < G; ++g) {
                age[g] = newcnt[g] > 0 ? age[g] - shift
                                       : (shift > 0 ? 0 : age[g]);
                cnt[g] = newcnt[g];
            }
            next_age = new_next - shift;
            pts[ch][0] = emit ? px : 0.0f;
            pts[ch][1] = emit ? py : 0.0f;
            emitted[ch] = emit;
        }
        __syncthreads();
    }

    if (tid == 0) {
        // completed hits to the event queue, in channel order
        int qc = qc_in[0];
        for (int c = 0; c < C; ++c) {
            hit_points[2 * c] = pts[c][0];
            hit_points[2 * c + 1] = pts[c][1];
            hit_emits[c] = emitted[c] ? 1 : 0;
            if (!emitted[c]) continue;
            int slot = ((qc % E) + E) % E;
            qp_out[2 * slot] = pts[c][0];
            qp_out[2 * slot + 1] = pts[c][1];
            qo_out[slot] = onset_abs[c];
            qe_out[slot] = sample;
            qc += 1;
        }
        qc_out[0] = qc;
        next_out[0] = next_age;
    }
    for (int g = tid; g < G; g += THREADS) {
        for (int k = 0; k < 3; ++k) {
            sens_out[g * 3 + k] = sens[g][k];
            ons_out[g * 3 + k] = ons[g][k];
        }
        cnt_out[g] = cnt[g];
        age_out[g] = age[g];
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// One launch per block; every output is a fresh buffer (the wrapper
// allocates them), the inputs are only read.
extern "C" int ofpt_locate_block(
    const LocDesc* hd, const uint8_t* on, const int32_t* deltas,
    const int32_t* sample_count, const int32_t* sens_in,
    const int32_t* ons_in, const int32_t* cnt_in, const int32_t* age_in,
    const int32_t* next_in, int32_t* sens_out, int32_t* ons_out,
    int32_t* cnt_out, int32_t* age_out, int32_t* next_out, const float* maps,
    const float* min_l, const float* max_l, const float* mml,
    const float* xyz, const float* qp_in, const int32_t* qo_in,
    const int32_t* qe_in, const int32_t* qc_in, float* qp_out,
    int32_t* qo_out, int32_t* qe_out, int32_t* qc_out, int32_t* hit_onsets,
    float* hit_points, uint8_t* hit_emits, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const LocDesc d = *hd;
    if (d.C > MAX_CH || d.G > MAX_SLOTS || d.T > MAX_TIERS || d.E < 1)
        return (int)cudaErrorInvalidValue;
    locate_block_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        d, on, deltas, sample_count, sens_in, ons_in, cnt_in, age_in, next_in,
        sens_out, ons_out, cnt_out, age_out, next_out, maps, min_l, max_l, mml,
        xyz, qp_in, qo_in, qe_in, qc_in, qp_out, qo_out, qe_out, qc_out,
        hit_onsets, hit_points, hit_emits);
    return (int)cudaGetLastError();
}
