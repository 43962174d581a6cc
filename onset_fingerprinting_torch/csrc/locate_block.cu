// The realtime engine's per-block locate step for Hopper, sm_90a: the
// block is written to the device audio ring, every channel that fired in
// it goes through the fixed-capacity locator in onset order, then the
// completed hits go to the event queue, and the engine's sample counter
// advances by the block.
//
// Replaces the ring write and the locate half of the JAX engine's
// per-block program, onset_fingerprinting_tpu/realtime/engine.py:236 (the
// ring scatter of core/ring_buffer.py:68) and :249-304 (the unrolled
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
// - The ring write (given the block `x`): every thread reads the ring's
//   counter before the first barrier and copies its elements of the block
//   to their slots (frame t at (counter mod cap + t) mod cap, as
//   core/ring_buffer.ring_write and the JAX one); thread 0 writes the
//   advanced counter after that barrier.  It moves 3 KB at the engine's
//   shape: as a launch of its own it cost the launch and a graph node
//   (~0.0017 ms on an H100), here it costs the copy.  The refinement reads the ring
//   only after that barrier, so it sees this block's rows.
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
//   (ops/locate_block.py::pack_fcnn), its depth and widths in a small
//   int32 array beside the buffer (ops/locate_block.py::FCNNPlan.header).
//   Warp 0 runs one unit per lane (units l, l + 32, ...), the layer's
//   input and output vectors in dynamic shared memory after the CC
//   refinement's buffers, sized at launch from the widest layer
//   (LocDesc::fcnn_w), one __syncwarp per layer; the
//   features are the group's two lags ("arrival") or the adjacent
//   channel-order differences of its onsets in int32 ("by_channel").  A
//   point is emitted only where the prediction (meters x 100) is finite.
//   Each unit sums bias + W[j][k] * h[k] for k in order, every product and
//   sum rounded on its own (fcnn_packed_reference emulates it on the CPU).
// - Lane g writes its slot back only where it changed, lane 0 the queue
//   entries of the block's hits, the queue counter, next_age and the
//   sample counter.
//
// CC refinement (cc_refine=True, the JAX step's refinement of each fired
// onset against the oldest candidate group's seed: locate/multilaterate.py
// :661-705, detect/refine.py:81-135, ops/xcorr.py:292-325 there) runs in
// the same launch, between the seed swap and the joins: warp 0 picks the
// candidate and the two window positions; then the whole CTA, with two
// barriers:
// - the sections, in one pass: each thread takes SEC_ROWS consecutive rows
//   of one channel of the `win_len`-sample window ending at the block,
//   read straight from the device audio ring (ring_read_last's rows, the
//   head included; SEC_ROWS + 5 rows, zero before pos0 - LOOKAROUND,
//   edge-replicated),
//   their medians of 5 and the rectified negative first difference, into
//   shared memory as double; each section's maximum by a warp reduction
//   and one atomic per warp.  Barrier.
// - the normalised CC at the 2 * ONSET_TOL lags of the tolerance window
//   only, over 200 threads: 4 lags a thread (4 independent double
//   accumulators, the section x slid through registers), the contribution
//   range cut into CC_SEGS segments, one per thread of a group of 8 lanes,
//   the segment sums combined by a fixed shuffle tree; each warp's first
//   argmax (max value, lowest index) by a shuffle reduction.  Barrier.
// - warp 0: the first argmax over the warps' candidates, the energy
//   heuristic (its weights' expf in float, their sums in double) and the
//   seed swap; only warp 0 reads the result, so no barrier ends it.
// Every product x y is exact in double (both are floats), so only the
// order of the double sums differs from a plain loop;
// ops/locate_block.py::cc_schedule_reference is this schedule on the CPU.
// The plain version's CC is an rFFT in float32, so two lags within its
// rounding of each other may pick differently: a tie, which an optional
// per-update log (`log`) lets a caller check against the plain CC.
//
// A batch of streams (ofpt_locate_streams, the sharded serve path's
// offline entry): one CTA per stream feeds that stream's onset-ordered
// events through the same update from an empty slot table, Newton only;
// each event's point (zero where not emitted) and emit flag come out.
//
// Numerics: compiled with -fmad=false, each multiply and add rounds on its
// own in the plain version's order; sqrt and division are IEEE (an
// approximate reciprocal could flip `converged` at the margin and change
// an event).  The two can differ only where the plain version's sum of
// three squares runs in another order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

#define MAX_CH 32
#define MAX_SLOTS 32
#define MAX_TIERS 4
// bytes the Shared struct may take (ops/locate_block.py::STATIC_SMEM):
// the dynamic shared memory of a launch is what is left of the opt-in
// limit
#define STATIC_SMEM 2048
#define SMEM_OPTIN 232448
// words of the FCNN's header warp 0 reads in one load, a word a lane
// (ops/locate_block.py::FCNNPlan.header pads it to as many)
#define FW_LANES 32
#define THREADS 256
#define FULL 0xffffffffu
// the CC refinement's constants (locate/multilaterate.py's ONSET_TOL,
// NORM_CUTOFF and LOOKAROUND)
#define ONSET_TOL 50
#define NORM_CUTOFF 10
#define LOOKAROUND (ONSET_TOL + NORM_CUTOFF)
// the CC's schedule: lags per thread, threads (segments of the
// contribution range, ops/locate_block.py::CC_SEGS) per lag group
#define CC_LAGS 4
#define CC_SEGS 8
#define CC_GROUPS (2 * ONSET_TOL / CC_LAGS)
// rows of a section per thread in its prep: 2 x ceil(639 / 5) = 256 items
// at the engine's 640-sample window, one per thread
#define SEC_ROWS 5
// ints per update in the refinement log: done, then sh.ref (go, seed
// channel, channel, pos0, pos1, c_seed, c_new, ok, argmax index)
#define LOG_W 10

// must match ops/locate_block.py::_LocDesc
struct LocDesc {
    int C, G, S, H, W, E, T, B;
    float radius, c_over_sr;
    float tols[MAX_TIERS];
    // the learned locator: its depth and widths travel in Tables::fw;
    // fcnn_w is its widest layer (two vectors of it in shared memory)
    int has_model, fcnn_w, act, model_input;
    // CC refinement: on, the live window's length; the ring's frames
    // (with a ring)
    int cc, win_len, ring_cap;
};

static const int AGE_INF = 2147483647;
static const int AGE_REBASE = 1 << 30;
static const int BIG = 1000000000;
// the sharded serve path's empty event key (parallel/sharding.py::_BIG)
static const int EV_BIG = 1 << 30;

// the lag maps, the geometry and the packed FCNN; fw its layers and
// widths: fw[0] = layers L, fw[1 + l] = width l for l = 0..L, zeros after
// them to at least FW_LANES words
struct Tables {
    const float *maps, *min_l, *max_l, *mml, *xyz, *fcnn;
    const int* fw;
};

// the device audio ring [cap, C] after this block's write, and the sample
// where the live window starts (not const: this launch writes the ring
// before it reads it, so its reads must not take the read-only path)
struct Ring {
    float* data;
    int count, win_start;
};

// one lane's slot of the candidate-group table (warp 0, lane g = slot g)
struct Slots {
    int s0, s1, s2, o0, o1, o2, cnt, age, next_age;
    bool act;
};

struct Shared {
    int on[MAX_CH], delta[MAX_CH], order[MAX_CH], emit[MAX_CH];
    float pts[MAX_CH][2];
    // per update: the completing groups to scan (two buffers: the next
    // update's count may be written while a warp still reads this one's)
    int nscan[2];
    int lm1[MAX_SLOTS], lm2[MAX_SLOTS];
    float lag1[MAX_SLOTS], lag2[MAX_SLOTS];
    int best[MAX_SLOTS][MAX_TIERS];
    // the CC refinement: go, seed channel, channel, pos0, pos1 in; c_seed,
    // c_new, ok, argmax index out
    int ref[9];
    int xmax[2];
    // each warp's first argmax of the CC: value, index of the window
    float cv[THREADS / 32];
    int cj[THREADS / 32];
};
static_assert(sizeof(Shared) <= STATIC_SMEM, "Shared outgrew STATIC_SMEM");

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
// computes units l, l + 32, ... of each layer; h holds the layer's input
// and output, two vectors of d.fcnn_w floats.  Returns whether the point
// (meters x 100 = cm) is finite.
__device__ bool fcnn_point(const LocDesc& d, const float* __restrict__ net,
                           const int* __restrict__ fw, float* h, int lane,
                           float f0, float f1, float* px, float* py) {
    __syncwarp();
    if (lane == 0) {
        h[0] = f0;
        h[1] = f1;
    }
    __syncwarp();
    float* cur = h;
    float* nxt = h + d.fcnn_w;
    const float* p = net;
    // the header in one load, a word a lane; a width past the lanes (a net
    // of 31 layers or more) from memory
    const int hw = fw[lane];
    const int layers = __shfl_sync(FULL, hw, 0);
    int nout = __shfl_sync(FULL, hw, 1);
    for (int l = 0; l < layers; ++l) {
        const int nin = nout;
        const int wl = __shfl_sync(FULL, hw, min(l + 2, FW_LANES - 1));
        nout = l + 2 < FW_LANES ? wl : fw[l + 2];
        const float* w = p;
        const float* b = p + nin * nout;
        const bool last = l == layers - 1;
        for (int j = lane; j < nout; j += 32) {
            float acc = b[j];
            for (int k = 0; k < nin; ++k) acc = acc + w[j * nin + k] * cur[k];
            nxt[j] = last ? acc : act(d.act, acc);
        }
        __syncwarp();
        float* t = cur;
        cur = nxt;
        nxt = t;
        p += nin * nout + nout;
    }
    *px = cur[0] * 100.0f;
    *py = cur[1] * 100.0f;
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

// the median of five (torch.sort's middle value)
__device__ __forceinline__ float median5(float a, float b, float c, float d,
                                         float e) {
    float v[5] = {a, b, c, d, e};
#pragma unroll
    for (int i = 1; i < 5; ++i)
#pragma unroll
        for (int j = i; j > 0; --j)
            if (v[j] < v[j - 1]) {
                const float t = v[j];
                v[j] = v[j - 1];
                v[j - 1] = t;
            }
    return v[2];
}

// frame r of ring_read_last(ring, W): the int32 sum count - W + r,
// torch.remainder by the capacity.  `base` is row 0's slot where no sum
// of the window wraps (then row r is base + r, less cap past the end:
// W <= cap), else -1 (a modulo per row)
__device__ __forceinline__ int window_row(const Ring& rg, int cap, int W,
                                          int base, int r) {
    if (base >= 0) return base + r < cap ? base + r : base + r - cap;
    const int s = (int)((unsigned)rg.count - (unsigned)W + (unsigned)r);
    const int row = s % cap;
    return row < 0 ? row + cap : row;
}

// x[i] where i lies in [0, n), else 0 (the sections are >= 0 and finite,
// so a zero term adds nothing to a sum)
__device__ __forceinline__ double sec_at(const double* s, int i, int n) {
    return i >= 0 && i < n ? s[i] : 0.0;
}

// (value, index) of the larger value, the lower index among equal ones
// (jnp.argmax's first maximum; -INFINITY with index INT_MAX is none)
__device__ __forceinline__ void argmax_xor(float& v, int& j, int o) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oj = __shfl_xor_sync(FULL, j, o);
    if (ov > v || (ov == v && oj < j)) {
        v = ov;
        j = oj;
    }
}

// The CC refinement of the pair in sh.ref (every thread calls it; warp 0
// set sh.xmax to 0 before the caller's barrier): the sections of both
// channels into `buf` (x [W], y [W] double), the masked normalised CC at
// the tolerance window's lags, its first argmax and the energy heuristic
// (detect/refine.py::cc_refine_adjust_jax of the port).  Warp 0 returns
// with c_seed, c_new, ok and the argmax index in sh.ref[5..8]; the other
// warps return before the heuristic.
__device__ __forceinline__ void cc_refine(const LocDesc& d, Shared& sh,
                                          double* buf, const Ring& rg) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int W = d.win_len, n = W - 1, C = d.C, cap = d.ring_cap;
    const int ch0 = sh.ref[1], ch1 = sh.ref[2];
    const int pos0 = sh.ref[3], pos1 = sh.ref[4];
    double* x = buf;      // the seed's section [n]
    double* y = buf + W;  // the new onset's [n]
    // the sections in one pass: item `it` is rows r0..r0+SEC_ROWS-1 of
    // one channel, their medians at r0..r0+SEC_ROWS from window rows
    // r0-2..r0+SEC_ROWS+2 (clamped: edge-replicated; zero before pos0 -
    // LOOKAROUND), then the rectified negative first difference
    const int nq = (n + SEC_ROWS - 1) / SEC_ROWS;
    const long long s0 = (long long)rg.count - W;  // row 0's frame, exact
    int base = -1;
    if (s0 >= INT_MIN && s0 + W - 1 <= INT_MAX) {
        base = (int)s0 % cap;  // a 32-bit modulo: s0 fits an int here
        if (base < 0) base += cap;
    }
    int mx0 = 0, mx1 = 0;  // the maxima's bits (v >= 0 orders as its bits)
    for (int it = tid; it < 2 * nq; it += THREADS) {
        const int k = it >= nq;
        const int r0 = (it - k * nq) * SEC_ROWS;
        const int ch = k ? ch1 : ch0;
        float v[SEC_ROWS + 5];
#pragma unroll
        for (int i = 0; i < SEC_ROWS + 5; ++i) {
            const int r = min(max(r0 - 2 + i, 0), W - 1);
            v[i] = r >= pos0 - LOOKAROUND
                       ? rg.data[(size_t)window_row(rg, cap, W, base, r) * C +
                                 ch]
                       : 0.0f;
        }
        float med[SEC_ROWS + 1];
#pragma unroll
        for (int j = 0; j <= SEC_ROWS; ++j)
            med[j] = median5(v[j], v[j + 1], v[j + 2], v[j + 3], v[j + 4]);
        double* sec = k ? y : x;
#pragma unroll
        for (int j = 0; j < SEC_ROWS; ++j) {
            if (r0 + j < n) {
                const float dd = med[j + 1] - med[j];
                const float o = dd >= 0.0f ? 0.0f : fabsf(dd);
                sec[r0 + j] = (double)o;
                if (k) mx1 = max(mx1, __float_as_int(o));
                else mx0 = max(mx0, __float_as_int(o));
            }
        }
    }
    mx0 = __reduce_max_sync(FULL, mx0);
    mx1 = __reduce_max_sync(FULL, mx1);
    if (lane == 0) {
        atomicMax(&sh.xmax[0], mx0);
        atomicMax(&sh.xmax[1], mx1);
    }
    __syncthreads();
    // the CC at the tolerance window's lags: window index j holds index
    // idx = lo + j of the full CC, sum_m x[m + l] y[m], l = idx - (n - 1),
    // over the contribution count.  Lane group g = warp * 4 + lane / 8
    // sums window indices 4g..4g+3 (CC_LAGS = 4: the accumulators and the
    // slide below are written out for 4); lane seg = lane % 8 the m of its
    // segment [seg S, seg S + S), S = ceil(n / 8) made odd, each lag's
    // terms in order of m
    const int cur = pos1 - pos0;
    const int center = n - cur;
    const int lo = center - ONSET_TOL;
    const int grp = warp * (32 / CC_SEGS) + lane / CC_SEGS;
    const int seg = lane % CC_SEGS;
    // odd, so the 8 segments' doubles lie in 8 different bank pairs (at
    // 80, a multiple of 16 doubles, every load was an 8-way conflict)
    const int seg_len = ((n + CC_SEGS - 1) / CC_SEGS) | 1;
    double acc[CC_LAGS] = {0.0, 0.0, 0.0, 0.0};
    if (grp < CC_GROUPS) {
        const int l0 = lo + CC_LAGS * grp - (n - 1);
        const int mb = seg * seg_len, me = min(mb + seg_len, n);
        // x[m + l0 + k], k = 0..3, slid through registers as m advances
        double x0 = sec_at(x, mb + l0, n), x1 = sec_at(x, mb + l0 + 1, n);
        double x2 = sec_at(x, mb + l0 + 2, n);
        // unrolled: the loads of later m issue before this m's products
#pragma unroll 4
        for (int m = mb; m < me; ++m) {
            const double x3 = sec_at(x, m + l0 + 3, n);
            const double ym = y[m];
            acc[0] = __fma_rn(x0, ym, acc[0]);
            acc[1] = __fma_rn(x1, ym, acc[1]);
            acc[2] = __fma_rn(x2, ym, acc[2]);
            acc[3] = __fma_rn(x3, ym, acc[3]);
            x0 = x1;
            x1 = x2;
            x2 = x3;
        }
    }
    // the segments' sums: ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))
    // at seg 0; then each lag's value, and the lane's first argmax
    float bv = -INFINITY;
    int bj = INT_MAX;
#pragma unroll
    for (int k = 0; k < CC_LAGS; ++k) {
#pragma unroll
        for (int o = CC_SEGS / 2; o; o >>= 1)
            acc[k] += __shfl_down_sync(FULL, acc[k], o, CC_SEGS);
        const int j = CC_LAGS * grp + k, idx = lo + j;
        if (seg == 0 && grp < CC_GROUPS && idx >= 0 && idx < 2 * n - 1) {
            const int ni = idx < n ? idx : 2 * n - 2 - idx;
            const float val = (float)acc[k] / (float)max(ni + 1, NORM_CUTOFF);
            if (val > bv) {  // NaN never wins, as in a loop with >
                bv = val;
                bj = j;
            }
        }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) argmax_xor(bv, bj, o);
    if (lane == 0) {
        sh.cv[warp] = bv;
        sh.cj[warp] = bj;
    }
    __syncthreads();
    if (warp != 0) return;
    bv = lane < THREADS / 32 ? sh.cv[lane] : -INFINITY;
    bj = lane < THREADS / 32 ? sh.cj[lane] : INT_MAX;
#pragma unroll
    for (int o = THREADS / 64; o; o >>= 1) argmax_xor(bv, bj, o);
    // no lag in the support: index 0 (jnp.argmax of all -inf)
    const int argf = bj == INT_MAX ? 0 : lo + bj;
    const int lag = -(argf - (center - ONSET_TOL) - (cur + ONSET_TOL));
    const bool valid = center - ONSET_TOL >= 0 &&
                       center + ONSET_TOL <= 2 * n - 1 &&
                       pos0 >= LOOKAROUND && pos1 > pos0 && pos1 < W - 1;
    // the energy heuristic: weights exp(-e k / (|ld| - 1)) descending over
    // x from min(pos0, pos0 + ld), ascending over y
    const int ld = cur - lag;
    const int nn = abs(ld);
    const float denom = (float)max(nn - 1, 1);
    const int sx = min(pos0, pos0 + ld), sy = min(pos1, pos1 - ld);
    const float ne = -2.7182817459106445f;
    double da = 0.0, db = 0.0;
    for (int k = lane; k <= ONSET_TOL; k += 32) {
        if (k < nn) {
            const float wd = expf((ne * (float)k) / denom);
            const float wa = expf((ne * (float)(nn - 1 - k)) / denom);
            da += (double)((float)x[min(max(sx + k, 0), n - 1)] * wd);
            db += (double)((float)y[min(max(sy + k, 0), n - 1)] * wa);
        }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        da += __shfl_down_sync(FULL, da, o);
        db += __shfl_down_sync(FULL, db, o);
    }
    if (lane == 0) {
        const float fa = (float)da / fmaxf(__int_as_float(sh.xmax[0]), 1e-20f);
        const float fb = (float)db / fmaxf(__int_as_float(sh.xmax[1]), 1e-20f);
        const bool move_seed = fa > fb && pos0 + ld >= 0;
        sh.ref[5] = move_seed ? ld : 0;
        sh.ref[6] = move_seed ? 0 : -ld;
        sh.ref[7] = valid;
        sh.ref[8] = argf;
    }
    __syncwarp();
}

// One update of the fixed-capacity locator with (sensor, onset), by every
// thread of the CTA (its barriers need all of them); warp 0 holds the
// slots.  `i` counts the updates of the launch.  Returns the emit flag on
// warp 0 and the point on its lane 0 (every lane with a model); writes the
// refinement's log row where `log` is given.
__device__ __forceinline__ bool locate_update(
    const LocDesc& d, Shared& sh, double* cc_buf, float* fh,
    const Tables& tb, const Ring& rg, Slots& sl, int i, int sensor,
    int onset, int* log, float* px_out, float* py_out) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int S = d.S, H = d.H, W = d.W, T = d.T;
    const int buf = i & 1;
    int cslot = 0;
    bool al = false, jn = false, comp = false;
    int gj = 0, o0g = 0, s0g = 0;
    if (tid < 32) {
        // negative-lag seed swap against the oldest group whose seed came
        // after this onset
        const bool sw = sl.act && sl.cnt > 0 && onset - sl.o0 < 0;
        const int gswap = argmin_lane(sw ? sl.age : AGE_INF);
        const bool any_swap = __any_sync(FULL, sw);
        const int old_s = __shfl_sync(FULL, sl.s0, gswap);
        const int old_o = __shfl_sync(FULL, sl.o0, gswap);
        if (any_swap) {
            if (lane == gswap) {
                sl.s0 = sensor;
                sl.o0 = onset;
            }
            sensor = old_s;
            onset = old_o;
        }
        if (d.cc) {
            // the oldest candidate: a live group this onset could join
            const int seed0 = max(sl.s0, 0);
            const float lag0 = (float)(onset - sl.o0);
            const bool member = (sl.s0 == sensor && 0 < sl.cnt) ||
                                (sl.s1 == sensor && 1 < sl.cnt) ||
                                (sl.s2 == sensor && 2 < sl.cnt);
            const bool cand = sl.act && sl.cnt > 0 && lag0 >= 0.0f &&
                              lag0 <= tb.mml[seed0] && !member;
            gj = argmin_lane(cand ? sl.age : AGE_INF);
            const bool anyc = __any_sync(FULL, cand);
            o0g = __shfl_sync(FULL, sl.o0, gj);
            s0g = max(__shfl_sync(FULL, sl.s0, gj), 0);
            if (lane == 0) {
                sh.ref[0] = anyc;
                sh.ref[1] = s0g;
                sh.ref[2] = sensor;
                sh.ref[3] = o0g - rg.win_start;
                sh.ref[4] = onset - rg.win_start;
                sh.ref[5] = sh.ref[6] = sh.ref[7] = 0;
                sh.ref[8] = -1;
                sh.xmax[0] = sh.xmax[1] = 0;
            }
        }
    }
    if (d.cc) {
        // no barrier ends the refinement: only warp 0 reads its result,
        // and the other warps read sh.ref, the sections and sh.cv/cj
        // before its second barrier, which warp 0 passes before it writes
        // them again (the next update comes after the scan's barrier)
        __syncthreads();
        if (sh.ref[0]) cc_refine(d, sh, cc_buf, rg);
        if (tid < 32) {
            if (log != nullptr && lane == 0) {
                log[0] = 1;
                for (int k = 0; k < 9; ++k) log[1 + k] = sh.ref[k];
            }
            if (sh.ref[0] && sh.ref[7]) {
                // the heuristic moved the seed or the new onset; a refined
                // onset before the seed becomes the seed
                onset += sh.ref[6];
                const int seed_onset = o0g + sh.ref[5];
                const bool neg = onset < seed_onset;
                if (lane == gj) {
                    if (neg) sl.s0 = sensor;
                    sl.o0 = neg ? onset : seed_onset;
                }
                if (neg) {
                    sensor = s0g;
                    onset = seed_onset;
                }
            }
        }
    }
    if (tid < 32) {
        const float lag = (float)(onset - sl.o0);
        const int seed = max(sl.s0, 0);
        al = sl.act && sl.cnt > 0 && lag <= tb.mml[seed];
        const bool member = (sl.s0 == sensor && 0 < sl.cnt) ||
                            (sl.s1 == sensor && 1 < sl.cnt) ||
                            (sl.s2 == sensor && 2 < sl.cnt);
        const bool legal = tb.min_l[seed * S + sensor] < lag &&
                           lag < tb.max_l[seed * S + sensor];
        jn = al && !member && legal && sl.cnt < 3;
        comp = jn && sl.cnt == 2;
        const unsigned cmask = __ballot_sync(FULL, comp);
        cslot = __popc(cmask & ((1u << lane) - 1u));
        if (comp) {
            sh.lm1[cslot] = seed * S + max(sl.s1, 0);
            sh.lm2[cslot] = seed * S + sensor;
            sh.lag1[cslot] = (float)(sl.o1 - sl.o0);
            sh.lag2[cslot] = lag;
            for (int t = 0; t < MAX_TIERS; ++t) sh.best[cslot][t] = AGE_INF;
        }
        if (lane == 0) sh.nscan[buf] = __popc(cmask);
    }
    __syncthreads();
    const int nscan = sh.nscan[buf];
    if (nscan > 0) {
        // the least column-major cell index where both lags fit, per
        // completing group and tier
        for (int k = 0; k < nscan; ++k) {
            const float* lm1 = tb.maps + (size_t)sh.lm1[k] * H * W;
            const float* lm2 = tb.maps + (size_t)sh.lm2[k] * H * W;
            const float lag1 = sh.lag1[k], lag2 = sh.lag2[k];
            for (int f = tid; f < H * W; f += THREADS) {
                const int col = f / H, row = f % H;
                const float a = lm1[row * W + col], b = lm2[row * W + col];
                for (int t = 0; t < T; ++t) {
                    const float tol = d.tols[t];
                    if (a < lag1 + tol && a > lag1 - tol &&
                        b < lag2 + tol && b > lag2 - tol)
                        atomicMin(&sh.best[k][t], f);
                }
            }
        }
        __syncthreads();
    }
    if (tid >= 32) return false;

    // the oldest feasible completer; a tier is feasible where its least
    // legal index is a cell other than (0, 0)
    int tier = -1;
    if (comp)
        for (int t = 0; t < T && tier < 0; ++t)
            if (sh.best[cslot][t] != AGE_INF && sh.best[cslot][t] != 0)
                tier = t;
    const bool feas = comp && tier >= 0;
    const int gidx = argmin_lane(feas ? sl.age : AGE_INF);
    const bool returned = __any_sync(FULL, feas);
    const int cell = __shfl_sync(FULL, feas ? sh.best[cslot][tier] : 0, gidx);
    const int seed_s = __shfl_sync(FULL, sl.s0, gidx);
    const int seed_o = __shfl_sync(FULL, sl.o0, gidx);
    const int g_s1 = __shfl_sync(FULL, sl.s1, gidx);
    const int g_o1 = __shfl_sync(FULL, sl.o1, gidx);
    const int age_g = __shfl_sync(FULL, sl.age, gidx);
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
        emit = fcnn_point(d, tb.fcnn, tb.fw, fh, lane, f0, f1, &px, &py);
    } else if (returned && lane == 0) {
        const int a0 = max(seed_s, 0), a1 = max(g_s1, 0);
        const float lag1 = (float)(g_o1 - seed_o);
        const float lag2 = (float)(onset - seed_o);
        float tri[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            tri[0][k] = tb.xyz[a0 * 3 + k];
            tri[1][k] = tb.xyz[a1 * 3 + k];
            tri[2][k] = tb.xyz[sensor * 3 + k];
        }
        px = (float)(cell / H) - d.radius;
        py = (float)(cell % H) - d.radius;
        emit = solve_tdoa(tri, lag1 * d.c_over_sr, lag2 * d.c_over_sr, &px,
                          &py);
    }
    emit = __shfl_sync(FULL, emit, 0);
    // joins (an infeasible completer keeps its third member), then the
    // drops of the completion path
    const bool same_seed = sl.s0 == seed_s && sl.o0 == seed_o;
    const bool later_or_self = sl.age >= age_g;
    int n = sl.cnt;
    if (jn) {
        const int pos = min(max(sl.cnt, 0), 2);
        if (pos == 0) { sl.s0 = sensor; sl.o0 = onset; }
        if (pos == 1) { sl.s1 = sensor; sl.o1 = onset; }
        if (pos == 2) { sl.s2 = sensor; sl.o2 = onset; }
        n += 1;
    }
    const bool keep =
        al && !(returned && later_or_self) && !(emit && same_seed);
    int newcnt = keep ? n : 0;
    if (!returned) {
        // the fresh group: a free slot, else the oldest one
        const int ins = argmin_lane(
            sl.act ? (newcnt == 0 ? sl.age - AGE_REBASE : sl.age) : AGE_INF);
        if (lane == ins) {
            sl.s0 = sensor;
            sl.s1 = -1;
            sl.s2 = -1;
            sl.o0 = onset;
            newcnt = 1;
            sl.age = sl.next_age;
        }
    }
    const int new_next = sl.next_age + 1;
    const int base = __reduce_min_sync(
        FULL, sl.act ? (newcnt > 0 ? sl.age : new_next) : AGE_INF);
    const int shift = new_next > AGE_REBASE ? base : 0;
    sl.age = newcnt > 0 ? sl.age - shift : (shift > 0 ? 0 : sl.age);
    sl.cnt = newcnt;
    sl.next_age = new_next - shift;
    *px_out = px;
    *py_out = py;
    return emit;
}

// one CTA a launch: ptxas may give each thread what it needs (at 64
// registers the refinement spilled)
__global__ void __launch_bounds__(THREADS, 1) locate_block_kernel(
    LocDesc d, const uint8_t* __restrict__ on, const int32_t* __restrict__ deltas,
    int32_t* sample_count, int32_t* sens_g, int32_t* ons_g, int32_t* cnt_g,
    int32_t* age_g, int32_t* next_g, Tables tb, float* qp, int32_t* qo,
    int32_t* qe, int32_t* qc, int32_t* hit_onsets, float* hit_points,
    uint8_t* hit_emits, const float* __restrict__ x, float* ring,
    int32_t* ring_count, int32_t* log) {
    __shared__ Shared sh;
    // [2][win_len] double with cc_refine, then [2][fcnn_w] float with a
    // model (launch_smem)
    extern __shared__ double dyn[];
    double* cc_buf = dyn;
    float* fh = reinterpret_cast<float*>(dyn + (d.cc ? 2 * d.win_len : 0));
    const int tid = threadIdx.x, lane = tid & 31;
    const int C = d.C, G = d.G, E = d.E;

    // read once, by every thread, before the first barrier: the counters
    // are written after it
    int fired = 0;
    if (tid < C) {
        fired = on[tid];
        sh.on[tid] = fired;
        sh.delta[tid] = deltas[tid];
    }
    const int sample = sample_count[0];
    Ring rg = {ring, 0, sample + d.B - d.win_len};
    if (ring_count != nullptr) rg.count = ring_count[0];
    if (x != nullptr) {
        // the ring write: frame t of the block at (head mod cap + t) mod
        // cap; the counter advances by B as an int32
        const int head = rg.count;
        int hm = head % d.ring_cap;
        if (hm < 0) hm += d.ring_cap;
        for (int i = tid; i < d.B * C; i += THREADS) {
            const int t = i / C;
            const int r = (int)(((unsigned)hm + (unsigned)t) %
                                (unsigned)d.ring_cap);
            ring[(size_t)r * C + (i - t * C)] = x[i];
        }
        rg.count = (int)((unsigned)head + (unsigned)d.B);
    }
    if (!__syncthreads_or(fired)) {
        if (tid == 0 && x != nullptr) ring_count[0] = rg.count;
        // a quiet block: the block's hits and the counter, nothing else
        if (tid < C) {
            hit_onsets[tid] = sample + sh.delta[tid];
            hit_points[2 * tid] = 0.0f;
            hit_points[2 * tid + 1] = 0.0f;
            hit_emits[tid] = 0;
        }
        if (tid == 0) sample_count[0] = sample + d.B;
        return;
    }
    if (tid == 0 && x != nullptr) ring_count[0] = rg.count;
    // the number of fired channels, in every warp (the loop below is
    // uniform across the CTA: its barriers need every thread)
    const int n_fired =
        __popc(__ballot_sync(FULL, lane < C && sh.on[lane] != 0));

    // warp 0: lane g holds slot g
    Slots sl = {-1, -1, -1, 0, 0, 0, 0, 0, 0, lane < G};
    int q0 = 0;
    if (tid < 32) {
        if (sl.act) {
            sl.s0 = sens_g[lane * 3];
            sl.s1 = sens_g[lane * 3 + 1];
            sl.s2 = sens_g[lane * 3 + 2];
            sl.o0 = ons_g[lane * 3];
            sl.o1 = ons_g[lane * 3 + 1];
            sl.o2 = ons_g[lane * 3 + 2];
            sl.cnt = cnt_g[lane];
            sl.age = age_g[lane];
        }
        sl.next_age = next_g[0];
        q0 = qc[0];
        // stable rank of where(on, deltas, BIG): the onset order
        if (lane < C) {
            const int key = sh.on[lane] ? sh.delta[lane] : BIG;
            int rank = 0;
            for (int c = 0; c < C; ++c) {
                const int kc = sh.on[c] ? sh.delta[c] : BIG;
                rank += kc < key || (kc == key && c < lane);
            }
            sh.order[rank] = lane;
            sh.emit[lane] = 0;
            sh.pts[lane][0] = sh.pts[lane][1] = 0.0f;
        }
    }
    __syncthreads();  // every warp reads the onset order below
    const Slots old = sl;

    for (int i = 0; i < n_fired; ++i) {
        const int ch = sh.order[i];
        float px, py;
        const bool emit = locate_update(
            d, sh, cc_buf, fh, tb, rg, sl, i, ch, sample + sh.delta[ch],
            log == nullptr ? nullptr : log + i * LOG_W, &px, &py);
        if (tid == 0) {
            sh.pts[ch][0] = emit ? px : 0.0f;
            sh.pts[ch][1] = emit ? py : 0.0f;
            sh.emit[ch] = emit;
        }
    }
    if (tid >= 32) return;
    __syncwarp();

    // the slots that changed
    if (sl.act) {
        if (sl.s0 != old.s0) sens_g[lane * 3] = sl.s0;
        if (sl.s1 != old.s1) sens_g[lane * 3 + 1] = sl.s1;
        if (sl.s2 != old.s2) sens_g[lane * 3 + 2] = sl.s2;
        if (sl.o0 != old.o0) ons_g[lane * 3] = sl.o0;
        if (sl.o1 != old.o1) ons_g[lane * 3 + 1] = sl.o1;
        if (sl.o2 != old.o2) ons_g[lane * 3 + 2] = sl.o2;
        if (sl.cnt != old.cnt) cnt_g[lane] = sl.cnt;
        if (sl.age != old.age) age_g[lane] = sl.age;
    }
    if (lane < C) {
        hit_onsets[lane] = sample + sh.delta[lane];
        hit_points[2 * lane] = sh.pts[lane][0];
        hit_points[2 * lane + 1] = sh.pts[lane][1];
        hit_emits[lane] = sh.emit[lane] ? 1 : 0;
    }
    if (lane == 0) {
        // completed hits to the event queue, in channel order
        int q = q0;
        for (int c = 0; c < C; ++c) {
            if (!sh.emit[c]) continue;
            const int slot = ((q % E) + E) % E;
            qp[2 * slot] = sh.pts[c][0];
            qp[2 * slot + 1] = sh.pts[c][1];
            qo[slot] = sample + sh.delta[c];
            qe[slot] = sample;
            q += 1;
        }
        if (q != q0) qc[0] = q;
        next_g[0] = sl.next_age;
        sample_count[0] = sample + d.B;
    }
}

// One CTA per stream: its onset-ordered events [E] (EV_BIG = none; the
// real ones first) from an empty slot table through the update (Newton or
// the FCNN, no refinement); each event's point (zero where not emitted)
// and emit flag.
__global__ void __launch_bounds__(THREADS) locate_streams_kernel(
    LocDesc d, int n_events, const int32_t* __restrict__ ev_on,
    const int32_t* __restrict__ ev_ch, Tables tb, float* points,
    uint8_t* emits) {
    __shared__ Shared sh;
    extern __shared__ double dyn[];  // [2][fcnn_w] float with a model
    float* fh = reinterpret_cast<float*>(dyn);
    const int tid = threadIdx.x, lane = tid & 31;
    const size_t s = blockIdx.x;
    ev_on += s * n_events;
    ev_ch += s * n_events;
    points += s * n_events * 2;
    emits += s * n_events;
    int n_valid = 0;
    while (n_valid < n_events && ev_on[n_valid] < EV_BIG) ++n_valid;
    Slots sl = {-1, -1, -1, 0, 0, 0, 0, 0, 0, lane < d.G};
    const Ring rg = {nullptr, 0, 0};
    for (int i = 0; i < n_valid; ++i) {
        float px, py;
        const bool emit = locate_update(d, sh, nullptr, fh, tb, rg, sl, i,
                                        ev_ch[i], ev_on[i], nullptr, &px,
                                        &py);
        if (tid == 0) {
            points[2 * i] = emit ? px : 0.0f;
            points[2 * i + 1] = emit ? py : 0.0f;
            emits[i] = emit;
        }
    }
    for (int i = n_valid + tid; i < n_events; i += THREADS) {
        points[2 * i] = 0.0f;
        points[2 * i + 1] = 0.0f;
        emits[i] = 0;
    }
}

// the plan's widths live on the card: the wrapper checks them
// (ops/locate_block.py::fcnn_plan) and fcnn_w is their largest
static bool desc_ok(const LocDesc& d, const float* fcnn, const int* fw) {
    if (d.C > MAX_CH || d.G < 1 || d.G > MAX_SLOTS || d.T > MAX_TIERS ||
        d.E < 1)
        return false;
    if (d.has_model && (fcnn == nullptr || fw == nullptr || d.fcnn_w < 2 ||
                        (d.model_input == 1 && d.S != 3)))
        return false;
    return true;
}

// the launch's dynamic shared memory: the refinement's two sections, then
// the FCNN's two activation vectors; 0 where it passes the opt-in limit
// (the wrapper's plan refuses such a net first)
static size_t launch_smem(const LocDesc& d) {
    size_t smem = d.cc ? (size_t)2 * d.win_len * sizeof(double) : 0;
    if (d.has_model) smem += (size_t)2 * d.fcnn_w * sizeof(float);
    return smem + STATIC_SMEM > SMEM_OPTIN ? 0 : smem;
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// One launch per block.  The locator state, the event queue and the sample
// counter are updated in place; the block's hits go to fresh outputs.
// `fcnn` is the packed learned locator and `fcnn_w` its layers and widths
// (null without one); `ring` and
// `ring_count` the device audio ring [ring_cap, C] and its frame counter
// (with cc_refine or the block), in place; `x` the block [B, C] to write
// to the ring first (null: no write); `log` [C, LOG_W] int32 the
// refinement log (or null).
extern "C" int ofpt_locate_block(
    const LocDesc* hd, const uint8_t* on, const int32_t* deltas,
    int32_t* sample_count, int32_t* sens, int32_t* ons, int32_t* cnt,
    int32_t* age, int32_t* next, const float* maps, const float* min_l,
    const float* max_l, const float* mml, const float* xyz, float* qp,
    int32_t* qo, int32_t* qe, int32_t* qc, int32_t* hit_onsets,
    float* hit_points, uint8_t* hit_emits, const float* fcnn,
    const int* fcnn_w, const float* x, float* ring, int32_t* ring_count,
    int32_t* log, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const LocDesc d = *hd;
    if (!desc_ok(d, fcnn, fcnn_w)) return (int)cudaErrorInvalidValue;
    if ((x != nullptr || d.cc) && (ring == nullptr || ring_count == nullptr))
        return (int)cudaErrorInvalidValue;
    if (x != nullptr && (d.B < 1 || d.B > d.ring_cap))
        return (int)cudaErrorInvalidValue;
    if (d.cc && (d.win_len < 8 || d.win_len > d.ring_cap))
        return (int)cudaErrorInvalidValue;
    const size_t smem = launch_smem(d);
    if (smem == 0 && (d.cc || d.has_model)) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(locate_block_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const Tables tb = {maps, min_l, max_l, mml, xyz, fcnn, fcnn_w};
    locate_block_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
        d, on, deltas, sample_count, sens, ons, cnt, age, next, tb, qp, qo,
        qe, qc, hit_onsets, hit_points, hit_emits, x, ring, ring_count,
        log);
    return (int)cudaGetLastError();
}

// One launch over a batch of streams: ev_on, ev_ch [n_streams, n_events]
// int32; points [n_streams, n_events, 2] float32 and emits
// [n_streams, n_events] uint8 out.  Newton or the FCNN (`fcnn`, `fcnn_w`
// as for ofpt_locate_block), no cc_refine.
extern "C" int ofpt_locate_streams(
    const LocDesc* hd, int n_streams, int n_events, const int32_t* ev_on,
    const int32_t* ev_ch, const float* maps, const float* min_l,
    const float* max_l, const float* mml, const float* xyz,
    const float* fcnn, const int* fcnn_w, float* points, uint8_t* emits,
    void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const LocDesc d = *hd;
    if (!desc_ok(d, fcnn, fcnn_w) || d.cc || n_streams < 1 || n_events < 0)
        return (int)cudaErrorInvalidValue;
    if (n_events == 0) return 0;
    const size_t smem = launch_smem(d);
    if (smem == 0 && d.has_model) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(locate_streams_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const Tables tb = {maps, min_l, max_l, mml, xyz, fcnn, fcnn_w};
    locate_streams_kernel<<<n_streams, THREADS, smem,
                            (cudaStream_t)stream>>>(d, n_events, ev_on,
                                                    ev_ch, tb, points, emits);
    return (int)cudaGetLastError();
}
