// Window-major lane-slab gather (K4) for Hopper, sm_90a, as row-vector
// copies: the kernel ops/windows.py routes K4 to wherever it takes the
// shape.
//
// Replaces onset_fingerprinting_tpu/ops/windows.py:_gather_kernel_roll (a
// per-hit [W, 128] slab DMA followed by a dynamic lane rotation): for hit i,
//
//   out[i, w, l] = x[r_i + w, tile_i * 128 + (g_i * cps + l) mod 128]
//   r_i    = clip(floor8(row_start_i), 0, T - W)
//   tile_i = sid_i / (128 / cps),  g_i = sid_i mod (128 / cps)
//
// for l in 0..7: lanes l < cps are the stream's channels, the rest the
// next streams of the same 128-lane tile, wrapping inside it.  An exact
// copy: no arithmetic on values.
//
// What bounds it on the H100: isolated sector reads, as for K2
// (gather_vec.cu).  A hit writes W * 8 floats (8 KB at W = 256) and reads
// one 32-byte run per row; rows are C floats apart, so every row costs one
// or two 32-byte sectors of its own.  On random hits 0.398 ms against
// gather_roll.cu's 0.405 (useful-bytes bound 0.158, sector floor 0.195;
// an H100 SXM at 700 W, PERF.md): the card's rate for such reads, not the
// kernel, sets it.
//
// What the design does about it: lane0 = g * cps is a multiple of
// V = min(cps, 4), and so is 128, so a row's 8 lanes are 8 / V vectors of
// V floats that never straddle the rotation's wrap: at cps >= 4 two
// 16-byte loads per row, at (lane0 + 0) and (lane0 + 4) mod 128.  The
// hit's [W, 8] output is W * 8 / V vectors in order; a thread takes ROWS = 4
// of them, a stride of (threads per hit) apart, issues its 4 loads
// together, then its 4 stores.  Consecutive threads take consecutive
// vectors, so a warp stores 512 contiguous bytes per instruction and reads
// 16 rows' 32-byte runs.  A CTA per 256 threads, no grid-stride loop: the
// card starts CTAs in order, so the hits in flight are neighbours in the
// list, which on the anatomy's list share rows and sectors: 0.147 ms
// against gather_roll.cu's 0.198, and 0.203 with a persistent grid.  ops/windows.py::roll_kernel_for says which shapes take this
// kernel (the rest runs on gather_roll.cu), and roll_vec_addresses spells
// out its addressing for the CPU tests.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int ROWS = 4;  // vectors per thread, issued together
constexpr int THREADS = 256;

template <int V>
struct Vec;
template <>
struct Vec<1> {
    using T = float;
};
template <>
struct Vec<2> {
    using T = float2;
};
template <>
struct Vec<4> {
    using T = float4;
};

template <int V>
__global__ void __launch_bounds__(THREADS)
    gather_roll_vec_kernel(const float* __restrict__ x,
                           const int32_t* __restrict__ row_start,
                           const int32_t* __restrict__ sids,
                           float* __restrict__ out, int n, int T, int C,
                           int cps, int W) {
    constexpr int LPR = 8 / V;  // vectors per output row
    using VT = typename Vec<V>::T;
    const int per_hit = W * LPR / ROWS;  // threads per hit
    const int groups = 128 / cps;
    const int n_streams = C / cps;
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e < n * per_hit) {
        const int i = e / per_hit;
        const int t = e - i * per_hit;
        // floor to 8 rows (two's complement: & ~7 rounds toward -inf),
        // then clip into [0, T - W]
        const int row = min(max(row_start[i] & ~7, 0), T - W);
        const int sid = min(max(sids[i], 0), n_streams - 1);
        const int tile = sid / groups;
        const int lane0 = (sid - tile * groups) * cps;
        const float* src = x + (size_t)row * C + (size_t)tile * 128;
        VT v[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int p = t + k * per_hit;
            const int w = p / LPR;
            const int s = p % LPR;
            v[k] = __ldg(reinterpret_cast<const VT*>(
                src + (size_t)w * C + ((lane0 + s * V) & 127)));
        }
        VT* dst = reinterpret_cast<VT*>(out + (size_t)i * W * 8);
#pragma unroll
        for (int k = 0; k < ROWS; ++k) dst[t + k * per_hit] = v[k];
    }
}

template <int V>
static cudaError_t launch(const float* x, const int32_t* row_start,
                          const int32_t* sids, float* out, int n, int T,
                          int C, int cps, int W, cudaStream_t st) {
    const long long items = (long long)n * (W * (8 / V) / ROWS);
    gather_roll_vec_kernel<V><<<(int)((items + THREADS - 1) / THREADS),
                                THREADS, 0, st>>>(x, row_start, sids, out, n,
                                                  T, C, cps, W);
    return cudaGetLastError();
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The wrapper routes here only what roll_routes accepts: the wide layout
// (C % 128 == 0, 128 % cps == 0), W * 8 / V a multiple of ROWS, x 4 * V-byte
// aligned, n * W * 8 / V / ROWS < 2^30 (the item index stays inside an
// int).
extern "C" int ofpt_gather_roll_vec(const float* x, const int32_t* row_start,
                                    const int32_t* sids, float* out, int n,
                                    int T, int C, int cps, int W,
                                    void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const int V = cps < 4 ? cps : 4;
    if (C % 128 || cps <= 0 || 128 % cps || (W * (8 / V)) % ROWS ||
        (long long)n * (W * (8 / V) / ROWS) >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (V) {
        case 1:
            return (int)launch<1>(x, row_start, sids, out, n, T, C, cps, W,
                                  st);
        case 2:
            return (int)launch<2>(x, row_start, sids, out, n, T, C, cps, W,
                                  st);
        default:
            return (int)launch<4>(x, row_start, sids, out, n, T, C, cps, W,
                                  st);
    }
}
