// Onset-window gather (K2) for Hopper, sm_90a, as row-vector copies: the
// kernel ops/windows.py routes K2 to wherever it takes the shape.
//
// Replaces onset_fingerprinting_tpu/ops/windows.py:_gather_kernel_mh_anchored
// (anchored=1) and its block-aligned siblings _gather_kernel_mh and
// _gather_kernel (anchored=0): for hit i,
//
//   out[i, c, w] = x[row_i + w, sid_i * cps + c]
//   row_i = clip(start_i - pre, 0, T - W - 8)            (anchored)
//   row_i = floor8(clip(start_i - pre, 0, T - W))         (block-aligned)
//
// an exact copy: no arithmetic on values.
//
// What bounds it on the H100: isolated sector reads.  A window row is
// cps * 4 bytes (16 at the serving width) and rows are C floats apart, so
// every row is its own 32-byte sector.  On independent (random) hits the
// card's rate for such reads sets the time, not the kernel: gather.cu (one
// 4-byte load per thread), this kernel and a TMA tile-copy design all took
// 0.324 ms for 32768 hits at C = 32768 (useful-bytes bound 0.080 ms,
// sector floor 0.118), and 0.149 ms even with x resident in L2 (an H100
// SXM at 700 W, PERF.md).
// Where hits share rows and sectors, as on the fleet path's list (every
// stream's hits in the same rows, neighbouring streams in one sector), the
// order of the reads decides how many meet in L2 and in open DRAM pages.
//
// What the design does about it: a thread copies ROWS = 4 consecutive rows
// of one hit.  cps is a template constant, so its 4 * cps / V loads of V
// floats (V = 4 when cps % 4 == 0: one 16-byte load per row at cps = 4)
// are a fixed count, issued together before any store.  The transpose to
// [cps, W] happens in registers: each channel's 4 values go out as one
// 16-byte store, and a warp writes 512 contiguous bytes per channel.  One
// thread per (hit, row quad) item, one division per item, and a CTA per
// 256 items with no grid-stride loop: the card starts CTAs in order, so
// the hits in flight are neighbours in the list.  On the fleet path's
// list that is 0.103 ms against gather.cu's 0.129; a persistent grid,
// whose CTAs drift apart along the list, took 0.114.
// ops/windows.py::gather_kernel_for says which cps, W and base alignment
// take this kernel (the rest runs on gather.cu), and gather_vec_addresses
// spells out its addressing for the CPU tests.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int ROWS = 4;  // rows per thread (a multiple of 4: 16-byte stores)
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

__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(float2 v, int k) {
    return k ? v.y : v.x;
}
__device__ __forceinline__ float elem(float4 v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int CPS>
__global__ void __launch_bounds__(THREADS)
    gather_vec_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ sids,
                      float* __restrict__ out, int n, int T, int C, int W,
                      int pre, int anchored) {
    constexpr int V = CPS % 4 == 0 ? 4 : CPS % 2 == 0 ? 2 : 1;
    constexpr int NV = CPS / V;  // vector loads per row
    using VT = typename Vec<V>::T;
    const int quads = W / ROWS;  // threads per hit
    const int n_streams = C / CPS;
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e < n * quads) {
        const int i = e / quads;
        const int q = e - i * quads;
        const int s = starts[i] - pre;
        int row;
        if (anchored) {
            row = min(max(s, 0), T - W - 8);
        } else {
            row = min(max(s, 0), T - W);
            row = (row / 8) * 8;
        }
        const int sid = min(max(sids[i], 0), n_streams - 1);
        const float* src =
            x + (size_t)(row + q * ROWS) * C + (size_t)sid * CPS;
        VT v[ROWS][NV];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int j = 0; j < NV; ++j)
                v[r][j] = __ldg(
                    reinterpret_cast<const VT*>(src + (size_t)r * C + j * V));
        float* dst = out + (size_t)i * CPS * W + q * ROWS;
#pragma unroll
        for (int c = 0; c < CPS; ++c)
#pragma unroll
            for (int h = 0; h < ROWS; h += 4) {
                float4 o;
                o.x = elem(v[h + 0][c / V], c % V);
                o.y = elem(v[h + 1][c / V], c % V);
                o.z = elem(v[h + 2][c / V], c % V);
                o.w = elem(v[h + 3][c / V], c % V);
                *reinterpret_cast<float4*>(dst + (size_t)c * W + h) = o;
            }
    }
}

template <int CPS>
static cudaError_t launch(const float* x, const int32_t* starts,
                          const int32_t* sids, float* out, int n, int T,
                          int C, int W, int pre, int anchored,
                          cudaStream_t st) {
    const long long items = (long long)n * (W / ROWS);
    gather_vec_kernel<CPS><<<(int)((items + THREADS - 1) / THREADS), THREADS,
                             0, st>>>(x, starts, sids, out, n, T, C, W, pre,
                                      anchored);
    return cudaGetLastError();
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The wrapper routes here only what gather_routes accepts: cps in {1, 2, 4,
// 8}, W % 4 == 0, x 4 * V-byte aligned, n * W / 4 < 2^30 (the item index
// stays inside an int).
extern "C" int ofpt_gather_vec(const float* x, const int32_t* starts,
                               const int32_t* sids, float* out, int n, int T,
                               int C, int cps, int W, int pre, int anchored,
                               void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    if (W % ROWS || (long long)n * (W / ROWS) >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (cps) {
        case 1:
            return (int)launch<1>(x, starts, sids, out, n, T, C, W, pre,
                                  anchored, st);
        case 2:
            return (int)launch<2>(x, starts, sids, out, n, T, C, W, pre,
                                  anchored, st);
        case 4:
            return (int)launch<4>(x, starts, sids, out, n, T, C, W, pre,
                                  anchored, st);
        case 8:
            return (int)launch<8>(x, starts, sids, out, n, T, C, W, pre,
                                  anchored, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
