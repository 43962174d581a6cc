// Onset-window gather (K2) for Hopper, sm_90a.
//
// Replaces onset_fingerprinting_tpu/ops/windows.py:_gather_kernel_mh_anchored
// (anchored=1) and its block-aligned siblings _gather_kernel_mh and
// _gather_kernel (anchored=0): for hit i,
//
//   out[i, c, w] = x[row_i + w, sid_i * cps + c]
//   row_i = clip(start_i - pre, 0, T - W - 8)            (anchored)
//   row_i = floor8(clip(start_i - pre, 0, T - W))         (block-aligned)
//
// an exact copy (the TPU kernels select lanes with a one-hot matmul; here
// there is no arithmetic at all).
//
// What bounds it on the H100: bytes.  Each hit needs cps * W useful floats
// (4 KB at the serving width) read and the same written; a window's rows
// are C floats apart, so each row costs one 32-byte sector of which cps * 4
// bytes are used (the floor is ~0.28 GB of sectors in and 0.13 GB out per
// 32768 hits, ~0.1 ms at 3.35 TB/s).
//
// What the design does about it: consecutive threads take consecutive
// channels of one row, then consecutive rows (w = e / cps, c = e % cps), so
// a warp reads 32 / cps whole sectors and writes cps runs of 32 / cps
// contiguous floats -- every sector touched is either fully used (stores)
// or the unavoidable partial row (loads).  A grid-stride loop over hits
// keeps the grid at a few waves of the card.
//
// ops/windows.py routes K2 here only where gather_vec.cu does not take the
// shape (a cps outside 1, 2, 4, 8, W % 4 != 0, or x not aligned to the
// vector width); measurements time the two side by side.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_kernel(const float* __restrict__ x,
                              const int32_t* __restrict__ starts,
                              const int32_t* __restrict__ sids,
                              float* __restrict__ out, int n, int T, int C,
                              int cps, int W, int pre, int anchored) {
    const int per_hit = cps * W;
    const int n_streams = C / cps;
    for (int i = blockIdx.x; i < n; i += gridDim.x) {
        const int s = starts[i] - pre;
        int row;
        if (anchored) {
            row = min(max(s, 0), T - W - 8);
        } else {
            row = min(max(s, 0), T - W);
            row = (row / 8) * 8;
        }
        const int sid = min(max(sids[i], 0), n_streams - 1);
        const float* src = x + (size_t)row * C + (size_t)sid * cps;
        float* dst = out + (size_t)i * per_hit;
        for (int e = threadIdx.x; e < per_hit; e += blockDim.x) {
            const int w = e / cps;
            const int c = e - w * cps;
            dst[(size_t)c * W + w] = src[(size_t)w * C + c];
        }
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ofpt_gather(const float* x, const int32_t* starts,
                           const int32_t* sids, float* out, int n, int T,
                           int C, int cps, int W, int pre, int anchored,
                           void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    if (n == 0) return 0;
    const int threads = 256;
    const int blocks = n < 132 * 64 ? n : 132 * 64;
    gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, starts, sids, out, n, T, C, cps, W, pre, anchored);
    return (int)cudaGetLastError();
}
