// Window-major lane-slab gather (K4) for Hopper, sm_90a.
//
// Replaces onset_fingerprinting_tpu/ops/windows.py:_gather_kernel_roll (a
// per-hit [W, 128] slab DMA followed by a dynamic lane rotation): for hit i,
//
//   out[i, w, l] = x[r_i + w, tile_i * 128 + (g_i * cps + l) mod 128]
//   r_i    = clip(floor8(row_start_i), 0, T - W)
//   tile_i = sid_i / (128 / cps),  g_i = sid_i mod (128 / cps)
//
// for l in 0..7: lanes l < cps are the stream's channels, the rest the
// next streams of the same 128-lane tile, wrapping inside it (the TPU
// kernel's roll is a rotation).  An exact copy: no arithmetic on values.
//
// What bounds it on the H100: bytes.  Each hit writes W * 8 floats (8 KB at
// W = 256) and needs the same useful floats read, one 32-byte run per row;
// rows are C floats apart, so each row costs one or two 32-byte sectors
// (two where g * cps * 4 bytes is not sector-aligned).  The bound counts
// the useful 2 * N * W * 8 * 4 bytes: ~0.16 ms at 3.35 TB/s for N = 32768.
//
// What the design does about it: one CTA per hit in a grid-stride loop
// (a few waves of the card); thread t copies lane t % 8 of row t / 8, so a
// warp stores four whole contiguous 32-byte rows (fully used sectors) and
// reads four rows' 8-lane runs, each the unavoidable sector per row.  No
// shared memory: nothing is reused.
//
// ops/windows.py routes K4 here only where gather_roll_vec.cu does not take
// the shape (W * 8 / V not a multiple of 4, or x not aligned to V floats);
// measurements time the two side by side.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_roll_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ row_start,
                                   const int32_t* __restrict__ sids,
                                   float* __restrict__ out, int n, int T,
                                   int C, int cps, int W) {
    const int per_hit = W * 8;
    const int groups = 128 / cps;
    const int n_streams = C / cps;
    for (int i = blockIdx.x; i < n; i += gridDim.x) {
        // floor to 8 rows (two's complement: & ~7 rounds toward -inf),
        // then clip into [0, T - W]
        const int row = min(max(row_start[i] & ~7, 0), T - W);
        const int sid = min(max(sids[i], 0), n_streams - 1);
        const int tile = sid / groups;
        const int lane0 = (sid - tile * groups) * cps;
        const float* src = x + (size_t)row * C + (size_t)tile * 128;
        float* dst = out + (size_t)i * per_hit;
        for (int e = threadIdx.x; e < per_hit; e += blockDim.x) {
            const int w = e >> 3;
            const int l = e & 7;
            dst[e] = src[(size_t)w * C + ((lane0 + l) & 127)];
        }
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ofpt_gather_roll(const float* x, const int32_t* row_start,
                                const int32_t* sids, float* out, int n,
                                int T, int C, int cps, int W, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    if (n == 0) return 0;
    const int threads = 256;
    const int blocks = n < 132 * 64 ? n : 132 * 64;
    gather_roll_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, row_start, sids, out, n, T, C, cps, W);
    return (int)cudaGetLastError();
}
