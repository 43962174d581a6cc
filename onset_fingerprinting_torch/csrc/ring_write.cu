// The realtime engine's audio-ring write for Hopper, sm_90a: one block
// x [B, C] written at the ring's head, wrapping, and the ring's counter
// advanced by B, in place.
//
// Replaces no TPU kernel: the JAX engine's step writes its ring with
// onset_fingerprinting_tpu/core/ring_buffer.py:ring_write (:68), a scatter
// that XLA fuses into the block's program.  As PyTorch ops (the plain
// version, onset_fingerprinting_torch/core/ring_buffer.ring_write) it is
// six small kernels (arange, add, remainder, a cast, index_copy_, the
// counter's add): six nodes of the engine's captured step for 1.5 KB.
//
// What bounds it on the H100: nothing but the launch.  At the engine's
// shape, [128, 3] into a [1536000, 3] ring, it moves 3 KB.
//
// The design: one CTA.  Every thread reads the counter before the CTA's
// one barrier, copies its elements of the block (consecutive threads,
// consecutive addresses of the block and of the ring, but at the wrap), and
// thread 0 writes the advanced counter after the barrier.  The slot of
// frame k is torch.remainder of the int32 sum counter + k, as in the plain
// version.  B <= capacity (the wrapper checks), so no slot is written
// twice.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void __launch_bounds__(THREADS) ring_write_kernel(
    const float* __restrict__ x, float* __restrict__ ring,
    int32_t* counter, int B, int C, int cap) {
    const int head = counter[0];
    __syncthreads();  // every thread has read the counter
    const int n = B * C;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const int t = i / C;
        const int s = (int)((unsigned)head + (unsigned)t);
        int r = s % cap;
        if (r < 0) r += cap;
        ring[(size_t)r * C + (i - t * C)] = x[i];
    }
    if (threadIdx.x == 0) counter[0] = (int)((unsigned)head + (unsigned)B);
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// x [B, C] float into ring [cap, C] float at *counter (int32, on the card),
// which advances by B.  1 <= B <= cap.
extern "C" int ofpt_ring_write(const float* x, float* ring, int32_t* counter,
                               int B, int C, int cap, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    if (B < 1 || C < 1 || B > cap) return (int)cudaErrorInvalidValue;
    ring_write_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        x, ring, counter, B, C, cap);
    return (int)cudaGetLastError();
}
