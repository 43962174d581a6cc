// Fused stride-1 Conv1d stack (K3) on the CUDA cores, for Hopper, sm_90a.
// It runs every float32 stack (golden mode) and the bfloat16 stacks that
// the tensor-core kernel, conv_stack_mma.cu, cannot hold in shared memory
// (ops/conv_stack.py::kernel_for); the flagship's bf16 stack takes that one.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_conv.py:_stack_kernel_unrolled
// (the serving body) and _stack_kernel (body='looped'), both reached through
// conv_stack_fused: a chain of stride-1 Conv1d layers with the same zero
// padding on every layer and bias + activation after every layer (the last
// included), [B, L] -> [B, T_out, O_last].  The flagship CCCNN stack is
// 1 -> 5 x 7 features with kernels (1, 33, 64, 15, 15, 15, 1).
//
// What bounds it on the H100: operations.  The flagship stack is ~1.24
// MFLOP per signal (163 GFLOP for the 131072 serving signals) against ~2.5
// KB of HBM traffic per signal, so every intermediate must stay on chip.
// In float32 its bound is the 67 TFLOP/s f32 FMA rate (2.4 ms): bf16 or
// TF32 tensor cores would break the golden mode's 5e-4 / 1e-4 bound.
//
// What the design does about it: a CTA holds NS signals and all layers'
// activations live in shared memory in two ping-pong buffers laid out
// [feature][time row][signal], with `pad` zero rows on both ends of every
// feature so no tap needs a bounds check.  HBM sees one read of x and one
// write of the output.  NS is the largest power of two up to 32 whose
// buffers fit (the flagship: 16 in f32; wider stacks get fewer).  A warp
// computes a chunk of output positions for all NS signals at once: its lanes are the signals times 32/NS interleaved
// position phases, so every activation load is 32 consecutive
// shared-memory elements (no bank conflict) and every weight load is a
// broadcast.  Each lane keeps 8 positions x up to 8 output features of f32
// accumulators in registers: one activation load feeds up to 8 FMAs.  The
// current layer's weights are staged in shared memory, padded to groups of
// 8 output features.
//
// Rounding points mirror the TPU kernel (pallas_conv.py:213-233, 475,
// 500-508, 535): inputs and weights in the compute dtype, f32
// accumulation, f32 bias + activation, activations stored in the compute
// dtype between layers, f32 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16

// Must match ops/conv_stack.py::_StackDesc field for field.
struct StackDesc {
    int n_layers, B, L, pad, act, bf16;
    int buf_len;   // rows per feature buffer: max activation length + 2 pad
    int max_feat;  // most features of any activation (the input's 1 incl.)
    int max_w;     // floats of the largest packed layer weight block
    int max_o8;    // most output features of a layer, rounded up to 8
    int K[MAX_LAYERS], I[MAX_LAYERS], O[MAX_LAYERS], T_out[MAX_LAYERS];
    int w_off[MAX_LAYERS], b_off[MAX_LAYERS];
};

constexpr int TT = 8;  // output positions per lane per chunk

template <typename S>
__device__ __forceinline__ float to_f32(S v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// 0 linear, 1 relu, 2 silu, 3 leaky relu (0.01), 4 elu, 5 tanh, 6 sigmoid
__device__ __forceinline__ float activate(float x, int act) {
    switch (act) {
        case 1: return x > 0.f ? x : 0.f;
        case 2: return x / (1.f + expf(-x));
        case 3: return x > 0.f ? x : 0.01f * x;
        case 4: return x > 0.f ? x : expm1f(x);
        case 5: return tanhf(x);
        case 6: return 1.f / (1.f + expf(-x));
        default: return x;
    }
}

// One warp: output positions t0 + P*j + phase (j < TT, P = 32 / NS) of OW
// output features (og*8 ...) for the lane's signal s.  NSC is NS when it is
// known at compile time (the flagship's f32 count), else 0.
template <typename S, int NSC, int OW>
__device__ void conv_unit(const S* __restrict__ cur, S* __restrict__ nxt,
                          const float* __restrict__ wsm,
                          const float* __restrict__ bsm, int og, int K, int I,
                          int T_out, int buf_len, int pad, int act, int t0,
                          int ns, int phase, int s) {
    const int NS = NSC ? NSC : ns;
    const int P = 32 / NS;
    float acc[TT][OW];
#pragma unroll
    for (int j = 0; j < TT; ++j)
#pragma unroll
        for (int o = 0; o < OW; ++o) acc[j][o] = 0.f;
    int rows[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
        const int t = t0 + P * j + phase;
        rows[j] = (t < T_out ? t : T_out - 1) * NS + s;
    }
    for (int i = 0; i < I; ++i) {
        const S* col = cur + (size_t)i * buf_len * NS;
        const float* wi = wsm + (size_t)(og * I + i) * K * 8;
        for (int k = 0; k < K; ++k) {
            float w[OW];
#pragma unroll
            for (int o = 0; o < OW; ++o) w[o] = wi[k * 8 + o];
            const S* ck = col + k * NS;
#pragma unroll
            for (int j = 0; j < TT; ++j) {
                const float v = to_f32<S>(ck[rows[j]]);
#pragma unroll
                for (int o = 0; o < OW; ++o) acc[j][o] = fmaf(w[o], v, acc[j][o]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) {
        const int t = t0 + P * j + phase;
        if (t < T_out) {
#pragma unroll
            for (int o = 0; o < OW; ++o) {
                const int f = og * 8 + o;
                const float y = activate(acc[j][o] + bsm[f], act);
                nxt[((size_t)f * buf_len + pad + t) * NS + s] = from_f32<S>(y);
            }
        }
    }
}

template <typename S, int NSC>
__global__ void conv_stack_kernel(StackDesc d, int ns,
                                  const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out) {
    const int NS = NSC ? NSC : ns;
    const int CH = (32 / NS) * TT;  // output positions per warp task
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const size_t buf_elems = (size_t)d.max_feat * d.buf_len * NS;
    S* cur = reinterpret_cast<S*>(smem_raw);
    S* nxt = cur + buf_elems;
    float* wsm = reinterpret_cast<float*>(nxt + buf_elems);
    float* bsm = wsm + d.max_w;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    const int s = lane % NS, phase = lane / NS;
    const int b0 = blockIdx.x * NS;
    const int pad = d.pad;

    for (size_t e = tid; e < 2 * buf_elems; e += blockDim.x)
        cur[e] = from_f32<S>(0.f);
    __syncthreads();
    for (int e = tid; e < NS * d.L; e += blockDim.x) {
        const int sl = e / d.L, t = e - sl * d.L;
        const int b = b0 + sl;
        const float v = b < d.B ? x[(size_t)b * d.L + t] : 0.f;
        cur[(size_t)(pad + t) * NS + sl] = from_f32<S>(v);
    }

    for (int l = 0; l < d.n_layers; ++l) {
        const int K = d.K[l], I = d.I[l], O = d.O[l], T_out = d.T_out[l];
        const int n_og = (O + 7) / 8;
        __syncthreads();  // previous layer done with wsm, cur complete
        const int nw = n_og * I * K * 8;
        for (int e = tid; e < nw; e += blockDim.x) wsm[e] = w[d.w_off[l] + e];
        for (int e = tid; e < O; e += blockDim.x) bsm[e] = bias[d.b_off[l] + e];
        __syncthreads();
        const int n_chunks = (T_out + CH - 1) / CH;
        for (int u = warp; u < n_chunks * n_og; u += n_warps) {
            const int og = u % n_og, t0 = (u / n_og) * CH;
            const int ow = min(8, O - og * 8);
#define OFPT_UNIT(N)                                                        \
    case N:                                                                 \
        conv_unit<S, NSC, N>(cur, nxt, wsm, bsm, og, K, I, T_out, d.buf_len,\
                             pad, d.act, t0, NS, phase, s);                 \
        break;
            switch (ow) {
                OFPT_UNIT(1) OFPT_UNIT(2) OFPT_UNIT(3) OFPT_UNIT(4)
                OFPT_UNIT(5) OFPT_UNIT(6) OFPT_UNIT(7) OFPT_UNIT(8)
            }
#undef OFPT_UNIT
        }
        __syncthreads();
        // rows past this layer's output may hold an earlier, longer layer's
        // activations: zero the tail pad the next layer reads
        for (int e = tid; e < O * pad * NS; e += blockDim.x) {
            const int f = e / (pad * NS), r = (e / NS) % pad, sl = e % NS;
            nxt[((size_t)f * d.buf_len + pad + T_out + r) * NS + sl] =
                from_f32<S>(0.f);
        }
        S* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    __syncthreads();
    const int last = d.n_layers - 1;
    const int O = d.O[last], T_out = d.T_out[last];
    const int per = T_out * O;
    for (int e = tid; e < NS * per; e += blockDim.x) {
        const int sl = e / per, rem = e - sl * per;
        const int b = b0 + sl;
        if (b >= d.B) continue;
        const int t = rem / O, o = rem - t * O;
        out[(size_t)b * per + rem] =
            to_f32<S>(cur[((size_t)o * d.buf_len + pad + t) * NS + sl]);
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

template <typename S, int NSC>
static int launch_ns(const StackDesc& d, int ns, size_t smem, const float* x,
                     const float* w, const float* b, float* out,
                     cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_stack_kernel<S, NSC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (d.B + ns - 1) / ns;
    conv_stack_kernel<S, NSC><<<blocks, 256, smem, stream>>>(d, ns, x, w, b,
                                                             out);
    return (int)cudaGetLastError();
}

// FAST_NS: the signals per CTA that the flagship stack gets in this storage
// type, compiled with NS constant (runtime NS costs ~8% in bf16); 0 for
// none.
template <typename S, int FAST_NS>
static int launch(const StackDesc& d, const float* x, const float* w,
                  const float* b, float* out, cudaStream_t stream) {
    const size_t fixed = ((size_t)d.max_w + d.max_o8) * sizeof(float);
    const size_t per_signal = 2 * (size_t)d.max_feat * d.buf_len * sizeof(S);
    int ns = 32;  // signals per CTA: the most whose buffers fit
    while (ns > 1 && fixed + per_signal * ns > 232448) ns /= 2;
    const size_t smem = fixed + per_signal * ns;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (ns == FAST_NS)
        return launch_ns<S, FAST_NS>(d, ns, smem, x, w, b, out, stream);
    return launch_ns<S, 0>(d, ns, smem, x, w, b, out, stream);
}

extern "C" int ofpt_conv_stack(const StackDesc* hd, const float* x,
                               const float* w, const float* b, float* out,
                               void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const StackDesc d = *hd;
    if (d.n_layers < 1 || d.n_layers > MAX_LAYERS)
        return (int)cudaErrorInvalidValue;
    if (d.B == 0) return 0;
    if (d.bf16)
        return launch<__nv_bfloat16, 0>(d, x, w, b, out, (cudaStream_t)stream);
    return launch<float, 16>(d, x, w, b, out, (cudaStream_t)stream);
}
