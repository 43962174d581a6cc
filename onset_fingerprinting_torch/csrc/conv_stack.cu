// Fused stride-1 Conv1d stack (K3) on the CUDA cores, for Hopper, sm_90a.
// It runs every float32 stack and the bfloat16 stacks that the
// tensor-core kernel, conv_stack_mma.cu, has no plan for
// (ops/conv_stack.py::kernel_for); the flagship's bf16 stack takes that one.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_conv.py:_stack_kernel_unrolled
// (:187, the serving body) and _stack_kernel (:249, body='looped'), both
// launched at :523 by conv_stack_fused, where a float32 stack takes the
// three-pass Precision.HIGHEST band products (:500-508): a chain of stride-1
// Conv1d layers with the same zero padding on every layer and bias +
// activation after every layer (the last included), [B, L] ->
// [B, T_out, O_last].  The flagship CCCNN stack is 1 -> 5 x 7 features
// with kernels (1, 33, 64, 15, 15, 15, 1).
//
// What bounds it on the H100: operations.  The flagship stack is ~1.24
// MFLOP per signal (163 GFLOP for the 131072 serving signals) against ~2.5
// KB of HBM traffic per signal, so every intermediate stays on chip.  In
// float32 its bound is the 67 TFLOP/s f32 FMA rate (2.4 ms).  One bf16 or
// TF32 tensor-core pass would break float32's 5e-4 / 1e-4 bar; a
// split-precision product (three TF32 passes, as the TPU's HIGHEST takes)
// would not, but issues three products per band at half the bf16 rate on
// a band 1.9x the useful work, which puts it behind the FMA units here.
//
// What the design does about it (ops/conv_stack.py::simt_plan is the
// schedule, written in Python so the CPU tests check it):
//
// - One warp per signal, ns signals (warps) per CTA.  A warp keeps its
//   signal's activations in two ping-pong buffers [feature][row] in shared
//   memory, with `pad` zero rows at both ends of every feature, so no tap
//   needs a bounds check, and never waits for another warp inside a layer:
//   the layer's only barrier is the CTA's one __syncthreads that hands over
//   the staged weights.  HBM sees one read of x and one write of the output.
// - A lane task is TT consecutive output positions of one group of OW
//   output features (TT in {5, 6, 8}, chosen per layer by the plan so the
//   layer's tasks fill the warp's lanes; OW <= 8).  Along the taps the
//   lane slides a register window: a block of TT taps needs 2 TT - 1 rows,
//   of which TT are already in registers, so each (input feature, tap)
//   costs one activation load from shared memory, one or two 16-byte
//   broadcast weight loads and TT x OW FMAs into register accumulators.
// - Lanes read rows TT apart.  Row r of a feature lies at r + r / 32 (one
//   spare word per 32 rows), so the lanes of a warp meet at most two to a
//   bank for any TT (without it an even TT sends up to eight lanes to one).
// - Occupancy: at most 128 registers a thread (__launch_bounds__), and the
//   plan's ns (the flagship: 8 signals, 110144 bytes) lets two CTAs share an SM,
//   16 resident warps.  A layer's packed weights are staged into one of two
//   alternating buffers while the previous layer computes.
//
// Rounding points mirror the TPU kernel (pallas_conv.py:213-233, 475,
// 500-508, 535): inputs and weights in the compute dtype, f32
// accumulation, f32 bias + activation, activations stored in the compute
// dtype between layers, f32 output.  The activations use the fast exp and
// division intrinsics (a few ulps, far inside the bar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16

// Must match ops/conv_stack.py::_StackDesc field for field.
struct StackDesc {
    int n_layers, B, L, pad, act, bf16;
    int ns;        // signals (warps) per CTA
    int pitch;     // elements of one feature's buffer (skewed rows)
    int max_feat;  // most features of any activation (the input's 1 incl.)
    int w_max;     // floats of the largest layer's packed block
    int K[MAX_LAYERS], I[MAX_LAYERS], O[MAX_LAYERS], T_out[MAX_LAYERS];
    int TT[MAX_LAYERS], OW[MAX_LAYERS], n_og[MAX_LAYERS];
    int w_off[MAX_LAYERS], w_len[MAX_LAYERS];
};

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

// 0 linear, 1 relu, 2 silu, 3 leaky relu (0.01), 4 elu, 5 tanh, 6 sigmoid;
// exp and division by the fast intrinsics (absolute error ~1e-7 at the
// activations' scale)
template <int ACT>
__device__ __forceinline__ float activate(float x) {
    if (ACT == 1) return x > 0.f ? x : 0.f;
    if (ACT == 2) return __fdividef(x, 1.f + __expf(-x));
    if (ACT == 3) return x > 0.f ? x : 0.01f * x;
    if (ACT == 4) return x > 0.f ? x : __expf(x) - 1.f;
    if (ACT == 5) return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
    if (ACT == 6) return __fdividef(1.f, 1.f + __expf(-x));
    return x;
}

// acc = act(acc + bias) for a whole task: one branch on the activation per
// task, not one per value.
template <int TT, int OW, int ACT>
__device__ __forceinline__ void activate_all(float (&acc)[TT][OW],
                                             const float (&bo)[OW]) {
#pragma unroll
    for (int j = 0; j < TT; ++j)
#pragma unroll
        for (int o = 0; o < OW; ++o) acc[j][o] = activate<ACT>(acc[j][o] + bo[o]);
}

template <int TT, int OW>
__device__ __forceinline__ void activate_all(float (&acc)[TT][OW],
                                             const float (&bo)[OW], int act) {
    switch (act) {
        case 1: activate_all<TT, OW, 1>(acc, bo); break;
        case 2: activate_all<TT, OW, 2>(acc, bo); break;
        case 3: activate_all<TT, OW, 3>(acc, bo); break;
        case 4: activate_all<TT, OW, 4>(acc, bo); break;
        case 5: activate_all<TT, OW, 5>(acc, bo); break;
        case 6: activate_all<TT, OW, 6>(acc, bo); break;
        default: activate_all<TT, OW, 0>(acc, bo);
    }
}

// Buffer row r of a feature (ops/conv_stack.py::skew).
__device__ __forceinline__ int skew(int r) { return r + (r >> 5); }

template <typename S>
__device__ __forceinline__ float row(const S* col, int r) {
    return to_f32<S>(col[skew(r)]);
}

// The OW weights of one tap (OWP = 4 or 8 floats, 16-byte aligned, the same
// address for every lane of the group: a broadcast).
template <int OW>
__device__ __forceinline__ void tap_weights(const float* p, float (&w)[OW]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    float v[8] = {a.x, a.y, a.z, a.w, 0.f, 0.f, 0.f, 0.f};
    if (OW > 4) {
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
#pragma unroll
    for (int o = 0; o < OW; ++o) w[o] = v[o];
}

// One warp's share of a layer for its signal: lane tasks u = lane, lane +
// 32, ... of n_chunks * n_og; task u is feature group g = u / n_chunks at
// output positions t0 .. t0 + TT - 1, t0 = (u % n_chunks) * TT.  Output
// position t reads input rows t .. t + K - 1 (a row is a position + pad).
template <typename S, int TT, int OW>
__device__ __forceinline__ void layer_tasks(const S* __restrict__ cur, S* __restrict__ nxt,
                            const float* __restrict__ wl, int I, int K, int O,
                            int T_out, int n_og, int pitch, int pad, int act,
                            int lane) {
    constexpr int OWP = OW > 4 ? 8 : 4;
    const int n_chunks = (T_out + TT - 1) / TT;
    const float* bias = wl + n_og * I * K * OWP;
    for (int u = lane; u < n_chunks * n_og; u += 32) {
        const int g = u / n_chunks;
        const int t0 = (u - g * n_chunks) * TT;
        float acc[TT][OW];
#pragma unroll
        for (int j = 0; j < TT; ++j)
#pragma unroll
            for (int o = 0; o < OW; ++o) acc[j][o] = 0.f;
        for (int i = 0; i < I; ++i) {
            const S* col = cur + (size_t)i * pitch;
            const float* wi = wl + (size_t)(g * I + i) * K * OWP;
            // a[m]: row t0 + k + m, the window of tap k; w: tap k's
            // weights, the next tap's loaded one tap ahead (past the last
            // tap lie the next feature's or the biases: in the block)
            float a[TT], w[OW];
#pragma unroll
            for (int m = 0; m < TT; ++m) a[m] = row(col, t0 + m);
            tap_weights<OW>(wi, w);
            int k = 0;
            for (; k + TT <= K; k += TT) {
                float b[TT];  // the next TT rows
#pragma unroll
                for (int m = 0; m < TT; ++m) b[m] = row(col, t0 + k + TT + m);
#pragma unroll
                for (int kk = 0; kk < TT; ++kk) {
                    float wn[OW];
                    tap_weights<OW>(wi + (k + kk + 1) * OWP, wn);
#pragma unroll
                    for (int j = 0; j < TT; ++j) {
                        const float v = j + kk < TT ? a[j + kk] : b[j + kk - TT];
#pragma unroll
                        for (int o = 0; o < OW; ++o)
                            acc[j][o] = fmaf(w[o], v, acc[j][o]);
                    }
#pragma unroll
                    for (int o = 0; o < OW; ++o) w[o] = wn[o];
                }
#pragma unroll
                for (int m = 0; m < TT; ++m) a[m] = b[m];
            }
            for (; k < K; ++k) {  // the last K % TT taps, one at a time
                float wn[OW];
                tap_weights<OW>(wi + (k + 1) * OWP, wn);
                const float an = row(col, t0 + k + TT);
#pragma unroll
                for (int j = 0; j < TT; ++j)
#pragma unroll
                    for (int o = 0; o < OW; ++o)
                        acc[j][o] = fmaf(w[o], a[j], acc[j][o]);
#pragma unroll
                for (int m = 0; m < TT - 1; ++m) a[m] = a[m + 1];
                a[TT - 1] = an;
#pragma unroll
                for (int o = 0; o < OW; ++o) w[o] = wn[o];
            }
        }
        float bo[OW];
#pragma unroll
        for (int o = 0; o < OW; ++o) bo[o] = bias[g * OWP + o];
        activate_all<TT, OW>(acc, bo, act);
        S* dst = nxt + (size_t)g * OW * pitch;
        if (t0 + TT <= T_out && (g + 1) * OW <= O) {  // a whole task
#pragma unroll
            for (int j = 0; j < TT; ++j) {
                const int r = skew(pad + t0 + j);
#pragma unroll
                for (int o = 0; o < OW; ++o)
                    dst[(size_t)o * pitch + r] = from_f32<S>(acc[j][o]);
            }
        } else {
#pragma unroll
            for (int j = 0; j < TT; ++j) {
                const int r = skew(pad + t0 + j);
#pragma unroll
                for (int o = 0; o < OW; ++o)
                    if (t0 + j < T_out && g * OW + o < O)
                        dst[(size_t)o * pitch + r] = from_f32<S>(acc[j][o]);
            }
        }
    }
}

template <typename S>
__device__ __forceinline__ void run_layer(const StackDesc& d, int l,
                                          const S* cur, S* nxt,
                                          const float* wl, int lane) {
    const int I = d.I[l], K = d.K[l], O = d.O[l], T = d.T_out[l];
    const int n_og = d.n_og[l], pitch = d.pitch, pad = d.pad, act = d.act;
#define OFPT_CASE(TT_, OW_)                                                 \
    case TT_ * 16 + OW_:                                                    \
        layer_tasks<S, TT_, OW_>(cur, nxt, wl, I, K, O, T, n_og, pitch, pad,\
                                 act, lane);                                \
        break;
#define OFPT_TT(TT_)                                                        \
    OFPT_CASE(TT_, 1) OFPT_CASE(TT_, 2) OFPT_CASE(TT_, 3) OFPT_CASE(TT_, 4) \
    OFPT_CASE(TT_, 5) OFPT_CASE(TT_, 6) OFPT_CASE(TT_, 7) OFPT_CASE(TT_, 8)
    switch (d.TT[l] * 16 + d.OW[l]) {
        OFPT_TT(5) OFPT_TT(6) OFPT_TT(8)
    }
#undef OFPT_TT
#undef OFPT_CASE
}

// Copy layer l's packed block (weights, then biases) into shared memory,
// 16 bytes a thread (blocks start and end on multiples of 4 floats).
__device__ __forceinline__ void stage(const StackDesc& d, int l,
                                      const float* __restrict__ w,
                                      float* dst) {
    const float4* src = reinterpret_cast<const float4*>(w + d.w_off[l]);
    float4* out = reinterpret_cast<float4*>(dst);
    for (int e = threadIdx.x; e < d.w_len[l] / 4; e += blockDim.x)
        out[e] = src[e];
}

template <typename S>
__global__ void __launch_bounds__(512, 1)
    conv_stack_kernel(StackDesc d, const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* wbuf = reinterpret_cast<float*>(smem_raw);  // [2][w_max]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t feat_elems = (size_t)d.max_feat * d.pitch;
    S* cur = reinterpret_cast<S*>(wbuf + 2 * d.w_max) + warp * 2 * feat_elems;
    S* nxt = cur + feat_elems;
    const int b = blockIdx.x * d.ns + warp;
    const bool live = b < d.B;
    const int pad = d.pad;

    // zeros where a kept output reads them: every feature's leading pad
    // rows in both buffers and the input's tail pad (each layer zeroes its
    // output's); other rows are written before they are read, or feed only
    // positions past a layer's T_out, which are never stored
    for (int e = lane; e < 2 * d.max_feat * pad; e += 32) {
        const int f = e / pad, r = e - f * pad;
        cur[(size_t)f * d.pitch + skew(r)] = from_f32<S>(0.f);
    }
    for (int r = lane; r < pad; r += 32)
        cur[skew(pad + d.L + r)] = from_f32<S>(0.f);
    __syncwarp();
    if (live)
        for (int t = lane; t < d.L; t += 32)
            cur[skew(pad + t)] = from_f32<S>(x[(size_t)b * d.L + t]);
    stage(d, 0, w, wbuf);
    __syncthreads();

    for (int l = 0; l < d.n_layers; ++l) {
        const float* wl = wbuf + (l & 1) * d.w_max;
        // the other buffer was last read by layer l - 1, which every warp
        // finished before the barrier that ended it
        if (l + 1 < d.n_layers) stage(d, l + 1, w, wbuf + ((l + 1) & 1) * d.w_max);
        if (live) {
            __syncwarp();
            run_layer<S>(d, l, cur, nxt, wl, lane);
            __syncwarp();
            // rows past this layer's output may hold an earlier, longer
            // layer's activations: zero the tail pad the next layer reads
            const int O = d.O[l], T = d.T_out[l];
            for (int e = lane; e < O * pad; e += 32) {
                const int f = e / pad, r = e - f * pad;
                nxt[(size_t)f * d.pitch + skew(pad + T + r)] = from_f32<S>(0.f);
            }
        }
        S* tmp = cur;
        cur = nxt;
        nxt = tmp;
        __syncthreads();
    }
    if (!live) return;
    const int last = d.n_layers - 1;
    const int O = d.O[last], T = d.T_out[last];
    const int per = T * O;
    for (int e = lane; e < per; e += 32) {
        const int t = e / O, o = e - t * O;
        out[(size_t)b * per + e] =
            to_f32<S>(cur[(size_t)o * d.pitch + skew(pad + t)]);
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

template <typename S>
static int launch(const StackDesc& d, const float* x, const float* w,
                  float* out, cudaStream_t stream, int* ctas_per_sm) {
    const size_t smem = 2 * (size_t)d.w_max * sizeof(float) +
                        (size_t)d.ns * 2 * d.max_feat * d.pitch * sizeof(S);
    if (smem > 232448 || d.ns < 1 || d.ns > 16)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        conv_stack_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    // the largest shared-memory carveout, so the plan's CTAs fit an SM
    e = cudaFuncSetAttribute(conv_stack_kernel<S>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
    if (e != cudaSuccess) return (int)e;
    if (ctas_per_sm) {  // asked for the residency, not a launch
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            ctas_per_sm, conv_stack_kernel<S>, 32 * d.ns, smem);
    }
    const int blocks = (d.B + d.ns - 1) / d.ns;
    conv_stack_kernel<S><<<blocks, 32 * d.ns, smem, stream>>>(d, x, w, out);
    return (int)cudaGetLastError();
}

extern "C" int ofpt_conv_stack(const StackDesc* hd, const float* x,
                               const float* w, float* out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const StackDesc d = *hd;
    if (d.n_layers < 1 || d.n_layers > MAX_LAYERS)
        return (int)cudaErrorInvalidValue;
    if (d.B == 0) return 0;
    if (d.bf16)
        return launch<__nv_bfloat16>(d, x, w, out, (cudaStream_t)stream,
                                     nullptr);
    return launch<float>(d, x, w, out, (cudaStream_t)stream, nullptr);
}

// CTAs of the plan in *hd that the card keeps resident per SM (no launch).
extern "C" int ofpt_conv_stack_occupancy(const StackDesc* hd, int* ctas) {
    cudaGetLastError();
    const StackDesc d = *hd;
    if (d.bf16)
        return launch<__nv_bfloat16>(d, nullptr, nullptr, nullptr, 0, ctas);
    return launch<float>(d, nullptr, nullptr, nullptr, 0, ctas);
}
