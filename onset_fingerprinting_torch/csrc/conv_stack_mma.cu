// Fused stride-1 Conv1d stack (K3) on Hopper's tensor cores, bf16, sm_90a.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_conv.py:_stack_kernel_unrolled
// (the serving body) and _stack_kernel (body='looped') in bf16 storage: a
// chain of stride-1 Conv1d layers with the same zero padding on every layer
// and bias + activation after every layer (the last included),
// [B, L] -> [B, T_out, O_last] float32.  float32 storage (golden mode) stays
// on the CUDA-core kernel, conv_stack.cu.
//
// What bounds it on the H100: operations.  The flagship stack (1 -> 5 x 7
// features, kernels 1, 33, 64, 15, 15, 15, 1, L = 256, padding 1) is 162.7
// GFLOP of useful work for 131072 signals: 0.165 ms at the 989 TFLOP/s
// dense bf16 tensor rate, against 0.16 GB of HBM traffic (0.05 ms).
//
// The formulation is the TPU kernel's: each block of TB = 16 output
// positions of one output feature o is one tensor-core product
//     band[o*16 + tau, i*S + s] @ window[i*S + s, signal]
// with band[o*16 + tau, i*S + s] = w[o, i, s - tau] (zero outside [0, K))
// and window = rows [t0 - pad, t0 - pad + S) of input feature i's buffer,
// S = rnd(16 + K - 1, 16).  The window starts at the first row it needs
// (ldmatrix takes any 16-byte-aligned row), so the band is issued at
// S / K times the useful work per tap, and layers run an even number of
// blocks: 304.7 GFLOP per call for the flagship (1.87x the useful work),
// the excess mostly in the two K = 1 layers (16x) and the three K = 15
// layers (2.1x).
//
// What the design does about it:
// - mma.sync.m16n8k16 bf16 -> f32.  M = 16 output positions of one output
//   feature, N = 16 signals (two n8 tiles), K = 16 window rows of one input
//   feature.  wgmma would need 64-row M tiles (four output features of the
//   flagship's five) and 8-row-aligned windows; mma.sync takes any row.
// - The band is never stored.  It is Toeplitz: A[tau][s] = w[s - tau], so
//   every register of an A fragment is a pair (w[j - 15], w[j - 14]) with
//   j = s - tau + 15, and the fragment's four registers are the pairs at
//   j, j - 8, j + 8 and j again.  Each layer's weights go to shared memory
//   as a table of such pairs, [O][I][S + 16] 32-bit words (10 KB for the
//   flagship's K = 64 layer, against 64 KB for its band); the next k step
//   reuses the pair at j + 8, so a fragment costs two conflict-free loads.
// - The B fragments (the window) are ldmatrix.x4.trans of [time row]
//   [signal] rows of the activation buffers: the im2col costs nothing.
// - A warp task is two adjacent blocks (32 positions) of up to 5 output
//   features.  The band is the same for every block, and the second
//   block's window is the first one's one k step later, so each step loads
//   one B fragment and 2 * 5 pair words for 20 products.  Layers run an
//   even number of blocks; positions past T_out are written as zeros.
// - A CTA holds 16 signals and every layer's activations in two ping-pong
//   bf16 buffers [feature][time row][signal] in shared memory, with 16
//   leading zero rows per feature (so every window start t0 - pad is a
//   row) and a zero tail up to the last window's end.  HBM sees one read of
//   x and one write of the output.  Rows are 32 bytes; the 16-byte halves
//   are swapped on every other group of four rows, so the eight rows of an
//   ldmatrix and the epilogue's stores hit eight distinct bank groups at
//   any start row.  The flagship takes 104 KB: two CTAs on each SM.
// - The epilogue adds the bias and applies the activation in f32 (one
//   unrolled loop per activation, so only the one that runs is fetched),
//   zeroes positions at or past T_out and stores bf16 into the other
//   buffer.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 1.93 ms for the
// flagship at 131072 signals, 158 TFLOP/s issued, against 13.35 ms for the
// CUDA-core kernel on the same card.

// Rounding points mirror the TPU kernel (pallas_conv.py:213-233, 475,
// 500-508, 535): inputs and weights in bf16, f32 accumulation, f32 bias +
// activation, activations stored in bf16 between layers, f32 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16

constexpr int NS = 16;         // signals per CTA: N of two m16n8 tiles
constexpr int ZR = 16;         // leading zero rows of every feature buffer
constexpr int TB = 16;         // output positions per block: one m16 tile
constexpr int ROW_BYTES = NS * 2;
constexpr int THREADS = 256;
constexpr int OG_MAX = 5;      // output features of one warp task

// Must match ops/conv_stack.py::_MmaDesc field for field.
struct MmaDesc {
    int n_layers, B, L, act;
    int buf_rows;  // rows of every feature buffer
    int max_feat;  // most features of any activation (the input's 1 incl.)
    int in_zero_end;  // input rows [ZR + L, in_zero_end) are zeroed
    int max_taps;     // 32-bit words of the largest layer's pair table
    int win0;         // first window row of block 0: ZR - pad
    int I[MAX_LAYERS], O[MAX_LAYERS], T_out[MAX_LAYERS];
    int S[MAX_LAYERS];         // window rows per input feature
    int n_blk[MAX_LAYERS];     // blocks of 16 output positions (even)
    int zero_end[MAX_LAYERS];  // output rows [ZR + 16 n_blk, zero_end) zeroed
    int tap_off[MAX_LAYERS], b_off[MAX_LAYERS];
};

// 0 linear, 1 relu, 2 silu, 3 leaky relu (0.01), 4 elu, 5 tanh, 6 sigmoid.
// silu and sigmoid use the hardware exp2 and reciprocal (a few f32 ulp, far
// below the bf16 rounding that follows): they run on every activation.
template <int ACT>
__device__ __forceinline__ float activate(float x) {
    switch (ACT) {
        case 1: return x > 0.f ? x : 0.f;
        case 2: return __fdividef(x, 1.f + __expf(-x));
        case 3: return x > 0.f ? x : 0.01f * x;
        case 4: return x > 0.f ? x : expm1f(x);
        case 5: return tanhf(x);
        case 6: return __fdividef(1.f, 1.f + __expf(-x));
        default: return x;
    }
}

template <int OG, int ACT>
__device__ __forceinline__ void activate_all(float (&acc)[2][OG][2][4]) {
#pragma unroll
    for (int o = 0; o < OG; ++o)
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            float& v = acc[e >> 3][o][(e >> 2) & 1][e & 3];
            v = activate<ACT>(v);
        }
}

// Byte offset of (row, signal s) in one feature buffer: the two 16-byte
// halves of a row swap on every other group of four rows.
__device__ __forceinline__ int swz(int row, int s) {
    return row * ROW_BYTES + ((((s >> 3) ^ (row >> 2)) & 1) << 4) +
           ((s & 7) << 1);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp: output positions [t0, t0 + 32) -- two blocks of 16 -- of output
// features og*OG_MAX ... + OG - 1 for the CTA's 16 signals.  The band is the
// same for every block, so both blocks take the same A fragments, and the
// second block's window is the first one's shifted by one k step: each
// step loads one B fragment and 2 * OG pair words for 4 * OG products.
template <int OG>
__device__ void mma_task(uint32_t cur, unsigned char* nxt, uint32_t taps,
                         const float* __restrict__ bias, int og, int I,
                         int S, int T_out, int buf_bytes, int win, int t0,
                         int act, int lane) {
    const int tw = S + 16;  // words of one (o, i) pair table
    const int ostride = I * tw;
    float acc[2][OG][2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int o = 0; o < OG; ++o)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][o][e >> 2][e & 3] = 0.f;
    const int g = lane >> 2;            // fragment row group
    const int c = (lane & 3) * 2;       // fragment column pair
    const int mi = lane >> 3;           // ldmatrix: this lane's matrix
    const int kr = ((mi & 1) << 3) + (lane & 7);  // ... its k row
    const int half = mi >> 1;           // ... its n8 tile
    // byte addresses in the shared pair table
    const uint32_t tg = taps + 4 * (og * OG_MAX * ostride + c - g + 15);
    const int os4 = 4 * ostride;
    auto b_addr = [&](int i, int kc) {
        const int row = win + kc + kr;
        return cur + i * buf_bytes + row * ROW_BYTES +
               (((half ^ (row >> 2)) & 1) << 4);
    };
    for (int i = 0; i < I; ++i) {
        const uint32_t ti = tg + 4 * i * tw;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b_addr(i, 0), b0, b1, b2, b3);
        // A registers: pairs j, j - 8, j + 8, j; step kc + 16 reuses j + 8
        uint32_t a0[OG], a1[OG], a2[OG];
#pragma unroll
        for (int o = 0; o < OG; ++o) {
            a0[o] = lds32(ti + o * os4);
            a1[o] = lds32(ti + o * os4 - 32);
            a2[o] = lds32(ti + o * os4 + 32);
        }
        for (int kc = 0; kc < S; kc += 16) {
            uint32_t n0, n1, n2, n3;
            ldsm_x4_trans(b_addr(i, kc + 16), n0, n1, n2, n3);
#pragma unroll
            for (int o = 0; o < OG; ++o) {
                mma_bf16(acc[0][o][0], a0[o], a1[o], a2[o], a0[o], b0, b1);
                mma_bf16(acc[0][o][1], a0[o], a1[o], a2[o], a0[o], b2, b3);
                mma_bf16(acc[1][o][0], a0[o], a1[o], a2[o], a0[o], n0, n1);
                mma_bf16(acc[1][o][1], a0[o], a1[o], a2[o], a0[o], n2, n3);
            }
            if (kc + 16 < S) {
#pragma unroll
                for (int o = 0; o < OG; ++o) {
                    a1[o] = a2[o];
                    a0[o] = lds32(ti + o * os4 + 4 * kc + 64);
                    a2[o] = lds32(ti + o * os4 + 4 * kc + 96);
                }
            }
            b0 = n0; b1 = n1; b2 = n2; b3 = n3;
        }
    }
#pragma unroll
    for (int o = 0; o < OG; ++o) {
        const float bo = __ldg(bias + og * OG_MAX + o);
#pragma unroll
        for (int e = 0; e < 16; ++e)
            acc[e >> 3][o][(e >> 2) & 1][e & 3] += bo;
    }
    // one loop per activation: only the one that runs is fetched
    switch (act) {
        case 1: activate_all<OG, 1>(acc); break;
        case 2: activate_all<OG, 2>(acc); break;
        case 3: activate_all<OG, 3>(acc); break;
        case 4: activate_all<OG, 4>(acc); break;
        case 5: activate_all<OG, 5>(acc); break;
        case 6: activate_all<OG, 6>(acc); break;
        default: break;
    }
#pragma unroll
    for (int o = 0; o < OG; ++o) {
        unsigned char* fo = nxt + (size_t)(og * OG_MAX + o) * buf_bytes;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int k = e >> 2, n = (e >> 1) & 1, h = e & 1;
            const int t = t0 + 16 * k + g + 8 * h;
            const bool live = t < T_out;
            *reinterpret_cast<__nv_bfloat162*>(fo + swz(ZR + t, n * 8 + c)) =
                __floats2bfloat162_rn(live ? acc[k][o][n][2 * h] : 0.f,
                                      live ? acc[k][o][n][2 * h + 1] : 0.f);
        }
    }
}

__global__ void __launch_bounds__(THREADS, 2)
conv_stack_mma_kernel(MmaDesc d, const float* __restrict__ x,
                      const uint32_t* __restrict__ taps,
                      const float* __restrict__ bias,
                      float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int buf_bytes = d.buf_rows * ROW_BYTES;
    const int buf_total = d.max_feat * buf_bytes;
    unsigned char* cur = smem;
    unsigned char* nxt = smem + buf_total;
    uint4* tsm = reinterpret_cast<uint4*>(smem + 2 * buf_total);
    const uint32_t tsm_s = (uint32_t)__cvta_generic_to_shared(tsm);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = THREADS / 32;
    const int b0 = blockIdx.x * NS;

    // zero rows: every feature's ZR leading rows in both buffers, and the
    // input's tail up to the first layer's last window; every other row a
    // window reads is written (or zeroed) by the layer before
    const uint4 z4 = make_uint4(0, 0, 0, 0);
    const int head = ZR * ROW_BYTES / 16;
    for (int e = tid; e < 2 * d.max_feat * head; e += THREADS)
        reinterpret_cast<uint4*>(smem + (e / head) * buf_bytes)[e % head] =
            z4;
    const int in_tail = (d.in_zero_end - ZR - d.L) * ROW_BYTES / 16;
    for (int e = tid; e < in_tail; e += THREADS)
        reinterpret_cast<uint4*>(cur + (ZR + d.L) * ROW_BYTES)[e] = z4;
    for (int t = tid; t < d.L; t += THREADS) {
        float v[NS];
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
            v[sl] = b0 + sl < d.B ? __ldcs(x + (size_t)(b0 + sl) * d.L + t)
                                  : 0.f;
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
            *reinterpret_cast<__nv_bfloat16*>(cur + swz(ZR + t, sl)) =
                __float2bfloat16_rn(v[sl]);
    }

    for (int l = 0; l < d.n_layers; ++l) {
        const int I = d.I[l], O = d.O[l], S = d.S[l], T_out = d.T_out[l];
        __syncthreads();  // cur complete; every warp done with nxt, tsm
        // this layer's pair table: O * I * (S + 16) words, a multiple of 4,
        // at an offset that is one
        const uint4* tg4 =
            reinterpret_cast<const uint4*>(taps + d.tap_off[l]);
        for (int e = tid; e < O * I * (S + 16) / 4; e += THREADS)
            tsm[e] = __ldg(tg4 + e);
        // rows the next layer's windows read past this layer's writes may
        // hold an earlier layer's activations: zero them (no task of this
        // layer reads or writes them)
        const int z0 = ZR + d.n_blk[l] * TB, zn = d.zero_end[l] - z0;
        for (int e = tid; e < O * zn * 2; e += THREADS) {
            const int f = e / (zn * 2), r = (e >> 1) % zn;
            reinterpret_cast<uint4*>(nxt + (size_t)f * buf_bytes +
                                     (z0 + r) * ROW_BYTES)[e & 1] = z4;
        }
        __syncthreads();
        const int n_og = (O + OG_MAX - 1) / OG_MAX;
        const int n_pair = d.n_blk[l] / 2;
        const uint32_t cur_s = (uint32_t)__cvta_generic_to_shared(cur);
        const float* bl = bias + d.b_off[l];
        for (int u = warp; u < n_pair * n_og; u += n_warps) {
            const int og = u % n_og, t0 = (u / n_og) * 2 * TB;
            const int win = d.win0 + t0;
#define OFPT_TASK(N)                                                    \
    case N:                                                             \
        mma_task<N>(cur_s, nxt, tsm_s, bl, og, I, S, T_out, buf_bytes,  \
                    win, t0, d.act, lane);                              \
        break;
            switch (min(OG_MAX, O - og * OG_MAX)) {
                OFPT_TASK(1) OFPT_TASK(2) OFPT_TASK(3) OFPT_TASK(4)
                OFPT_TASK(5)
            }
#undef OFPT_TASK
        }
        unsigned char* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    __syncthreads();
    const int last = d.n_layers - 1;
    const int O = d.O[last], per = d.T_out[last] * O;
    const int dt = THREADS / O, dO = THREADS % O;
    const int t_first = tid / O, o_first = tid % O;
    for (int sl = 0; sl < NS && b0 + sl < d.B; ++sl) {
        float* ob = out + (size_t)(b0 + sl) * per;
        int t = t_first, o = o_first;
        for (int r = tid; r < per; r += THREADS) {
            __stcs(ob + r, __bfloat162float(
                               *reinterpret_cast<const __nv_bfloat16*>(
                                   cur + (size_t)o * buf_bytes +
                                   swz(ZR + t, sl))));
            t += dt;
            o += dO;
            if (o >= O) {
                o -= O;
                ++t;
            }
        }
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int ofpt_conv_stack_mma(const MmaDesc* hd, const float* x,
                                   const uint32_t* taps, const float* b,
                                   float* out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const MmaDesc d = *hd;
    if (d.n_layers < 1 || d.n_layers > MAX_LAYERS)
        return (int)cudaErrorInvalidValue;
    if (d.B == 0) return 0;
    // a plan past the card's shared memory is refused here
    const size_t smem = 2 * (size_t)d.max_feat * d.buf_rows * ROW_BYTES +
                        4 * (size_t)d.max_taps;
    cudaError_t e = cudaFuncSetAttribute(
        conv_stack_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (d.B + NS - 1) / NS;
    conv_stack_mma_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        d, x, taps, b, out);
    return (int)cudaGetLastError();
}
