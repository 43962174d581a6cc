// The CCCNN's bf16 DFT head in one kernel, sm_90a: K3's feature maps in,
// the dense layer's outputs out.
//
// No TPU kernel: the JAX package leaves the head to XLA (models/cccnn.py:
// 479-497 there).  On the card it was two bf16 GEMMs (cuBLAS) into f32
// spectra, about fifteen ATen passes (copies of K3's transposed view, the
// power spectrum, the sum over maps, casts, cc_norm) and an f32 GEMM for
// the dense layer, every intermediate a round trip through HBM: for the
// flagship's fleet call (36480 windows x 4 channels) two f32 spectra of
// 400 MB each.
//
// What it computes, per window b (C channels c, K maps k, V samples v;
// F = L / 2 + 1 frequencies, L = the multiple of 16 at or above 2V - 1):
//     re, im[c, k, f] = sum_v x[c, k, v] * cos / -sin(2 pi v f / L)
//     power[c, f]     = sum_k re^2 + im^2
//     cc[c, j]        = sum_f power[c, f] * inv[f, j]        (2V - 1 lags)
//     lag0[c]         = cc[c, V - 1] + 1e-6
//     out[b, o]       = sum_{c, j} W[o, c (2V-1) + j] * cc[c, j] / lag0[c]
//                       + sum_c W[o, C (2V-1) + c] * log(lag0[c]) + bias[o]
// Rounding points (those of ops/xcorr.py's "default" precision and the
// chain it replaces): features, DFT and inverse matrices in bf16; both
// products accumulate in f32; re^2, im^2, their sum and the sum over maps
// each round in f32; the power spectrum rounds to bf16 before the inverse;
// cc_norm and the dense layer in f32.  Only the order of the sums differs.
//
// What bounds it on the H100: operations.  The flagship (V = 133, F = 137,
// K = 5) is 53.2 GFLOP of forward products and 10.6 GFLOP of inverse ones
// for 145920 signals (the fleet's call): 0.065 ms at 989 TFLOP/s, 0.098 ms
// at the 650 TFLOP/s that mma.sync reaches on this card, against 388 MB of
// f32 features read once (0.116 ms at 3.35 TB/s).
//
// The design (hopper-kernels: move fewer bytes, keep intermediates on chip):
// - A persistent CTA per SM walks tiles of 16 signals (window x channel;
//   16 / C whole windows, so a window's channels share a tile).  Its warps
//   take two roles that overlap tile after tile:
//   - six copy warps copy the next tile's features into shared memory
//     (cp.async of one contiguous range: K3's [signal][v][k] f32, or
//     [signal][k][v]) and turn them into K bf16 planes [16 signals][v],
//     rows of 152 bf16 (a conflict-free ldmatrix), v past V zero;
//   - six product warps run everything else.  The forward products are
//     mma.sync.m16n8k16 bf16 -> f32 with A = plane k, B = the DFT matrices:
//     warp w owns n tiles (8 frequencies) w + 6 jj and keeps their cos and
//     -sin B fragments for all 9 k steps in registers for the kernel's life
//     (108 registers): the DFT matrices are read from HBM once per warp and
//     never from shared memory.  The K planes put a signal's K spectra in
//     the same registers, so the sum over maps is an add per value.  The
//     power spectrum goes to shared memory in bf16 and is the A operand of
//     the inverse product against the bf16 inverse matrix, transposed to
//     [lag][f] and resident in shared memory (87.5 KB); warp w owns lag
//     tiles w + 6 jl.  The warp holding lag V - 1 publishes lag 0; each
//     warp divides its lags by it (a double reciprocal, rounded as the
//     division rounds), takes their dot with fc.weight (resident too), and
//     the CTA sums each window's partials, log terms and bias.
//   Every warp runs all its n tiles and k steps whatever V is (zeros past
//   V, F and 2V - 1), so no product is predicated.  The planes are
//   double-buffered; named barriers hand them over (full: the copy warps
//   arrive, the product warps wait; empty: the reverse), so the next tile's
//   copy and planes are made beside this tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int F_WARPS = 6;    // product warps
constexpr int X_WARPS = 6;    // copy and planes warps
constexpr int WARPS = F_WARPS + X_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int X_THREADS = 32 * X_WARPS;
constexpr int ROWS = 16;      // signals per tile: one m16 tile
constexpr int PITCH = 152;    // bf16 per row of the planes, power, inverse
constexpr int PLANE = ROWS * PITCH + 8;  // bf16 per plane: a 16-byte skew
constexpr int MAX_KS = 9;     // k steps of either product: V, F <= 144
constexpr int MAX_FJ = 3;     // forward n tiles per warp: F <= 144
constexpr int MAX_LJ = 6;     // lag n tiles per warp: 2V - 1 <= 288
// every warp runs all its n tiles and all MAX_KS k steps (zeros past V,
// F and 2V - 1): no predicate in the products
constexpr int INV_ROWS = 8 * F_WARPS * MAX_LJ;  // inverse rows in shared
constexpr int MAX_OUT = 8;    // dense outputs
constexpr int MAX_K = 8;      // feature maps

// named barriers: 0 is __syncthreads; the planes' hand-overs per buffer b
constexpr int BAR_X = 1;                 // the copy warps among themselves
constexpr int BAR_F = 2;                 // the product warps among themselves
constexpr int BAR_PLANES_FULL = 3;       // + b
constexpr int BAR_PLANES_EMPTY = 5;      // + b

// Must match ops/cccnn_head.py::_HeadDesc field for field.
struct HeadDesc {
    int B, C, K, V, O;
    int ks;         // forward k steps: ceil(V / 16)
    int n_fwd;      // forward n tiles: ceil(F / 8)
    int n_lag;      // lag n tiles: ceil((2V - 1) / 8)
    int per_tile;   // windows per tile: 16 / C
    int n_tiles;
    int sv, sk;     // strides of v and k inside a signal's V * K floats
    int raw_floats; // shared floats for one tile's features
    int w_floats;   // shared floats for fc's weight and bias, and zeros
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r0), "=r"(r1)
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared; only `bytes` of them are read, the rest
// of the 16 are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
}

// 1 / y in double, to about 2^-52: rcp.approx refined twice (0 for an
// infinite y, as x / inf is 0).  (float)(x * recip(y)) is x / y rounded to
// nearest, as IEEE division rounds it: x / y lies at least 2^-49 (relative)
// from a midpoint between floats, and the double product within 2^-51.
// Inline, unlike the division's slow path, which is a call.
__device__ __forceinline__ double recip(float y) {
    const double yd = y;
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(yd));
    r = fma(fma(-yd, r, 1.0), r, r);
    r = fma(fma(-yd, r, 1.0), r, r);
    return isinf(y) ? 0.0 : r;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Copy the 16-byte chunks holding tile `tile`'s features to `raw` (xt: the
// thread's index among the copy warps); the tile's first float is at
// raw[(return value)].
__device__ __forceinline__ int load_tile(const HeadDesc& d,
                                         const float* feats, float* raw,
                                         int tile, int xt) {
    const long long sig = (long long)d.V * d.K;
    const long long total = (long long)d.B * d.C * sig * 4;
    const int b0 = tile * d.per_tile;
    const int nb = min(d.per_tile, d.B - b0);
    const long long start = (long long)b0 * d.C * sig * 4;
    const long long end = start + (long long)nb * d.C * sig * 4;
    const long long lo = start & ~15LL;
    const int chunks = (int)((end - lo + 15) >> 4);
    const char* g = reinterpret_cast<const char*>(feats);
    for (int i = xt; i < chunks; i += X_THREADS) {
        const long long at = lo + 16LL * i;
        cp_async16(raw + 4 * i, g + at, (int)min(16LL, total - at));
    }
    cp_async_commit();
    return (int)((start - lo) >> 2);
}

// A tile's features (its first float at raw[off]) -> K bf16 planes
// [signal][v]: warp xw takes signals xw, xw + X_WARPS, ...; lane l takes v =
// l + 32 m and every map (reads at a stride of K floats, odd for the
// flagship: no bank conflict).  Rows past the tile's signals are zeroed;
// columns past V stay zero.
__device__ __forceinline__ void rearrange(const HeadDesc& d, const float* raw,
                                          int off, int tile,
                                          __nv_bfloat16* planes, int xw,
                                          int lane) {
    const int rows = min(d.per_tile, d.B - tile * d.per_tile) * d.C;
    for (int r = xw; r < ROWS; r += X_WARPS) {
        const float* src = raw + off + r * d.V * d.K;
        __nv_bfloat16* row = planes + r * PITCH;
#pragma unroll
        for (int m = 0; m < (16 * MAX_KS + 31) / 32; ++m) {
            const int v = lane + 32 * m;
            if (v < d.V) {
                float x[MAX_K];
#pragma unroll
                for (int k = 0; k < MAX_K; ++k)
                    x[k] = k < d.K && r < rows ? src[v * d.sv + k * d.sk]
                                               : 0.f;
#pragma unroll
                for (int k = 0; k < MAX_K; ++k)
                    if (k < d.K)
                        row[k * PLANE + v] = __float2bfloat16_rn(x[k]);
            }
        }
    }
}

// The product warps: each tile's forward products from its planes, power
// spectrum, inverse product, cc_norm, dense layer and sums per window.
__device__ __forceinline__ void product_warp(
    const HeadDesc& d, const uint4* __restrict__ fwd,
    float* __restrict__ out, const __nv_bfloat16* s_inv,
    const __nv_bfloat16* s_a, __nv_bfloat16* s_pow, const float* s_w,
    float* s_part, float* s_lag0, int n, int warp, int lane) {
    const int ft = 32 * warp + lane;
    const int g = lane >> 2, t = lane & 3;
    // ldmatrix.x4 row and column of this lane's address: matrices (rows
    // 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) = a0..a3
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lcol = (lane >> 4) * 8;
    const int step = gridDim.x;
    const int lags = 2 * d.V - 1;
    const int D = d.C * lags + d.C;  // fc's inputs
    const int lag0_tile = (d.V - 1) >> 3;
    const bool lag0_odd = (d.V - 1) & 1;
    // fc.weight's rows of this lane's signals g, g + 8 (channel = signal % C)
    const int wrow0 = (g % d.C) * lags, wrow1 = ((g + 8) % d.C) * lags;
    // this warp's forward B fragments, cos and -sin, for the kernel's life
    uint4 bfr[MAX_FJ][MAX_KS];
#pragma unroll
    for (int jj = 0; jj < MAX_FJ; ++jj) {
        const int j = warp + F_WARPS * jj;
#pragma unroll
        for (int s = 0; s < MAX_KS; ++s)
            bfr[jj][s] = (j < d.n_fwd && s < d.ks)
                             ? __ldg(fwd + ((size_t)j * d.ks + s) * 32 + lane)
                             : make_uint4(0, 0, 0, 0);
    }
    for (int i = 0; i < n; ++i) {
        const int b = i & 1, tile = blockIdx.x + i * step;
        bar_sync(BAR_PLANES_FULL + b, THREADS);
        // forward products; power summed over the maps in registers
        float pw[MAX_FJ][4];
#pragma unroll
        for (int jj = 0; jj < MAX_FJ; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) pw[jj][e] = 0.f;
        for (int k = 0; k < d.K; ++k) {
            float acc[MAX_FJ][2][4];
#pragma unroll
            for (int jj = 0; jj < MAX_FJ; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[jj][0][e] = acc[jj][1][e] = 0.f;
            const __nv_bfloat16* pa =
                s_a + (b * d.K + k) * PLANE + lrow * PITCH + lcol;
            // the next k step's fragment loads while this one multiplies
            uint32_t a[2][4];
            ldmatrix_x4(a[0], pa);
#pragma unroll
            for (int s = 0; s < MAX_KS; ++s) {
                if (s + 1 < MAX_KS)
                    ldmatrix_x4(a[(s + 1) & 1], pa + 16 * (s + 1));
#pragma unroll
                for (int jj = 0; jj < MAX_FJ; ++jj) {
                    mma(acc[jj][0], a[s & 1], bfr[jj][s].x, bfr[jj][s].y);
                    mma(acc[jj][1], a[s & 1], bfr[jj][s].z, bfr[jj][s].w);
                }
            }
#pragma unroll
            for (int jj = 0; jj < MAX_FJ; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    pw[jj][e] = __fadd_rn(
                        pw[jj][e],
                        __fadd_rn(__fmul_rn(acc[jj][0][e], acc[jj][0][e]),
                                  __fmul_rn(acc[jj][1][e], acc[jj][1][e])));
        }
        if (i + 2 < n) bar_arrive(BAR_PLANES_EMPTY + b, THREADS);
#pragma unroll
        for (int jj = 0; jj < MAX_FJ; ++jj) {
            __nv_bfloat16* p =
                s_pow + g * PITCH + 8 * (warp + F_WARPS * jj) + 2 * t;
            *reinterpret_cast<uint32_t*>(p) = pack_bf16(pw[jj][0], pw[jj][1]);
            *reinterpret_cast<uint32_t*>(p + 8 * PITCH) =
                pack_bf16(pw[jj][2], pw[jj][3]);
        }
        bar_sync(BAR_F, F_THREADS);

        // inverse product: this warp's lag tiles
        float cc[MAX_LJ][4];
#pragma unroll
        for (int jl = 0; jl < MAX_LJ; ++jl)
#pragma unroll
            for (int e = 0; e < 4; ++e) cc[jl][e] = 0.f;
        {
            const __nv_bfloat16* pp = s_pow + lrow * PITCH + lcol;
            const __nv_bfloat16* pi =
                s_inv + (lane & 7) * PITCH + ((lane >> 3) & 1) * 8;
            uint32_t a[2][4];
            ldmatrix_x4(a[0], pp);
#pragma unroll
            for (int s = 0; s < MAX_KS; ++s) {
                if (s + 1 < MAX_KS)
                    ldmatrix_x4(a[(s + 1) & 1], pp + 16 * (s + 1));
                uint32_t bb[MAX_LJ][2];
#pragma unroll
                for (int jl = 0; jl < MAX_LJ; ++jl)
                    ldmatrix_x2(bb[jl][0], bb[jl][1],
                                pi + 8 * (warp + F_WARPS * jl) * PITCH +
                                    16 * s);
#pragma unroll
                for (int jl = 0; jl < MAX_LJ; ++jl)
                    mma(cc[jl], a[s & 1], bb[jl][0], bb[jl][1]);
            }
        }
        // lag 0 (column V - 1) of each signal
        if (lag0_tile % F_WARPS == warp && t == (((d.V - 1) & 7) >> 1)) {
#pragma unroll
            for (int jl = 0; jl < MAX_LJ; ++jl) {
                if (jl == lag0_tile / F_WARPS) {
                    s_lag0[g] =
                        __fadd_rn(lag0_odd ? cc[jl][1] : cc[jl][0], 1e-6f);
                    s_lag0[g + 8] =
                        __fadd_rn(lag0_odd ? cc[jl][3] : cc[jl][2], 1e-6f);
                }
            }
        }
        bar_sync(BAR_F, F_THREADS);

        // cc / lag0 against fc.weight: this warp's lags of rows g, g + 8
        const int nb = min(d.per_tile, d.B - tile * d.per_tile);
        const int rows = nb * d.C;
        {
            const double r0 = recip(s_lag0[g]), r1 = recip(s_lag0[g + 8]);
#pragma unroll
            for (int jl = 0; jl < MAX_LJ; ++jl)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col =
                        8 * (warp + F_WARPS * jl) + 2 * t + (e & 1);
                    const bool ok = col < lags && g + 8 * (e >> 1) < rows;
                    cc[jl][e] =
                        ok ? (float)((double)cc[jl][e] * (e < 2 ? r0 : r1))
                           : 0.f;
                }
        }
        for (int o = 0; o < d.O; ++o) {
            // weights of rows g, g + 8 at this lane's first column; a column
            // past the lags (its value 0) reads the next row's weight, or
            // the zeros after the bias
            const float* w0 = s_w + o * D + wrow0 + 2 * t;
            const float* w1 = s_w + o * D + wrow1 + 2 * t;
            float d0 = 0.f, d1 = 0.f;
#pragma unroll
            for (int jl = 0; jl < MAX_LJ; ++jl) {
                const int c0 = 8 * (warp + F_WARPS * jl);
                if (c0 < lags) {
                    d0 = fmaf(w0[c0], cc[jl][0], d0);
                    d0 = fmaf(w0[c0 + 1], cc[jl][1], d0);
                    d1 = fmaf(w1[c0], cc[jl][2], d1);
                    d1 = fmaf(w1[c0 + 1], cc[jl][3], d1);
                }
            }
            d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
            d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
            d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
            d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
            if (t == 0) {
                s_part[(warp * ROWS + g) * MAX_OUT + o] = d0;
                s_part[(warp * ROWS + g + 8) * MAX_OUT + o] = d1;
            }
        }
        bar_sync(BAR_F, F_THREADS);

        // each window: each row's warp partials and log term, then its
        // channels' rows (adjacent lanes), the bias
        if (ft < ROWS * MAX_OUT) {
            const int r = ft & 15, o = ft >> 4;
            float v = 0.f;
            if (o < d.O) {
#pragma unroll
                for (int wv = 0; wv < F_WARPS; ++wv)
                    v += s_part[(wv * ROWS + r) * MAX_OUT + o];
                v = fmaf(s_w[o * D + d.C * lags + r % d.C], logf(s_lag0[r]),
                         v);
            }
            float sum = v;
            for (int c = 1; c < d.C; ++c)
                sum += __shfl_sync(0xffffffffu, v, min(lane + c, 31));
            if (o < d.O && r % d.C == 0 && r / d.C < nb)
                out[(size_t)(tile * d.per_tile + r / d.C) * d.O + o] =
                    sum + s_w[d.O * D + o];
        }
    }
}

// The copy warps: each tile's features copied and turned into planes one
// tile ahead of the product warps.
__device__ __forceinline__ void copy_warp(const HeadDesc& d,
                                          const float* __restrict__ feats,
                                          __nv_bfloat16* s_a, float* s_raw,
                                          int n, int xt) {
    const int step = gridDim.x;
    const int plane_set = d.K * PLANE;
    int off = load_tile(d, feats, s_raw, blockIdx.x, xt);
    for (int i = 0; i < n; ++i) {
        const int b = i & 1, tile = blockIdx.x + i * step;
        cp_async_wait_all();
        bar_sync(BAR_X, X_THREADS);
        if (i >= 2) bar_sync(BAR_PLANES_EMPTY + b, THREADS);
        rearrange(d, s_raw, off, tile, s_a + b * plane_set, xt >> 5,
                  xt & 31);
        bar_arrive(BAR_PLANES_FULL + b, THREADS);
        bar_sync(BAR_X, X_THREADS);
        if (i + 1 < n)
            off = load_tile(d, feats, s_raw, tile + step, xt);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
cccnn_head_kernel(const HeadDesc d, const float* __restrict__ feats,
                  const uint4* __restrict__ fwd,
                  const uint4* __restrict__ inv,
                  const float* __restrict__ w,
                  const float* __restrict__ bias,
                  float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int D = d.C * (2 * d.V - 1) + d.C;
    __nv_bfloat16* s_inv = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* s_a = s_inv + INV_ROWS * PITCH;      // [2][K] planes
    __nv_bfloat16* s_pow = s_a + 2 * d.K * PLANE;       // [ROWS][PITCH]
    float* s_raw = reinterpret_cast<float*>(s_pow + ROWS * PITCH);
    // fc.weight [O][D], the bias, zeros
    float* s_w = s_raw + d.raw_floats;
    float* s_part = s_w + d.w_floats;                   // [F][ROWS][MAX_OUT]
    float* s_lag0 = s_part + F_WARPS * ROWS * MAX_OUT;  // [ROWS]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the inverse and fc, resident
    {
        const int chunks = 8 * d.n_lag * PITCH * 2 / 16;
        for (int i = tid; i < chunks; i += THREADS)
            cp_async16(reinterpret_cast<uint4*>(s_inv) + i, inv + i, 16);
        cp_async_commit();
        for (int i = chunks + tid; i < INV_ROWS * PITCH * 2 / 16; i += THREADS)
            reinterpret_cast<uint4*>(s_inv)[i] = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < d.w_floats; i += THREADS)
        s_w[i] = i < d.O * D       ? __ldg(w + i)
                 : i < d.O * D + d.O ? __ldg(bias + i - d.O * D)
                                     : 0.f;
    // plane and power columns no thread writes stay zero
    for (int i = tid; i < (2 * d.K * PLANE + ROWS * PITCH) / 2; i += THREADS)
        reinterpret_cast<uint32_t*>(s_a)[i] = 0u;
    cp_async_wait_all();
    __syncthreads();

    // this CTA's tiles: blockIdx.x + i * gridDim.x
    const int n = (d.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    if (warp < F_WARPS)
        product_warp(d, fwd, out, s_inv, s_a, s_pow, s_w, s_part, s_lag0, n,
                     warp, lane);
    else
        copy_warp(d, feats, s_a, s_raw, n, tid - F_THREADS);
    cp_async_wait_all();
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Shared bytes of a plan: must match ops/cccnn_head.py::head_plan.
static size_t head_smem(const HeadDesc& d) {
    return (size_t)INV_ROWS * PITCH * 2 + (size_t)2 * d.K * PLANE * 2 +
           (size_t)ROWS * PITCH * 2 + (size_t)d.raw_floats * 4 +
           (size_t)d.w_floats * 4 + (size_t)F_WARPS * ROWS * MAX_OUT * 4 +
           ROWS * 4;
}

extern "C" int ofpt_cccnn_head(const HeadDesc* hd, const float* feats,
                               const uint4* fwd, const uint4* inv,
                               const float* w, const float* bias, float* out,
                               void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const HeadDesc d = *hd;
    if (d.C < 1 || d.C > ROWS || d.O < 1 || d.O > MAX_OUT || d.K < 1 ||
        d.K > MAX_K || d.ks > MAX_KS ||
        d.n_fwd > F_WARPS * MAX_FJ || d.n_lag > F_WARPS * MAX_LJ ||
        16 * d.ks > PITCH ||
        d.per_tile * d.C > ROWS || d.w_floats % 4 ||
        d.w_floats < d.O * (d.C * (2 * d.V - 1) + d.C + 1) + 8)
        return (int)cudaErrorInvalidValue;
    if (d.B == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = head_smem(d);
    e = cudaFuncSetAttribute(cccnn_head_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = d.n_tiles < sms ? d.n_tiles : sms;
    cccnn_head_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        d, feats, fwd, inv, w, bias, out);
    return (int)cudaGetLastError();
}
