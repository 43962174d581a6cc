// Fused stride-1 Conv1d stack (K3) on Hopper's tensor cores, bf16, sm_90a,
// for a batch too small to fill the card: each group of 16 signals is one
// thread-block cluster whose CTAs split the time axis.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_conv.py:_stack_kernel_unrolled
// (the serving body, :187) and _stack_kernel (body='looped', :249), the
// pallas_call at :523, in bf16 storage, as csrc/conv_stack_mma.cu does, and
// computes exactly what that kernel computes: [B, L] -> [B, T_out, O_last]
// float32, bit for bit.  ops/conv_stack.py::kernel_for sends it the stacks
// that kernel has a plan for when the batch is small (the realtime
// classifier: 3 channels x 16 hits = 48 signals of L = 512).
//
// What bounds it on the H100: neither operations nor bytes.  The flagship
// at B = 48, L = 512 is 0.15 GFLOP (0.00015 ms at the 989 TFLOP/s bf16
// rate) and 0.5 MB.  conv_stack_mma.cu gives such a batch 3 CTAs (one per
// 16 signals) on 132 SMs; each walks all seven layers alone, 2-3 rounds of
// dependent mma.sync chains per layer over its 8 warps, so a call is one
// SM's latency through seven layers (0.087 ms) and the card ~98% idle.
// What is left is latency: the launch, each layer's chain of products
// (I * S / 16 k steps: 25 for the K = 64 layer, ~200-250 SM cycles a step
// for a warp's 4-8 products), its epilogue, and a cluster barrier per
// layer.
//
// What the design does about it:
// - The time axis of each group is split over a cluster of R CTAs (8, the
//   portable size, or 16, non-portable), launched with cudaLaunchKernelEx
//   and cudaLaunchAttributeClusterDimension.  A layer's warp tasks (32
//   output positions: two blocks of 16) are the tensor-core kernel's; CTA
//   c owns the same contiguous range of tasks in every layer (those the
//   layer has: ops/conv_stack.py::cluster_plan, ClusterDesc::range), the
//   longer ranges last, so a shorter layer loses tasks from the end.
// - Each CTA keeps per feature two input buffers, alternating by layer,
//   over one fixed span of rows: its positions and their windows' reach.
//   A task's epilogue writes its outputs into the CTA's own next buffer
//   (its positions are its next windows' own rows).  The halo -- the
//   windows' rows past the CTA's range (S - 16 - padding of them, up to
//   63 for the K = 64 layer) and `padding` rows before it -- is pulled
//   after a cluster barrier from the CTAs that own those rows, through
//   DSMEM (mapa + ld.shared::cluster, 16 bytes a thread, a thread's loads
//   issued before its stores; the owners may be more than one neighbour
//   away when ranges are short), and each CTA zeroes its rows no task
//   writes.  ldmatrix reads only the CTA's own shared memory, so the halo
//   is copied, never read in place.  One cluster barrier per layer
//   (arrive.release after the units, wait.acquire before the pull): with
//   the buffers alternating, an owner's next writes to the rows it lends
//   come two layers later, after the barrier its readers reach only once
//   their pull is done.  A last barrier, arrived at after the last pull
//   and waited for at the exit, keeps each CTA until no other reads its
//   memory.  No row is computed twice (halo recompute without a cluster
//   would take ~2.4x the useful rows at 8 tiles: the receptive field is
//   137 rows).  Measured on an H100 (tools/conv_stack_split.py --cluster,
//   PERF.md): the arrive's release is a MEMBAR.ALL.GPU in SASS (~1000
//   cycles a layer), the pull one DSMEM round trip (1000-2500 cycles);
//   pushing the halo instead cost 2500-4500 cycles to issue its stores,
//   and pushing every row to every reader from the epilogue, 4 bytes a
//   store, ~3000.
// - The warps are spread: a warp unit is one task's `fg` output features,
//   not all five, so with 1-2 tasks per CTA per layer the CTA's 8 warps
//   all have chains to run.  A warp issues its mma.sync m16n8k16 about
//   every 35-40 SM cycles here, and a sub-partition takes one about every
//   30 (conv_stack_mma.cu's ~150 TFLOP/s at the fleet's batch), so a
//   layer takes about as long as its busiest warp's chain of products:
//   the plan picks the units that give the busiest warp the fewest
//   products a step (the flagship's one task a CTA: 5 units of one
//   feature, 4 a step).
// - Each output block's product sequence is conv_stack_mma.cu's: the same
//   window start win0 + t0, S, k-step order, pair-table fragments and f32
//   epilogue (bias, activation, bf16 rounding, zeros past T_out).  Only
//   the rows' places in shared memory differ.
// - Every layer's pair tables and biases are staged into shared memory once
//   by cp.async, layer 0's first, the rest landing while layer 0 runs; the
//   descriptor's per-layer table is copied to shared memory, a run of
//   words a warp (read from the kernel parameters with a layer index in
//   the loop, each layer paid constant-cache misses, ~1000 cycles; a
//   word a thread, each warp's 32 addresses took the constant cache one
//   after another, ~3500 cycles of the staging).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16
#define MAX_CLUSTER 16

constexpr int NS = 16;         // signals per cluster: N of two m16n8 tiles
constexpr int ZR = 16;         // the tensor-core kernel's leading zero rows
constexpr int TB = 16;         // output positions per block: one m16 tile
constexpr int ROW_BYTES = NS * 2;
constexpr int THREADS = 256;  // ops/conv_stack.py::CLUSTER_WARPS warps
constexpr int WARPS = THREADS / 32;

// the per-layer table, copied to shared memory
struct Layers {
    int I[MAX_LAYERS], O[MAX_LAYERS], T_out[MAX_LAYERS];
    int S[MAX_LAYERS];       // window rows per input feature
    int n_pair[MAX_LAYERS];  // tasks of 32 output positions
    int fg[MAX_LAYERS];      // output features per warp unit
    int tap_off[MAX_LAYERS], b_off[MAX_LAYERS];
    // CTA c owns tasks [range[c], range[c + 1]) of every layer (those the
    // layer has)
    int range[MAX_CLUSTER + 1];
};

// Must match ops/conv_stack.py::_ClusterDesc field for field.  Rows are
// the tensor-core kernel's: input position t at row ZR + t.
struct ClusterDesc {
    int n_layers, B, L, act;
    int ctas;        // CTAs of a cluster
    int in_rows;     // rows of every feature buffer
    int max_feat;    // most features of any activation
    int win0;        // first window row of block 0: ZR - pad
    int taps_words;  // 32-bit words of all layers' pair tables
    int bias_words;  // floats of all layers' biases
    // the table, as Layers lays it out
    int I[MAX_LAYERS], O[MAX_LAYERS], T_out[MAX_LAYERS], S[MAX_LAYERS];
    int n_pair[MAX_LAYERS], fg[MAX_LAYERS];
    int tap_off[MAX_LAYERS], b_off[MAX_LAYERS];
    int range[MAX_CLUSTER + 1];
};
static_assert(sizeof(ClusterDesc) == 10 * 4 + sizeof(Layers),
              "the descriptor's table is Layers");

// 0 linear, 1 relu, 2 silu, 3 leaky relu (0.01), 4 elu, 5 tanh, 6 sigmoid:
// conv_stack_mma.cu's, instruction for instruction.
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
// halves of a row swap on every other group of four rows (the buffers'
// own row numbers: any start row keeps ldmatrix conflict-free).
__device__ __forceinline__ int swz(int row, int s) {
    return row * ROW_BYTES + ((((s >> 3) ^ (row >> 2)) & 1) << 4) +
           ((s & 7) << 1);
}

// byte offset of 16-byte half h of a row
__device__ __forceinline__ int half_off(int row, int h) {
    return row * ROW_BYTES + (((h ^ (row >> 2)) & 1) << 4);
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

// the cluster: this CTA's rank, its barrier, and another CTA's shared
// memory at the same offset as `addr` in this one's
__device__ __forceinline__ int cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r)
                 : "r"(addr), "r"(rank));
    return r;
}

// 16 bytes of another CTA's shared memory (no memory clobber: a thread's
// loads issue back to back, each waited for only where it is used)
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp unit: output positions [t0, t0 + 32) -- two blocks of 16 -- of
// output features f0 ... f0 + OG - 1 for the cluster's 16 signals;
// conv_stack_mma.cu's mma_task with the input window at row `win` of this
// CTA's input buffers `cur` and the outputs at rows `orow`... of its next
// input buffers `nxt` (the positions t0... decide what lies past T_out).
// Each block's products, and their order, are conv_stack_mma.cu's; the
// next step's A registers are loaded before this step's products.
template <int OG>
__device__ void mma_task(uint32_t cur, uint32_t nxt, uint32_t taps,
                         const float* bias, int f0, int I, int S, int T_out,
                         int in_bytes, int win, int t0, int orow, int act,
                         int lane) {
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
    const uint32_t tg = taps + 4 * (f0 * ostride + c - g + 15);
    const int os4 = 4 * ostride;
    auto b_addr = [&](int i, int kc) {
        const int row = win + kc + kr;
        return cur + i * in_bytes + row * ROW_BYTES +
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
            // the next step's A registers (the last step loads its own
            // again: an address inside the table)
            const int kn = kc + 16 < S ? kc : kc - 16;
            uint32_t c0[OG], c2[OG];
#pragma unroll
            for (int o = 0; o < OG; ++o) {
                c0[o] = lds32(ti + o * os4 + 4 * kn + 64);
                c2[o] = lds32(ti + o * os4 + 4 * kn + 96);
            }
#pragma unroll
            for (int o = 0; o < OG; ++o) {
                mma_bf16(acc[0][o][0], a0[o], a1[o], a2[o], a0[o], b0, b1);
                mma_bf16(acc[0][o][1], a0[o], a1[o], a2[o], a0[o], b2, b3);
                mma_bf16(acc[1][o][0], a0[o], a1[o], a2[o], a0[o], n0, n1);
                mma_bf16(acc[1][o][1], a0[o], a1[o], a2[o], a0[o], n2, n3);
            }
#pragma unroll
            for (int o = 0; o < OG; ++o) {
                a1[o] = a2[o];
                a0[o] = c0[o];
                a2[o] = c2[o];
            }
            b0 = n0; b1 = n1; b2 = n2; b3 = n3;
        }
    }
#pragma unroll
    for (int o = 0; o < OG; ++o) {
        const float bo = bias[f0 + o];
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
        const uint32_t fo = nxt + (f0 + o) * in_bytes;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int k = e >> 2, n = (e >> 1) & 1, h = e & 1;
            const int r = 16 * k + g + 8 * h;
            const bool live = t0 + r < T_out;
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(live ? acc[k][o][n][2 * h] : 0.f,
                                      live ? acc[k][o][n][2 * h + 1] : 0.f);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             fo + swz(orow + r, n * 8 + c)),
                         "r"(*reinterpret_cast<const uint32_t*>(&v))
                         : "memory");
        }
    }
}

// the CTA owning task p: range[c] <= p < range[c + 1], the ranges being
// ops/conv_stack.py::split_runs(N, n_ctas) (the last N % n_ctas one
// longer)
__device__ __forceinline__ int owner_of(const Layers& ly, int n_ctas, int p) {
    const int n = ly.range[n_ctas];
    const int base = n / n_ctas, extra = n - base * n_ctas;
    const int split = (n_ctas - extra) * base;
    return p < split ? p / base : n_ctas - extra + (p - split) / (base + 1);
}

// After layer l: the rows [r0, r1) of this CTA's layer-(l + 1) windows that
// other CTAs own, from their next buffers into this CTA's `nxt`, 16 bytes
// a thread, PULL_BATCH loads in flight before their stores (a range past
// the layer's last task owns no rows).
constexpr int PULL_BATCH = 4;

__device__ __forceinline__ void pull(const Layers& ly, int n_ctas, int l,
                                     int rank, unsigned char* nxt,
                                     uint32_t nxt_s, int r0, int r1,
                                     int in_bytes) {
    const int w_end = ZR + 2 * TB * ly.n_pair[l];
    const int own0 = ZR + 2 * TB * ly.range[rank];
    const int own1 = min(ZR + 2 * TB * ly.range[rank + 1], w_end);
    // before this CTA's rows, and after them
    const int a0 = max(r0, ZR), a1 = min(min(r1, own0), w_end);
    const int b0 = max(r0, own1), b1 = min(r1, w_end);
    const int na = max(0, a1 - a0), nb = max(0, b1 - b0);
    const int F = ly.O[l];
    const int per = (na + nb) * 2, total = per * F;
    for (int e0 = threadIdx.x; e0 < total; e0 += PULL_BATCH * THREADS) {
        uint4 v[PULL_BATCH];
        int dst[PULL_BATCH];
#pragma unroll
        for (int k = 0; k < PULL_BATCH; ++k) {
            const int e = e0 + k * THREADS;
            dst[k] = -1;
            if (e < total) {
                const int f = e / per, rr = e - f * per, h = rr & 1;
                const int i = rr >> 1;
                const int row = i < na ? a0 + i : b0 + (i - na);
                const int q = owner_of(ly, n_ctas, (row - ZR) / (2 * TB));
                v[k] = ld_cluster16(map_rank(nxt_s, q) + f * in_bytes +
                                    half_off(row - 2 * TB * ly.range[q], h));
                dst[k] = f * in_bytes +
                         half_off(row - 2 * TB * ly.range[rank], h);
            }
        }
#pragma unroll
        for (int k = 0; k < PULL_BATCH; ++k)
            if (dst[k] >= 0)
                *reinterpret_cast<uint4*>(nxt + dst[k]) = v[k];
    }
}

// Where CTA q's layer-l windows read: rows [*r0, *r1) of the tensor-core
// kernel's buffer (empty where it has no task in layer l).
__device__ __forceinline__ void reads(const Layers& ly, int win0, int l,
                                      int q, int* r0, int* r1) {
    const int n0 = min(ly.range[q], ly.n_pair[l]);
    const int n1 = min(ly.range[q + 1], ly.n_pair[l]);
    *r0 = win0 + 2 * TB * n0;
    *r1 = n1 > n0 ? win0 + 2 * TB * n1 - TB + ly.S[l] : *r0;
}

// After layer l, in this CTA's next buffer `nxt` (its row 0 is row `base`
// of the tensor-core kernel's buffer): the rows [r0, r1) of its layer-
// (l + 1) windows that no task of layer l wrote -- before ZR, from
// ZR + 32 n_pair[l] on -- zeroed (no other CTA reads or writes them).
__device__ __forceinline__ void zero_rows(const Layers& ly, int l,
                                          unsigned char* nxt, int r0, int r1,
                                          int base, int in_bytes) {
    const int w_end = ZR + 2 * TB * ly.n_pair[l];
    const int z_lo = max(0, min(ZR, r1) - r0);     // rows [r0, ZR)
    const int z_hi0 = max(r0, w_end);              // rows [z_hi0, r1)
    const int nz = z_lo + max(0, r1 - z_hi0);
    const int F = ly.O[l];
    const uint4 z4 = make_uint4(0, 0, 0, 0);
    for (int e = threadIdx.x; e < F * nz * 2; e += THREADS) {
        const int f = e / (nz * 2), rr = (e >> 1) % nz;
        const int row = rr < z_lo ? r0 + rr : z_hi0 + (rr - z_lo);
        *reinterpret_cast<uint4*>(nxt + (size_t)f * in_bytes +
                                  half_off(row - base, e & 1)) = z4;
    }
}

// one CTA per SM is all a small batch has: every thread may take the
// registers it needs (at 128 a thread the units spilled)
__global__ void __launch_bounds__(THREADS, 1)
conv_stack_cluster_kernel(const __grid_constant__ ClusterDesc d,
                          const float* __restrict__ x,
                          const uint32_t* __restrict__ taps,
                          const float* __restrict__ bias,
                          float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Layers ly;
    const int in_bytes = d.in_rows * ROW_BYTES;
    const int buf_total = d.max_feat * in_bytes;
    unsigned char* ins[2] = {smem, smem + buf_total};
    float* bsm = reinterpret_cast<float*>(smem + 2 * buf_total +
                                          4 * d.taps_words);
    const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t tsm_s = smem_s + 2 * buf_total;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int rank = cluster_rank();
    const int b0 = (blockIdx.x / d.ctas) * NS;
    const int win0 = d.win0, n_layers = d.n_layers, n_ctas = d.ctas;
    // this CTA's buffers start at row `base` of the tensor-core kernel's:
    // ZR - 16 before its first position
    const int base = 2 * TB * d.range[rank];

    // the pair tables (a multiple of 4 words each): layer 0's, then the
    // rest, in flight while x's rows are loaded and layer 0 runs
    const int t0_words = d.O[0] * d.I[0] * (d.S[0] + 16);
    for (int e = tid; e < t0_words / 4; e += THREADS)
        cp_async16(tsm_s + 16 * e, taps + 4 * e);
    cp_async_commit();
    for (int e = t0_words / 4 + tid; e < d.taps_words / 4; e += THREADS)
        cp_async16(tsm_s + 16 * e, taps + 4 * e);
    cp_async_commit();
    const float bv = tid < d.bias_words ? __ldg(bias + tid) : 0.f;
    // the table, a run of words a warp: each load's address is the same
    // across the warp (the constant cache serves a warp's different
    // addresses one after another)
    {
        constexpr int n = sizeof(Layers) / 4, per = (n + WARPS - 1) / WARPS;
        const int* src = d.I;
        for (int e = warp * per; e < min(n, (warp + 1) * per); ++e) {
            const int v = src[e];
            if (lane == 0) reinterpret_cast<int*>(&ly)[e] = v;
        }
    }
    // layer 0's window rows of x, zero outside [0, L)
    {
        const int q0 = min(d.range[rank], d.n_pair[0]);
        const int q1 = min(d.range[rank + 1], d.n_pair[0]);
        const int r0 = win0 + 2 * TB * q0;
        const int n = q1 > q0 ? 2 * TB * (q1 - q0) - TB + d.S[0] : 0;
        for (int r = tid; r < n; r += THREADS) {
            const int t = r0 + r - ZR;
            float v[NS];
#pragma unroll
            for (int sl = 0; sl < NS; ++sl)
                v[sl] = t >= 0 && t < d.L && b0 + sl < d.B
                            ? __ldcs(x + (size_t)(b0 + sl) * d.L + t)
                            : 0.f;
#pragma unroll
            for (int sl = 0; sl < NS; ++sl)
                *reinterpret_cast<__nv_bfloat16*>(
                    ins[0] + swz(r0 + r - base, sl)) =
                    __float2bfloat16_rn(v[sl]);
        }
    }
    if (tid < d.bias_words) bsm[tid] = bv;
    for (int e = THREADS + tid; e < d.bias_words; e += THREADS)
        bsm[e] = __ldg(bias + e);
    cp_async_wait<1>();  // layer 0's tables
    __syncthreads();

    for (int l = 0; l < n_layers; ++l) {
        const int I = ly.I[l], O = ly.O[l], S = ly.S[l], T_out = ly.T_out[l];
        const int q0 = min(ly.range[rank], ly.n_pair[l]);
        const int q1 = min(ly.range[rank + 1], ly.n_pair[l]);
        const int fg = ly.fg[l], n_fg = (O + fg - 1) / fg;
        const uint32_t cur_s = smem_s + (l & 1) * buf_total;
        const uint32_t nxt_s = smem_s + ((l + 1) & 1) * buf_total;
        const uint32_t tl = tsm_s + 4 * ly.tap_off[l];
        const float* bl = bsm + ly.b_off[l];
        for (int u = warp; u < (q1 - q0) * n_fg; u += WARPS) {
            const int pr = u / n_fg, f0 = (u - pr * n_fg) * fg;
            const int t0 = 2 * TB * (q0 + pr);
#define OFPT_TASK(N)                                                      \
    case N:                                                               \
        mma_task<N>(cur_s, nxt_s, tl, bl, f0, I, S, T_out, in_bytes,     \
                    win0 + t0 - base, t0, ZR + t0 - base, d.act, lane);   \
        break;
            switch (min(fg, O - f0)) {
                OFPT_TASK(1) OFPT_TASK(2) OFPT_TASK(3) OFPT_TASK(4)
                OFPT_TASK(5)
            }
#undef OFPT_TASK
        }
        if (l == 0) cp_async_wait<0>();  // every other layer's tables
        if (l + 1 == n_layers) break;
        // every CTA's outputs of layer l are in its next buffer, and every
        // CTA is done with the rows it pulled for layer l
        cluster_arrive();
        int r0, r1;
        reads(ly, win0, l + 1, rank, &r0, &r1);
        zero_rows(ly, l, ins[(l + 1) & 1], r0, r1, base, in_bytes);
        cluster_wait();
        pull(ly, n_ctas, l, rank, ins[(l + 1) & 1], nxt_s, r0, r1, in_bytes);
        if (l + 2 == n_layers) cluster_arrive();  // this CTA's last pull
        __syncthreads();
    }
    __syncthreads();
    // the last layer's positions of this CTA's range, from its own buffer
    const int last = n_layers - 1;
    const int O = ly.O[last], T = ly.T_out[last];
    const int t_lo = 2 * TB * min(ly.range[rank], ly.n_pair[last]);
    const int t_hi = min(2 * TB * min(ly.range[rank + 1], ly.n_pair[last]),
                         T);
    const unsigned char* ob = ins[(last + 1) & 1];
    const int per = max(0, t_hi - t_lo) * O;
    for (int sl = 0; sl < NS && b0 + sl < d.B; ++sl) {
        float* os = out + ((size_t)(b0 + sl) * T + t_lo) * O;
        for (int r = tid; r < per; r += THREADS) {
            const int t = r / O, o = r - t * O;
            __stcs(os + r,
                   __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                       ob + (size_t)o * in_bytes +
                       swz(ZR + t_lo + t - base, sl))));
        }
    }
    // no CTA leaves while another may still pull from its memory
    if (n_layers > 1) cluster_wait();
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static size_t cluster_smem(const ClusterDesc& d) {
    return (size_t)d.max_feat * 2 * d.in_rows * ROW_BYTES +
           4 * (size_t)d.taps_words + 16 * (size_t)((d.bias_words + 3) / 4);
}

// the launch's configuration (cluster of d.ctas CTAs along x), after the
// kernel's attributes are set; a plan past the card's shared memory or
// cluster size is refused here
static cudaError_t cluster_config(const ClusterDesc& d, void* stream,
                                  cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
    if (d.n_layers < 1 || d.n_layers > MAX_LAYERS || d.ctas < 1 ||
        d.ctas > MAX_CLUSTER || d.taps_words % 4 != 0)
        return cudaErrorInvalidValue;
    const size_t smem = cluster_smem(d);
    cudaError_t e = cudaFuncSetAttribute(
        conv_stack_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (d.ctas > 8) {
        e = cudaFuncSetAttribute(conv_stack_cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
        if (e != cudaSuccess) return e;
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)(((d.B + NS - 1) / NS) * d.ctas));
    cfg->blockDim = dim3(THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = (cudaStream_t)stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)d.ctas;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

extern "C" int ofpt_conv_stack_mma_cluster(const ClusterDesc* hd,
                                           const float* x,
                                           const uint32_t* taps,
                                           const float* b, float* out,
                                           void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const ClusterDesc d = *hd;
    if (d.B == 0) return 0;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = cluster_config(d, stream, &cfg, &attr);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, conv_stack_cluster_kernel, d, x, taps, b,
                           out);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// how many clusters of this plan the card keeps resident at once (the
// occupancy query; no launch)
extern "C" int ofpt_conv_stack_mma_cluster_occupancy(const ClusterDesc* hd,
                                                     int* clusters) {
    cudaGetLastError();
    const ClusterDesc d = *hd;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = cluster_config(d, nullptr, &cfg, &attr);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, (void*)conv_stack_cluster_kernel, &cfg);
}
