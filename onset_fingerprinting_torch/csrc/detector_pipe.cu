// Fused streaming amplitude onset detector (K1) as a warp-specialised
// pipeline for Hopper, sm_90a, in two instantiations of one kernel:
// per-channel off-gating (coupled_off=False, the fleet path) and the
// coupled off-gate (coupled_off=True) over a long signal or a batch of
// streams.  Every mode: high-pass on or off, adaptive or manual
// thresholds, backtracking, the relative envelope written or not, and the
// warmup mode.  The realtime engine's one-block step stays on
// detector_warp.cu, coupled calls above 32 channels on detector.cu.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_detector.py:_detector_kernel
// (the Pallas body launched by pallas_detect_offline / make_pallas_detector,
// :85, called at :520; the coupled off-check at :307-309; the stream batch
// is parallel/sharding.py:686-687, a vmap of detect_offline).  Per sample:
// 4th-order DF2T high-pass -> rectified floor-clipped dB (log2 form) ->
// fast and slow attack/release envelopes -> relative envelope (exp2 back
// to linear, clipped) -> EMA min/max.  Per block of `bsz` samples:
// thresholds, first on-crossing, off check, cooldown, optional
// backtracking walk.  All state is carried, so one launch runs a whole
// chunk [T, C] (or [S, T, C]) and leaves the state for the next.
//
// What bounds it on the H100: the time recurrences are sequential, so the
// exact parallelism is across channels, and -- since the operations of a
// sample must keep their order and rounding -- across the chains of one
// channel's scan.  The work is 4 B read and 77 FP32 instructions per
// channel-sample (SASS: no FMA to fuse under -fmad=false; the accurate
// log2f alone is a 25-instruction polynomial, exp2f one MUFU.EX2 with
// range scaling), so at the fleet width the bound is operations (2.4 ms a
// chunk at 33.5e12 lane instructions/s), not bytes (1.3 ms).  detector.cu
// ran one thread per channel: 8 warps per SM, each waiting on its own
// loads (4.7 ms of its 10.7 alone) and on one long dependent chain,
// issuing its 132 instructions per sample about 40% of the time.  With
// few channels (a recording of 3 sensors) the operations bound cannot be
// reached at all: the floor is the longest single recurrence, the
// envelope step's 6 dependent FP32 operations per sample.
//
// What the design does about it: a CTA's 32 lanes hold its channels, one
// per lane, and it runs three warps over them, one chain each:
//   warp 0  loads x into its own ring (cp.async, NX - 1 sub-blocks ahead,
//           4 bytes a lane), then the IIR and the rectified dB;
//   warp 1  the fast and slow envelopes and the linear relative envelope
//           (and the rel output);
//   warp 2  the min/max tracker and, once a whole block is in, pass 2
//           (thresholds, first on-crossing, off check, cooldown), the
//           backtracking history and walk, and the on/deltas stores.
// A sample then costs the slowest chain, not the sum of the three (the
// one-warp-per-channel detector_warp.cu runs them one after another on
// lane 0).  The warps hand each other sub-blocks of SB = 16 rows through
// rings in shared memory, each slot guarded by an mbarrier pair (full: the
// producer's 32 lanes arrived after writing it; empty: the consumer's 32
// lanes arrived after reading it).  Pass 2 needs the min/max after a
// block's last sample, so the rel ring holds a whole block; warp 2
// releases each of its slots as its pass-2 scan passes it, so warp 1
// starts the next block at once.  Pass 2 is one scan.
//
// Per-channel gating (COUPLED = false): a CTA owns G = 32 channels, the
// ring rows 128 contiguous bytes; the off check from the first crossing is
// tracked beside the crossing.  A CTA takes 26.8 KB at bsz = 128 and 96
// threads of at most 80 registers: 8 CTAs per SM, all 1024 CTAs of C =
// 32768 in one wave, 24 warps per SM.  About 103 instructions per sample,
// 5.2 ms a chunk on the H100 against detector.cu's 10.7 (PERF.md); a
// fourth warp for the dB alone was slower (5.8 ms, PERF.md).
//
// Coupled (COUPLED = true): lane groups.  Lane grp * C + ch holds channel
// ch of stream gpc * blockIdx.x + grp: gpc detectors of C <= 32 coupled
// channels a CTA (gpc <= 32 / C; at C = 3 up to 10 streams and 2 idle
// lanes), a single recording one group.  The ring slots are compact,
// [SBR rows][gpc * C live lanes].  The coupled off-check (the off scan
// starts at the largest first-onset row across the detector's channels)
// is a reduction within the lane group in warp 2 (__reduce_max_sync with
// the group's mask, no CTA barrier); the single scan tracks each lane's
// last row below off, so the group's row decides without a second scan
// or a mask of rows.  Each warp loads its column of a sub-block into
// registers before running its chain on it (a load-compute-store loop
// over shared memory paid a load's latency every row: the compiler keeps
// a load behind an earlier store to the same array), and releases the
// slot at once.  The rel ring holds REL_BLOCKS blocks, so warp 1 runs on
// while warp 2 scans.  With few live lanes (at most SPREAD_LANES: one
// recording) the dB (log2f) and the linear rel (exp2f), which are not
// recurrences, run sample-parallel across all 32 lanes over a sub-block's
// values (detector_warp.cu's trick), sub-blocks are SB_FEW rows, so that
// a hand-off carries more samples, and one group's x and rel move in
// 16-byte pieces.  On the H100 (PERF.md): mining's two launches 11.9 ms
// against detector_warp.cu's 20.1, 1024 streams x 192000 8.0 ms against
// 26.2; the chain bound is 4.2 and 2.3.  ops/fused_detector.py::
// pipe_plan and coupled_plan mirror these numbers.
//
// Numerics: compiled with -fmad=false, so every multiply and add rounds on
// its own exactly as the element-wise plain PyTorch version does, and
// log2f/exp2f are the accurate library functions (no fast math); each
// sample's operations are detector.cu's, in its order.  The kernel is then
// bit-identical to onset_fingerprinting_torch's plain detect_offline on
// the card.  The debounce counter is float inside the kernel and int32 in
// the state (pallas_detector.py:304-305, 593).

#include <cuda_runtime.h>
#include <stdint.h>

// Field order and types must match ops/fused_detector.py::_DetParams
// (all 4-byte fields, no padding); the same struct as detector.cu's.
struct DetParams {
    int T, C, bsz;
    int use_iir, manual, coupled, backtrack, warmup, emit_rel;
    int nbt;
    float cooldown;
    float floor_db, eps, k_db, k_lin;
    float fa, fr, sa, sr;
    float am, ax, iam, iax, minmin;
    float b0, b1, b2, b3, b4, a1, a2, a3, a4;
    float bt_alpha, bt_omba, bt_tol;
};

// ops/fused_detector.py's PIPE_CHANNELS, PIPE_SUB_ROWS, PIPE_X_SLOTS,
// PIPE_DB_SLOTS, PIPE_ROLES, PIPE_REGS and COUPLED_REGS
constexpr int G = 32;             // lanes (channels) per CTA
constexpr int SB = 16;            // rows per sub-block
constexpr int SB_FEW = 64;        // coupled, few live lanes: rows per sub-block
constexpr int NX = 3;             // x ring slots (warp 0's prefetch)
constexpr int ND = 2;             // dB ring slots, warp 0 -> warp 1
constexpr int THREADS = 96;       // three warps
constexpr int MIN_CTAS = 8;       // per SM: at most 80 registers a thread
constexpr int COUPLED_MIN_CTAS = 4;  // coupled: at most 168 registers
constexpr int SLOT = SB * G;      // floats per ring slot, [SB rows][G]
// coupled, at most SPREAD_LANES live lanes ("few": one recording): the dB
// and the linear rel sample-parallel across the lanes, and sub-blocks of
// SB_FEW rows where the block size allows, so that a hand-off carries
// more samples (tools/detector_split.py times the alternatives: at 8
// groups of 3 both cost more than they save)
constexpr bool SPREAD = true;
constexpr int SPREAD_LANES = 8;
// coupled: the rel ring holds REL_BLOCKS blocks, so that warp 1 runs on
// while warp 2 scans the block before (per-channel gating: one block)
constexpr int REL_BLOCKS = 2;

__host__ __device__ constexpr size_t bars_bytes(int nsb) {
    return ((size_t)8 * (2 * ND + 2 * nsb) + 15) / 16 * 16;
}

// Dynamic shared memory: the barriers, then the x, dB and rel rings
// (nsb rel slots: bsz / SB, coupled REL_BLOCKS times that).
// ops/fused_detector.py::pipe_plan mirrors it.
__host__ __device__ constexpr size_t pipe_smem_bytes(int nsb, int sb = SB) {
    return bars_bytes(nsb) +
           (size_t)(NX + ND + nsb) * sb * G * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
                 "r"(count)
                 : "memory");
}

// each lane arrives once: a barrier's count is one warp's 32 lanes
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
                 : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred P1;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, P1;\n\t}"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
    return ok != 0;
}

//: clock cycles a wait may take before the kernel traps (about 10 s): a
//: hand-off that never comes is a fault, reported as a launch error
//: instead of a hung card
constexpr long long WAIT_LIMIT = 20000000000LL;

// wait until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
    const uint32_t addr = smem_u32(b);
    if (bar_try_wait(addr, parity)) return;
    const long long t0 = clock64();
    while (!bar_try_wait(addr, parity))
        if (clock64() - t0 > WAIT_LIMIT) __trap();
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bt_row(const float* bt, int pos, int r,
                                        int nbt, int C, int c) {
    return bt[(size_t)((pos + r) % nbt) * C + c];
}

// coupled: this lane's SB rows of a compact ring slot ([SB][ld]) to and
// from registers, all loads issued before the chain that uses them (the
// compiler keeps a shared-memory load behind an earlier store to the same
// array, so a load-compute-store loop pays the load latency every row)
template <int N>
__device__ __forceinline__ void load_col(float (&v)[N], const float* slot,
                                         int ld, int lane) {
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = slot[r * ld + lane];
}

template <int N>
__device__ __forceinline__ void store_col(float* slot, const float (&v)[N],
                                          int ld, int lane) {
#pragma unroll
    for (int r = 0; r < N; ++r) slot[r * ld + lane] = v[r];
}

// coupled, SPREAD: out[e] = f(in[e]) over a slot's n = N * ld values,
// element e on lane e % 32, two independent elements a lane at a time
// (in may be out)
template <int N, class F>
__device__ __forceinline__ void spread(float* out, const float* in, int n,
                                       int lane, F f) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
        const int e0 = lane + 32 * i, e1 = e0 + 32;
        if (32 * i >= n) break;
        const float a = e0 < n ? in[e0] : 0.f;
        const float b = e1 < n ? in[e1] : 0.f;
        const float fa = f(a), fb = f(b);
        if (e0 < n) out[e0] = fa;
        if (e1 < n) out[e1] = fb;
    }
}

template <bool IIR, bool MANUAL, bool EMIT, bool COUPLED, int SBR>
__global__ void __launch_bounds__(THREADS,
                                  COUPLED ? COUPLED_MIN_CTAS : MIN_CTAS)
    detector_pipe_kernel(DetParams p, int n_streams, int gpc,
                         const float* __restrict__ x,
                         const float* __restrict__ on_p,
                         const float* __restrict__ off_p, float* zi,
                         float* fast, float* slow, float* mn_s, float* mx_s,
                         uint8_t* gate_s, float* prev_s, int32_t* deb_s,
                         float* bt, const int32_t* bt_pos_in,
                         int32_t* bt_pos_out, uint8_t* on_out,
                         int32_t* delta_out, float* rel_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int SLOTR = SBR * G;  // floats per ring slot, [SBR rows][G]
    const int C = p.C;
    const int bsz = p.bsz;
    const int nsb = bsz / SBR;           // sub-blocks per block
    const int nrel = COUPLED ? REL_BLOCKS * nsb : nsb;  // rel slots
    const int nb = p.T / bsz;           // blocks in the chunk
    const int ng = nb * nsb;            // sub-blocks in the chunk
    uint64_t* d_full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* d_empty = d_full + ND;
    uint64_t* r_full = d_empty + ND;
    uint64_t* r_empty = r_full + nrel;
    float* xs = reinterpret_cast<float*>(smem + bars_bytes(nrel));
    float* db = xs + NX * SLOTR;
    float* rel = db + ND * SLOTR;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    // lane -> (stream s, channel ch); ld: a ring row's width.  Per-channel
    // gating: one stream, lane c of CTA b holds channel 32 b + c.  Coupled:
    // lane grp * C + ch holds channel ch of stream gpc * b + grp.  Idle
    // lanes compute on a valid channel and store nothing.
    int s, ch, ld;
    bool active;
    if constexpr (COUPLED) {
        const int grp = lane / C;
        ld = gpc * C;
        s = blockIdx.x * gpc + grp;
        ch = lane - grp * C;
        active = lane < ld && s < n_streams;
        s = min(s, n_streams - 1);
    } else {
        s = 0;
        ld = G;
        ch = blockIdx.x * G + lane;
        active = ch < C;
        ch = active ? ch : C - 1;
    }
    const bool lw = !COUPLED || lane < ld;  // the lane owns a ring column
    const bool spread_on = SPREAD && ld <= SPREAD_LANES;  // coupled only
    // coupled, one group a CTA: a sub-block of x (and of rel) is SBR * C
    // contiguous floats in device memory and in the compact ring slot, so
    // the lanes copy it in 16-byte pieces, not a row a lane (4 bytes each)
    const bool wide = COUPLED && gpc == 1 &&
                      ((uintptr_t)x | (uintptr_t)rel_out) % 16 == 0 &&
                      ((size_t)p.T * C) % 4 == 0;
    const size_t sx0 = (size_t)blockIdx.x * p.T * C;  // then: its stream
    const size_t sc = (size_t)s * C + ch;   // its state
    const size_t sx = (size_t)s * p.T * C + ch;  // its x and rel column
    float* btc = p.backtrack ? bt + (size_t)s * p.nbt * C : bt;

    if (threadIdx.x == 0) {
        for (int i = 0; i < 2 * ND + 2 * nrel; ++i) bar_init(d_full + i, 32);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {
        // ---- IIR and rectified dB, and the loads ----
        float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
        float* zc = IIR ? zi + (size_t)s * 4 * C + ch : zi;
        if (IIR) {
            z0 = zc[0];
            z1 = zc[(size_t)C];
            z2 = zc[(size_t)2 * C];
            z3 = zc[(size_t)3 * C];
        }
        const float* xc = x + sx;
        // sub-block g's rows into x slot g % NX, one group per sub-block
        auto load = [&](int g) {
            if (g < ng && wide) {
                float* dst = xs + (g % NX) * SLOTR;
                const float* src = x + sx0 + (size_t)g * SBR * C;
                for (int i = 4 * lane; i < SBR * C; i += 4 * 32)
                    copy16_async(dst + i, src + i);
            } else if (g < ng && lw) {
                float* dst = xs + (g % NX) * SLOTR + lane;
                const float* src = xc + (size_t)g * SBR * C;
#pragma unroll
                for (int r = 0; r < SBR; ++r)
                    copy4_async(dst + r * ld, src + (size_t)r * C);
            }
            copy_commit();
        };
        for (int g = 0; g < NX - 1; ++g) load(g);
        for (int g = 0; g < ng; ++g) {
            // the slot it refills was read in the previous iteration
            load(g + NX - 1);
            copy_wait<NX - 1>();  // this lane's rows of sub-block g are in
            if (wide) __syncwarp();  // and every lane's pieces
            const int ds = g % ND;
            bar_wait(d_empty + ds, ((g / ND) & 1) ^ 1);
            float* xin = xs + (g % NX) * SLOTR;
            float* dout = db + ds * SLOTR;
            if constexpr (COUPLED) {
                // the IIR one lane per channel, y in place of x; then the
                // dB, with SPREAD across all lanes over the sub-block's
                // SBR * ld values
                const auto db_of = [&](float y) {
                    return fmaxf(p.k_db * log2f(fabsf(y + p.eps)), p.floor_db);
                };
                float v[SBR];
                load_col(v, xin, ld, lane);
                if (IIR) {
#pragma unroll
                    for (int r = 0; r < SBR; ++r) {
                        const float xt = v[r];
                        const float y = p.b0 * xt + z0;
                        z0 = p.b1 * xt + z1 - p.a1 * y;
                        z1 = p.b2 * xt + z2 - p.a2 * y;
                        z2 = p.b3 * xt + z3 - p.a3 * y;
                        z3 = p.b4 * xt - p.a4 * y;
                        v[r] = y;
                    }
                }
                if (spread_on) {
                    if (IIR && lw) store_col(xin, v, ld, lane);
                    __syncwarp();  // every lane's rows (and y) are in
                    spread<SBR>(dout, xin, SBR * ld, lane, db_of);
                } else {
#pragma unroll
                    for (int r = 0; r < SBR; ++r) v[r] = db_of(v[r]);
                    if (lw) store_col(dout, v, ld, lane);
                }
                __syncwarp();  // read before any lane refills the slot
            } else {
#pragma unroll 4
                for (int r = 0; r < SBR; ++r) {
                    const float xt = xin[r * ld + lane];
                    float y = xt;
                    if (IIR) {
                        y = p.b0 * xt + z0;
                        z0 = p.b1 * xt + z1 - p.a1 * y;
                        z1 = p.b2 * xt + z2 - p.a2 * y;
                        z2 = p.b3 * xt + z3 - p.a3 * y;
                        z3 = p.b4 * xt - p.a4 * y;
                    }
                    const float xdb = p.k_db * log2f(fabsf(y + p.eps));
                    if (lw) dout[r * ld + lane] = fmaxf(xdb, p.floor_db);
                }
            }
            bar_arrive(d_full + ds);
        }
        copy_wait<0>();
        if (IIR && active) {
            zc[0] = z0;
            zc[(size_t)C] = z1;
            zc[(size_t)2 * C] = z2;
            zc[(size_t)3 * C] = z3;
        }
    } else if (warp == 1) {
        // ---- fast and slow envelopes, linear relative envelope ----
        float yf = fast[sc], ys = slow[sc];
        const float hi = -p.floor_db;
        for (int g = 0; g < ng; ++g) {
            const int ds = g % ND;
            const int jr = g % nrel;  // its rel slot
            bar_wait(d_full + ds, (g / ND) & 1);
            bar_wait(r_empty + jr, ((g / nrel) & 1) ^ 1);
            const float* din = db + ds * SLOTR;
            float* rout = rel + jr * SLOTR;
            float* gout = EMIT ? rel_out + sx + (size_t)g * SBR * C : rel_out;
            if constexpr (COUPLED) {
                // the envelopes one lane per channel, their dB difference
                // into the rel slot; with SPREAD the linear rel across all
                // lanes
                const auto rel_of = [&](float d) {
                    return fminf(fmaxf(exp2f(d * p.k_lin) - p.eps, 0.f), hi);
                };
                float v[SBR];
                load_col(v, din, ld, lane);
                bar_arrive(d_empty + ds);  // the dB slot is read
                // (both products beside the compare: the same rounding as
                // selecting the rate first, one dependent step shorter)
                const auto envelopes = [&](auto out_of) {
#pragma unroll
                    for (int r = 0; r < SBR; ++r) {
                        const float xdb = v[r];
                        const float df = xdb - yf + p.eps;
                        yf = yf + (df > 0.f ? p.fa * df : p.fr * df);
                        const float dsl = xdb - ys + p.eps;
                        ys = ys + (dsl > 0.f ? p.sa * dsl : p.sr * dsl);
                        v[r] = out_of(yf - ys);
                    }
                };
                // one loop per choice: a branch inside the chain would
                // cost a row its exp2 either way
                if (spread_on)
                    envelopes([](float d) { return d; });
                else
                    envelopes(rel_of);
                if (lw) store_col(rout, v, ld, lane);
                if (spread_on) {
                    __syncwarp();  // every lane's differences are in
                    spread<SBR>(rout, rout, SBR * ld, lane, rel_of);
                    __syncwarp();  // every lane's rel is in
                }
                if (EMIT && wide) {  // the sub-block's rel, 16 bytes a lane
                    if (!spread_on) __syncwarp();
                    float* go = rel_out + sx0 + (size_t)g * SBR * C;
                    for (int i = 4 * lane; i < SBR * C; i += 4 * 32)
                        *reinterpret_cast<float4*>(go + i) =
                            *reinterpret_cast<const float4*>(rout + i);
                } else if (EMIT && active) {
                    if (spread_on) load_col(v, rout, ld, lane);
#pragma unroll
                    for (int r = 0; r < SBR; ++r) gout[(size_t)r * C] = v[r];
                }
            } else {
#pragma unroll 4
                for (int r = 0; r < SBR; ++r) {
                    const float xdb = din[r * ld + lane];
                    const float df = xdb - yf + p.eps;
                    yf = yf + (df > 0.f ? p.fa : p.fr) * df;
                    const float dsl = xdb - ys + p.eps;
                    ys = ys + (dsl > 0.f ? p.sa : p.sr) * dsl;
                    const float d = yf - ys;
                    float rr = exp2f(d * p.k_lin) - p.eps;
                    rr = fminf(fmaxf(rr, 0.f), hi);
                    if (lw) rout[r * ld + lane] = rr;
                    if (EMIT && active) gout[(size_t)r * C] = rr;
                }
                bar_arrive(d_empty + ds);
            }
            bar_arrive(r_full + jr);
        }
        if (active) {
            fast[sc] = yf;
            slow[sc] = ys;
        }
    } else {
        // ---- min/max, pass 2, backtracking, events ----
        float mn = mn_s[sc], mx = mx_s[sc];
        bool gate = gate_s[sc] != 0;
        float prev = prev_s[sc];
        float deb = (float)deb_s[sc];
        const float onp = on_p[ch], offp = off_p[ch];
        int pos = p.backtrack ? bt_pos_in[s] : 0;
        // coupled: the lanes of this lane's group (a partial last group of
        // idle lanes is a group of its own)
        const unsigned gmask =
            COUPLED ? (unsigned)((((uint64_t)1 << C) - 1)
                                 << ((lane / C) * C))
                    : 0xffffffffu;
        for (int g = 0; g < ng; ++g) {
            const int blk = g / nsb;
            const int j = g - blk * nsb;  // in its block
            const int jr = g % nrel;      // its rel slot
            const int jr0 = jr - j;       // its block's first slot
            bar_wait(r_full + jr, (g / nrel) & 1);
            if (COUPLED && !MANUAL) {
                float v[SBR];
                load_col(v, rel + jr * SLOTR, ld, lane);
#pragma unroll
                for (int r = 0; r < SBR; ++r) {
                    const float rr = v[r];
                    mn = rr < p.minmin ? p.minmin
                                       : (rr < mn ? rr : mn * p.iam + rr * p.am);
                    mx = rr > mx ? rr : mx * p.iax + rr * p.ax;
                }
            } else if (!MANUAL) {
                const float* rin = rel + jr * SLOTR + lane;
#pragma unroll 4
                for (int r = 0; r < SBR; ++r) {
                    const float rr = rin[r * ld];
                    mn = rr < p.minmin ? p.minmin
                                       : (rr < mn ? rr : mn * p.iam + rr * p.am);
                    mx = rr > mx ? rr : mx * p.iax + rr * p.ax;
                }
            }
            if (p.warmup) {  // warmup_minmax: envelopes and min/max only
                bar_arrive(r_empty + jr);
                continue;
            }
            if (j < nsb - 1) continue;  // pass 2 waits for the whole block

            float on_th, off_th;
            if (MANUAL) {
                on_th = onp;
                off_th = offp;
            } else {
                on_th = mx * onp + mn;
                off_th = mx * offp + mn;
            }
            const bool can_fire = !gate && deb < 1.f;
            // backtracking history: ring of the last nbt rel samples
            if (p.backtrack && active)
                for (int t = 0; t < bsz; ++t)
                    btc[(size_t)((pos + t) % p.nbt) * C + ch] =
                        rel[(jr0 + t / SBR) * SLOTR + (t % SBR) * ld + lane];
            // one scan: the first on-crossing and, per-channel, the off
            // check both from row 0 (no crossing) and from the crossing on;
            // coupled, the last row below off
            int first = bsz, last_lo = -1;
            bool off_all = false, off_from = false;
            float pv = prev;
            const auto scan = [&](float rr, int t) {
                if (first == bsz && can_fire && rr > on_th && pv < on_th) {
                    first = t;
                    off_from = false;
                }
                const bool lo = rr < off_th;
                if (COUPLED) {
                    if (lo) last_lo = t;
                } else {
                    off_all = off_all || lo;
                    off_from = off_from || lo;
                }
                pv = rr;
            };
            for (int jj = 0; jj < nsb; ++jj) {
                if constexpr (COUPLED) {
                    // the slot in registers, released at once
                    float v[SBR];
                    load_col(v, rel + (jr0 + jj) * SLOTR, ld, lane);
                    bar_arrive(r_empty + jr0 + jj);
#pragma unroll
                    for (int r = 0; r < SBR; ++r) scan(v[r], jj * SBR + r);
                } else {
                    const float* rb = rel + (jr0 + jj) * SLOTR + lane;
#pragma unroll 4
                    for (int r = 0; r < SBR; ++r) scan(rb[r * ld], jj * SBR + r);
                    bar_arrive(r_empty + jr0 + jj);
                }
            }
            if (p.backtrack) pos = (pos + bsz) % p.nbt;
            const bool on = first < bsz;
            const int on_idx = on ? first : 0;
            gate = gate || on;
            if (on) deb = p.cooldown;
            if (deb > 0.f) deb = deb - (float)bsz;
            if (COUPLED) {
                // the off check from the group's largest first-onset row
                // (pallas_detector.py:307-309): some row at or after it
                // below off
                if (last_lo >= __reduce_max_sync(gmask, on_idx)) gate = false;
            } else if (on ? off_from : off_all) {
                gate = false;
            }
            prev = pv;

            int delta = on_idx;
            if (p.backtrack && on && active) {
                // walk back while the EMA-smoothed envelope keeps
                // decreasing (detect/amplitude.py::_backtrack semantics,
                // one channel; detector.cu's walk)
                const int n = p.nbt;
                int i = bsz - on_idx;
                float cur = bt_row(btc, pos, n - i, n, C, ch);
                i += 1;
                int r1 = n - i;
                if (r1 < 0) r1 += n;  // negative index wraps, as in numpy
                float prv = bt_row(btc, pos, r1, n, C, ch);
                float prevs = p.bt_alpha * prv + p.bt_omba * cur;
                for (int k = 0; k < n; ++k) {
                    const bool go = (cur > prevs) &&
                                    (fabsf(prevs - prv) > p.bt_tol) &&
                                    (i + 1 < n);
                    if (!go) break;
                    delta -= 1;
                    i += 1;
                    cur = prevs;
                    int r = n - i;
                    r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
                    prv = bt_row(btc, pos, r, n, C, ch);
                    prevs = p.bt_alpha * prv + p.bt_omba * cur;
                }
            }
            if (active) {
                const size_t o = ((size_t)s * nb + blk) * C + ch;
                on_out[o] = on ? 1 : 0;
                delta_out[o] = delta;
            }
        }
        if (active) {
            mn_s[sc] = mn;
            mx_s[sc] = mx;
            gate_s[sc] = gate ? 1 : 0;
            prev_s[sc] = prev;
            deb_s[sc] = (int32_t)deb;
        }
        if (p.backtrack && active && ch == 0) bt_pos_out[s] = pos;
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

template <bool IIR, bool MANUAL, bool EMIT, bool COUPLED, int SBR>
static cudaError_t launch(const DetParams& p, int n_streams, int gpc,
                          int ctas, size_t smem, cudaStream_t st,
                          const float* x, const float* on_p, const float* off_p,
                          float* zi, float* fast, float* slow, float* mn,
                          float* mx, uint8_t* gate, float* prev, int32_t* deb,
                          float* bt, const int32_t* bt_pos_in,
                          int32_t* bt_pos_out, uint8_t* on_out,
                          int32_t* delta_out, float* rel_out) {
    auto kern = detector_pipe_kernel<IIR, MANUAL, EMIT, COUPLED, SBR>;
    // the most shared memory per SM, so that 8 CTAs fit
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kern<<<ctas, THREADS, smem, st>>>(
        p, n_streams, gpc, x, on_p, off_p, zi, fast, slow, mn, mx, gate, prev,
        deb, bt, bt_pos_in, bt_pos_out, on_out, delta_out, rel_out);
    return cudaGetLastError();
}

#define OFPT_PIPE_CASE(m, a, b, e, cp, sb)                                   \
    case m:                                                                  \
        return (int)launch<a, b, e, cp, sb>(p, n_streams, gpc, ctas, smem, st, \
                                        x,                                   \
                                        on_p, off_p, zi, fast, slow, mn, mx, \
                                        gate, prev, deb, bt, bt_pos_in,      \
                                        bt_pos_out, on_out, delta_out,       \
                                        rel_out);
#define OFPT_PIPE_MODES(cp, sb)                    \
    switch (mode) {                                \
        OFPT_PIPE_CASE(0, false, false, false, cp, sb) \
        OFPT_PIPE_CASE(1, false, false, true, cp, sb)  \
        OFPT_PIPE_CASE(2, false, true, false, cp, sb)  \
        OFPT_PIPE_CASE(3, false, true, true, cp, sb)   \
        OFPT_PIPE_CASE(4, true, false, false, cp, sb)  \
        OFPT_PIPE_CASE(5, true, false, true, cp, sb)   \
        OFPT_PIPE_CASE(6, true, true, false, cp, sb)   \
        OFPT_PIPE_CASE(7, true, true, true, cp, sb)    \
    }

// One launch over a whole chunk; the contract of detector.cu's ofpt_detect
// without its coupled mode and scratch: the state buffers are updated in
// place (fresh copies, or the caller's `out`; bt_pos_in is never
// bt_pos_out).
extern "C" int ofpt_detect_pipe(const DetParams* hp, const float* x,
                                const float* on_p, const float* off_p,
                                float* zi, float* fast, float* slow, float* mn,
                                float* mx, uint8_t* gate, float* prev,
                                int32_t* deb, float* bt,
                                const int32_t* bt_pos_in, int32_t* bt_pos_out,
                                uint8_t* on_out, int32_t* delta_out,
                                float* rel_out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const DetParams p = *hp;
    if (p.coupled || p.bsz <= 0 || p.bsz % SB || p.C <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = pipe_smem_bytes(p.bsz / SB);
    const cudaStream_t st = (cudaStream_t)stream;
    const int n_streams = 1, gpc = 1, ctas = (p.C + G - 1) / G;
    const int mode = (p.use_iir ? 4 : 0) | (p.manual ? 2 : 0) |
                     (p.emit_rel ? 1 : 0);
    OFPT_PIPE_MODES(false, SB)
    return (int)cudaErrorInvalidValue;
}

// The coupled detector over `n_streams` independent streams of C <= 32
// channels each, x [S, T, C], in one launch of ceil(S / gpc) CTAs of gpc
// lane groups; the state and the outputs carry a leading stream axis
// (bt_pos [S]), the thresholds are shared (ofpt_detect_warp_streams'
// contract; S = 1 is one recording).  The state buffers are updated in
// place (bt_pos_in may be bt_pos_out: each stream's is read and written
// by its own group).
extern "C" int ofpt_detect_pipe_coupled(
    const DetParams* hp, int n_streams, int gpc, const float* x,
    const float* on_p, const float* off_p, float* zi, float* fast,
    float* slow, float* mn, float* mx, uint8_t* gate, float* prev,
    int32_t* deb, float* bt, const int32_t* bt_pos_in, int32_t* bt_pos_out,
    uint8_t* on_out, int32_t* delta_out, float* rel_out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const DetParams p = *hp;
    if (!p.coupled || p.bsz <= 0 || p.bsz % SB || p.C < 1 || p.C > G ||
        n_streams < 1 || gpc < 1 || gpc * p.C > G)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int ctas = (n_streams + gpc - 1) / gpc;
    const int mode = (p.use_iir ? 4 : 0) | (p.manual ? 2 : 0) |
                     (p.emit_rel ? 1 : 0);
    if (gpc * p.C <= SPREAD_LANES && p.bsz % SB_FEW == 0) {
        const size_t smem = pipe_smem_bytes(REL_BLOCKS * p.bsz / SB_FEW,
                                            SB_FEW);
        OFPT_PIPE_MODES(true, SB_FEW)
    } else {
        const size_t smem = pipe_smem_bytes(REL_BLOCKS * p.bsz / SB);
        OFPT_PIPE_MODES(true, SB)
    }
    return (int)cudaErrorInvalidValue;
}
#undef OFPT_PIPE_MODES
#undef OFPT_PIPE_CASE
