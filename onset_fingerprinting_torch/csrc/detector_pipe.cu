// Fused streaming amplitude onset detector (K1) as a warp-specialised
// pipeline for Hopper, sm_90a.  Every mode with per-channel off-gating
// (coupled_off=False): high-pass on or off, adaptive or manual thresholds,
// backtracking, the relative envelope written or not, and the warmup mode.
// The coupled mode stays on detector.cu (one CTA, a barrier across all
// channels per block).
//
// Replaces onset_fingerprinting_tpu/ops/pallas_detector.py:_detector_kernel
// (the Pallas body launched by pallas_detect_offline / make_pallas_detector)
// for the fleet path.  Per sample: 4th-order DF2T high-pass -> rectified
// floor-clipped dB (log2 form) -> fast and slow attack/release envelopes ->
// relative envelope (exp2 back to linear, clipped) -> EMA min/max.  Per
// block of `bsz` samples: thresholds, first on-crossing, off check,
// cooldown, optional backtracking walk.  All state is carried, so one
// launch runs a whole chunk [T, C] and leaves the state for the next.
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
// issuing its 132 instructions per sample about 40% of the time.
//
// What the design does about it: a CTA owns G = 32 channels, one per
// lane, and runs three warps over them, one chain each:
//   warp 0  loads x into its own ring (cp.async, NX - 1 sub-blocks ahead,
//           4 bytes a lane, 128 contiguous bytes a row), then the IIR and
//           the rectified dB;
//   warp 1  the fast and slow envelopes and the linear relative envelope
//           (and the rel output);
//   warp 2  the min/max tracker and, once a whole block is in, pass 2
//           (thresholds, first on-crossing, off check, cooldown), the
//           backtracking history and walk, and the on/deltas stores.
// They hand each other sub-blocks of SB = 16 rows through rings in shared
// memory, each slot guarded by an mbarrier pair (full: the producer's 32
// lanes arrived after writing it; empty: the consumer's 32 lanes arrived
// after reading it).  Pass 2 needs the min/max after a block's last
// sample, so the rel ring holds a whole block; warp 2 releases each of its
// slots as its pass-2 scan passes it, so warp 1 starts the next block at
// once.  Pass 2 is one scan (the off check from the first crossing is
// tracked beside the crossing).  A CTA takes 26.8 KB at bsz = 128 and 96
// threads of at most 80 registers: 8 CTAs per SM, all 1024 CTAs of C =
// 32768 in one wave, 24 warps per SM.  ops/fused_detector.py::pipe_plan
// mirrors these numbers.  About 103 instructions per sample, 5.2 ms a
// chunk on the H100 against detector.cu's 10.7 (PERF.md); a fourth warp
// for the dB alone was slower (5.8 ms, PERF.md).
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
// PIPE_DB_SLOTS, PIPE_ROLES and PIPE_REGS
constexpr int G = 32;             // channels per CTA, one per lane
constexpr int SB = 16;            // rows per sub-block
constexpr int NX = 3;             // x ring slots (warp 0's prefetch)
constexpr int ND = 2;             // dB ring slots, warp 0 -> warp 1
constexpr int THREADS = 96;       // three warps
constexpr int MIN_CTAS = 8;       // per SM: at most 80 registers a thread
constexpr int SLOT = SB * G;      // floats per ring slot, [SB rows][G]

__host__ __device__ constexpr size_t bars_bytes(int nsb) {
    return ((size_t)8 * (2 * ND + 2 * nsb) + 15) / 16 * 16;
}

// Dynamic shared memory: the barriers, then the x, dB and rel rings
// (nsb = bsz / SB rel slots).  ops/fused_detector.py::pipe_plan mirrors it.
__host__ __device__ constexpr size_t pipe_smem_bytes(int nsb) {
    return bars_bytes(nsb) + (size_t)(NX + ND + nsb) * SLOT * sizeof(float);
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

template <bool IIR, bool MANUAL, bool EMIT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) detector_pipe_kernel(
    DetParams p, const float* __restrict__ x, const float* __restrict__ on_p,
    const float* __restrict__ off_p, float* zi, float* fast, float* slow,
    float* mn_s, float* mx_s, uint8_t* gate_s, float* prev_s, int32_t* deb_s,
    float* bt, const int32_t* bt_pos_in, int32_t* bt_pos_out,
    uint8_t* on_out, int32_t* delta_out, float* rel_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int C = p.C;
    const int bsz = p.bsz;
    const int nsb = bsz / SB;           // sub-blocks per block, rel slots
    const int ng = (p.T / bsz) * nsb;   // sub-blocks in the chunk
    uint64_t* d_full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* d_empty = d_full + ND;
    uint64_t* r_full = d_empty + ND;
    uint64_t* r_empty = r_full + nsb;
    float* xs = reinterpret_cast<float*>(smem + bars_bytes(nsb));
    float* db = xs + NX * SLOT;
    float* rel = db + ND * SLOT;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int c = blockIdx.x * G + lane;
    const bool active = c < C;
    const int cc = active ? c : C - 1;  // idle lanes compute, store nothing

    if (threadIdx.x == 0) {
        for (int i = 0; i < 2 * ND + 2 * nsb; ++i) bar_init(d_full + i, 32);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {
        // ---- IIR and rectified dB, and the loads ----
        float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
        if (IIR) {
            z0 = zi[cc];
            z1 = zi[(size_t)C + cc];
            z2 = zi[(size_t)2 * C + cc];
            z3 = zi[(size_t)3 * C + cc];
        }
        const float* xc = x + cc;
        // sub-block g's rows into x slot g % NX, one group per sub-block
        auto load = [&](int g) {
            if (g < ng) {
                float* dst = xs + (g % NX) * SLOT + lane;
                const float* src = xc + (size_t)g * SB * C;
#pragma unroll
                for (int r = 0; r < SB; ++r)
                    copy4_async(dst + r * G, src + (size_t)r * C);
            }
            copy_commit();
        };
        for (int g = 0; g < NX - 1; ++g) load(g);
        for (int g = 0; g < ng; ++g) {
            // the slot it refills was read in the previous iteration
            load(g + NX - 1);
            copy_wait<NX - 1>();  // this lane's rows of sub-block g are in
            const int ds = g % ND;
            bar_wait(d_empty + ds, ((g / ND) & 1) ^ 1);
            const float* xin = xs + (g % NX) * SLOT + lane;
            float* dout = db + ds * SLOT + lane;
#pragma unroll 4
            for (int r = 0; r < SB; ++r) {
                const float xt = xin[r * G];
                float y = xt;
                if (IIR) {
                    y = p.b0 * xt + z0;
                    z0 = p.b1 * xt + z1 - p.a1 * y;
                    z1 = p.b2 * xt + z2 - p.a2 * y;
                    z2 = p.b3 * xt + z3 - p.a3 * y;
                    z3 = p.b4 * xt - p.a4 * y;
                }
                const float xdb = p.k_db * log2f(fabsf(y + p.eps));
                dout[r * G] = fmaxf(xdb, p.floor_db);
            }
            bar_arrive(d_full + ds);
        }
        copy_wait<0>();
        if (IIR && active) {
            zi[c] = z0;
            zi[(size_t)C + c] = z1;
            zi[(size_t)2 * C + c] = z2;
            zi[(size_t)3 * C + c] = z3;
        }
    } else if (warp == 1) {
        // ---- fast and slow envelopes, linear relative envelope ----
        float yf = fast[cc], ys = slow[cc];
        const float hi = -p.floor_db;
        for (int g = 0; g < ng; ++g) {
            const int ds = g % ND;
            const int blk = g / nsb;
            const int j = g - blk * nsb;
            bar_wait(d_full + ds, (g / ND) & 1);
            bar_wait(r_empty + j, (blk & 1) ^ 1);
            const float* din = db + ds * SLOT + lane;
            float* rout = rel + j * SLOT + lane;
            float* gout = rel_out + (size_t)g * SB * C + c;
#pragma unroll 4
            for (int r = 0; r < SB; ++r) {
                const float xdb = din[r * G];
                const float df = xdb - yf + p.eps;
                yf = yf + (df > 0.f ? p.fa : p.fr) * df;
                const float dsl = xdb - ys + p.eps;
                ys = ys + (dsl > 0.f ? p.sa : p.sr) * dsl;
                const float d = yf - ys;
                float rr = exp2f(d * p.k_lin) - p.eps;
                rr = fminf(fmaxf(rr, 0.f), hi);
                rout[r * G] = rr;
                if (EMIT && active) gout[(size_t)r * C] = rr;
            }
            bar_arrive(d_empty + ds);
            bar_arrive(r_full + j);
        }
        if (active) {
            fast[c] = yf;
            slow[c] = ys;
        }
    } else {
        // ---- min/max, pass 2, backtracking, events ----
        float mn = mn_s[cc], mx = mx_s[cc];
        bool gate = gate_s[cc] != 0;
        float prev = prev_s[cc];
        float deb = (float)deb_s[cc];
        const float onp = on_p[cc], offp = off_p[cc];
        int pos = p.backtrack ? bt_pos_in[0] : 0;
        for (int g = 0; g < ng; ++g) {
            const int blk = g / nsb;
            const int j = g - blk * nsb;
            bar_wait(r_full + j, blk & 1);
            if (!MANUAL) {
                const float* rin = rel + j * SLOT + lane;
#pragma unroll 4
                for (int r = 0; r < SB; ++r) {
                    const float rr = rin[r * G];
                    mn = rr < p.minmin ? p.minmin
                                       : (rr < mn ? rr : mn * p.iam + rr * p.am);
                    mx = rr > mx ? rr : mx * p.iax + rr * p.ax;
                }
            }
            if (p.warmup) {  // warmup_minmax: envelopes and min/max only
                bar_arrive(r_empty + j);
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
                    bt[(size_t)((pos + t) % p.nbt) * C + c] =
                        rel[(t / SB) * SLOT + (t % SB) * G + lane];
            // one scan: the first on-crossing, and the off check both from
            // row 0 (no crossing) and from the crossing on
            int first = bsz;
            bool off_all = false, off_from = false;
            float pv = prev;
            for (int jj = 0; jj < nsb; ++jj) {
                const float* rb = rel + jj * SLOT + lane;
#pragma unroll 4
                for (int r = 0; r < SB; ++r) {
                    const float rr = rb[r * G];
                    const int t = jj * SB + r;
                    if (first == bsz && can_fire && rr > on_th && pv < on_th) {
                        first = t;
                        off_from = false;
                    }
                    const bool lo = rr < off_th;
                    off_all = off_all || lo;
                    off_from = off_from || lo;
                    pv = rr;
                }
                bar_arrive(r_empty + jj);
            }
            if (p.backtrack) pos = (pos + bsz) % p.nbt;
            const bool on = first < bsz;
            const int on_idx = on ? first : 0;
            gate = gate || on;
            if (on) deb = p.cooldown;
            if (deb > 0.f) deb = deb - (float)bsz;
            if (on ? off_from : off_all) gate = false;
            prev = pv;

            int delta = on_idx;
            if (p.backtrack && on && active) {
                // walk back while the EMA-smoothed envelope keeps
                // decreasing (detect/amplitude.py::_backtrack semantics,
                // one channel; detector.cu's walk)
                const int n = p.nbt;
                int i = bsz - on_idx;
                float cur = bt_row(bt, pos, n - i, n, C, c);
                i += 1;
                int r1 = n - i;
                if (r1 < 0) r1 += n;  // negative index wraps, as in numpy
                float prv = bt_row(bt, pos, r1, n, C, c);
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
                    prv = bt_row(bt, pos, r, n, C, c);
                    prevs = p.bt_alpha * prv + p.bt_omba * cur;
                }
            }
            if (active) {
                on_out[(size_t)blk * C + c] = on ? 1 : 0;
                delta_out[(size_t)blk * C + c] = delta;
            }
        }
        if (active) {
            mn_s[c] = mn;
            mx_s[c] = mx;
            gate_s[c] = gate ? 1 : 0;
            prev_s[c] = prev;
            deb_s[c] = (int32_t)deb;
        }
        if (p.backtrack && c == 0) bt_pos_out[0] = pos;
    }
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

template <bool IIR, bool MANUAL, bool EMIT>
static cudaError_t launch(const DetParams& p, size_t smem, cudaStream_t st,
                          const float* x, const float* on_p, const float* off_p,
                          float* zi, float* fast, float* slow, float* mn,
                          float* mx, uint8_t* gate, float* prev, int32_t* deb,
                          float* bt, const int32_t* bt_pos_in,
                          int32_t* bt_pos_out, uint8_t* on_out,
                          int32_t* delta_out, float* rel_out) {
    auto kern = detector_pipe_kernel<IIR, MANUAL, EMIT>;
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
    kern<<<(p.C + G - 1) / G, THREADS, smem, st>>>(
        p, x, on_p, off_p, zi, fast, slow, mn, mx, gate, prev, deb, bt,
        bt_pos_in, bt_pos_out, on_out, delta_out, rel_out);
    return cudaGetLastError();
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
    const int mode = (p.use_iir ? 4 : 0) | (p.manual ? 2 : 0) |
                     (p.emit_rel ? 1 : 0);
#define OFPT_PIPE_CASE(m, a, b, e)                                          \
    case m:                                                                 \
        return (int)launch<a, b, e>(p, smem, st, x, on_p, off_p, zi, fast,  \
                                    slow, mn, mx, gate, prev, deb, bt,      \
                                    bt_pos_in, bt_pos_out, on_out,          \
                                    delta_out, rel_out);
    switch (mode) {
        OFPT_PIPE_CASE(0, false, false, false)
        OFPT_PIPE_CASE(1, false, false, true)
        OFPT_PIPE_CASE(2, false, true, false)
        OFPT_PIPE_CASE(3, false, true, true)
        OFPT_PIPE_CASE(4, true, false, false)
        OFPT_PIPE_CASE(5, true, false, true)
        OFPT_PIPE_CASE(6, true, true, false)
        OFPT_PIPE_CASE(7, true, true, true)
    }
#undef OFPT_PIPE_CASE
    return (int)cudaErrorInvalidValue;
}
