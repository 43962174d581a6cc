// Fused streaming amplitude onset detector (K1) for Hopper, sm_90a.
//
// Replaces onset_fingerprinting_tpu/ops/pallas_detector.py:_detector_kernel
// (the Pallas body launched by pallas_detect_offline / make_pallas_detector).
// Per sample: 4th-order DF2T high-pass -> rectified floor-clipped dB (log2
// form) -> fast and slow attack/release envelopes -> relative envelope
// (exp2 back to linear, clipped) -> EMA min/max.  Per block of `bsz`
// samples: adaptive on/off thresholds, hysteresis gate, cooldown, first
// on-crossing row, optional backtracking walk.  All state is carried, so
// one launch runs a whole chunk [T, C] and leaves the state for the next.
//
// What bounds it on the H100: the time recurrences are sequential, so the
// only parallelism is across channels -- one thread per channel, at most
// C threads on the whole card (32768 at the fleet width: ~8 warps per SM).
// Each sample is read once (4 B per channel-sample, 4.19 GB per fleet
// chunk, ~1.25 ms at 3.35 TB/s), and each thread then runs about 54 float
// operations per sample, mostly in dependent chains, two of them accurate
// transcendentals (log2f, exp2f).  With so few warps the kernel is latency
// bound.
//
// What the design does about it: x [T, C] is row-major, so a warp's load
// of one sample row is 128 contiguous bytes.  Each block is first copied
// into a per-thread column of shared memory with independent loads (many
// in flight per thread), then the recurrences run as separate loops over
// the staged block -- the IIR chain, the dB conversion, the envelope
// chain, the linear conversion, the min/max chain -- so that the
// transcendentals of neighbouring samples are independent work instead of
// part of one long dependency chain (the Pallas kernel's loop split,
// pallas_detector.py:151-238).  Pass 2 (thresholds use the min/max after
// the whole block) reads the same staged column.  Where the staged block
// does not fit shared memory (coupled_off: every channel in one CTA), a
// device scratch column takes its place through the same pointer.
//
// Numerics: compiled with -fmad=false, so every multiply and add rounds on
// its own exactly as the element-wise plain PyTorch version does, and
// log2f/exp2f are the accurate library functions (no fast math).  The
// kernel is then bit-identical to onset_fingerprinting_torch's plain
// detect_offline on the card.  The debounce counter is float inside the
// kernel and int32 in the state (pallas_detector.py:304-305, 593).

#include <cuda_runtime.h>
#include <stdint.h>

// Field order and types must match ops/fused_detector.py::_DetParams
// (all 4-byte fields, no padding).
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

__device__ __forceinline__ float bt_row(const float* bt, int pos, int r,
                                        int nbt, int C, int c) {
    return bt[(size_t)((pos + r) % nbt) * C + c];
}

__global__ void detector_kernel(
    DetParams p, const float* __restrict__ x, const float* __restrict__ on_p,
    const float* __restrict__ off_p, float* zi, float* fast, float* slow,
    float* mn_s, float* mx_s, uint8_t* gate_s, float* prev_s, int32_t* deb_s,
    float* bt, const int32_t* bt_pos_in, int32_t* bt_pos_out,
    uint8_t* on_out, int32_t* delta_out, float* rel_out, float* gscratch) {
    extern __shared__ float smem[];
    __shared__ int blk_max;
    const int C = p.C;
    const int bsz = p.bsz;
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = c < C;
    // Only the coupled path synchronises; elsewhere idle threads leave.
    if (!active && !p.coupled) return;
    const int cc = active ? c : 0;  // idle threads read channel 0, store nothing
    float* buf;
    int bs;
    if (gscratch) {
        buf = gscratch + c;
        bs = gridDim.x * blockDim.x;
    } else {
        buf = smem + threadIdx.x;
        bs = blockDim.x;
    }

    float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
    if (p.use_iir) {
        z0 = zi[cc];
        z1 = zi[(size_t)C + cc];
        z2 = zi[(size_t)2 * C + cc];
        z3 = zi[(size_t)3 * C + cc];
    }
    float yf = fast[cc], ys = slow[cc], mn = mn_s[cc], mx = mx_s[cc];
    bool gate = gate_s[cc] != 0;
    float prev = prev_s[cc];
    float deb = (float)deb_s[cc];
    const float onp = on_p[cc], offp = off_p[cc];
    int pos = p.backtrack ? bt_pos_in[0] : 0;
    const float hi = -p.floor_db;
    const int nb = p.T / bsz;

    for (int blk = 0; blk < nb; ++blk) {
        const float* xb = x + (size_t)blk * bsz * C + cc;
        // stage the block: independent loads, many in flight per thread
#pragma unroll 8
        for (int t = 0; t < bsz; ++t) buf[t * bs] = xb[(size_t)t * C];
        // loop A: DF2T high-pass (the only chain in this stage)
        if (p.use_iir) {
            for (int t = 0; t < bsz; ++t) {
                const float xt = buf[t * bs];
                const float y = p.b0 * xt + z0;
                z0 = p.b1 * xt + z1 - p.a1 * y;
                z1 = p.b2 * xt + z2 - p.a2 * y;
                z2 = p.b3 * xt + z3 - p.a3 * y;
                z3 = p.b4 * xt - p.a4 * y;
                buf[t * bs] = y;
            }
        }
        // rectified, floor-clipped dB: independent across samples
#pragma unroll 4
        for (int t = 0; t < bsz; ++t) {
            const float xdb = p.k_db * log2f(fabsf(buf[t * bs] + p.eps));
            buf[t * bs] = fmaxf(xdb, p.floor_db);
        }
        // loop B: fast and slow envelopes; keep their dB difference
        for (int t = 0; t < bsz; ++t) {
            const float xdb = buf[t * bs];
            const float df = xdb - yf + p.eps;
            yf = yf + (df > 0.f ? p.fa : p.fr) * df;
            const float ds = xdb - ys + p.eps;
            ys = ys + (ds > 0.f ? p.sa : p.sr) * ds;
            buf[t * bs] = yf - ys;
        }
        // dB difference -> clipped linear relative envelope
#pragma unroll 4
        for (int t = 0; t < bsz; ++t) {
            float r = exp2f(buf[t * bs] * p.k_lin) - p.eps;
            r = fminf(fmaxf(r, 0.f), hi);
            buf[t * bs] = r;
            if (p.emit_rel && active)
                rel_out[(size_t)(blk * bsz + t) * C + c] = r;
        }
        // loop C: EMA min/max tracker
        if (!p.manual) {
            for (int t = 0; t < bsz; ++t) {
                const float r = buf[t * bs];
                mn = r < p.minmin ? p.minmin
                                  : (r < mn ? r : mn * p.iam + r * p.am);
                mx = r > mx ? r : mx * p.iax + r * p.ax;
            }
        }
        if (p.warmup) continue;  // warmup_minmax: envelopes and min/max only

        // backtracking history: ring of the last nbt rel samples
        if (p.backtrack) {
            if (active)
                for (int t = 0; t < bsz; ++t)
                    bt[(size_t)((pos + t) % p.nbt) * C + c] = buf[t * bs];
            pos = (pos + bsz) % p.nbt;
        }

        // ---- pass 2: block-level hysteresis ----
        float on_th, off_th;
        if (p.manual) {
            on_th = onp;
            off_th = offp;
        } else {
            on_th = mx * onp + mn;
            off_th = mx * offp + mn;
        }
        const bool can_fire = !gate && deb < 1.f;
        int first = bsz;
        float pv = prev;
        for (int t = 0; t < bsz; ++t) {
            const float r = buf[t * bs];
            if (first == bsz && can_fire && r > on_th && pv < on_th) first = t;
            pv = r;
        }
        const bool on = first < bsz;
        const int on_idx = on ? first : 0;
        gate = gate || on;
        if (on) deb = p.cooldown;
        if (deb > 0.f) deb = deb - (float)bsz;

        int off_from = on_idx;
        if (p.coupled) {
            // reference quirk (detection.py:790): the off check starts at
            // the block's largest first-onset row across ALL channels
            __syncthreads();
            if (threadIdx.x == 0) blk_max = 0;
            __syncthreads();
            if (active) atomicMax(&blk_max, on_idx);
            __syncthreads();
            off_from = blk_max;
        }
        bool off_any = false;
        for (int t = off_from; t < bsz; ++t)
            if (buf[t * bs] < off_th) off_any = true;
        if (off_any) gate = false;
        prev = buf[(bsz - 1) * bs];

        int delta = on_idx;
        if (p.backtrack && on && active) {
            // walk back while the EMA-smoothed envelope keeps decreasing
            // (detect/amplitude.py::_backtrack semantics, one channel)
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
                                (fabsf(prevs - prv) > p.bt_tol) && (i + 1 < n);
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
        if (p.use_iir) {
            zi[c] = z0;
            zi[(size_t)C + c] = z1;
            zi[(size_t)2 * C + c] = z2;
            zi[(size_t)3 * C + c] = z3;
        }
        fast[c] = yf;
        slow[c] = ys;
        mn_s[c] = mn;
        mx_s[c] = mx;
        gate_s[c] = gate ? 1 : 0;
        prev_s[c] = prev;
        deb_s[c] = (int32_t)deb;
    }
    if (p.backtrack && c == 0) bt_pos_out[0] = pos;
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// One launch over a whole chunk.  The state buffers are updated in place
// (fresh copies, or the caller's `out`; bt_pos_in is never bt_pos_out,
// since other CTAs may still read it).  `gscratch` (nullable) is a
// [bsz, grid * threads] device buffer that replaces the shared-memory
// block stage when that would not fit.
extern "C" int ofpt_detect(const DetParams* hp, const float* x,
                           const float* on_p, const float* off_p, float* zi,
                           float* fast, float* slow, float* mn, float* mx,
                           uint8_t* gate, float* prev, int32_t* deb, float* bt,
                           const int32_t* bt_pos_in, int32_t* bt_pos_out,
                           uint8_t* on_out, int32_t* delta_out, float* rel_out,
                           float* gscratch, int threads, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const DetParams p = *hp;
    const int blocks = p.coupled ? 1 : (p.C + threads - 1) / threads;
    const size_t smem = gscratch ? 0 : (size_t)p.bsz * threads * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            detector_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    detector_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        p, x, on_p, off_p, zi, fast, slow, mn, mx, gate, prev, deb, bt,
        bt_pos_in, bt_pos_out, on_out, delta_out, rel_out, gscratch);
    return (int)cudaGetLastError();
}

// An empty kernel launched through the same path: the launch floor that
// decides K1's time at the realtime engine's shape ([128, 3] per launch).
__global__ void empty_kernel() {}

extern "C" int ofpt_empty(void* stream) {
    cudaGetLastError();
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
