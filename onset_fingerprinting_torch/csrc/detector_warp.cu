// Fused streaming amplitude onset detector (K1) in the coupled mode, for
// Hopper, sm_90a: one CTA per detector, one warp per channel (C <= 32).
//
// Replaces onset_fingerprinting_tpu/ops/pallas_detector.py:_detector_kernel
// (:85, launched at :520) with coupled_off=True, the kernel the JAX
// realtime engine's step runs: per sample a 4th-order DF2T high-pass ->
// rectified floor-clipped dB (log2 form) -> fast and slow attack/release
// envelopes -> relative envelope (exp2 back to linear, clipped) -> EMA
// min/max; per block of `bsz` samples adaptive on/off thresholds,
// hysteresis gate, cooldown, the first on-crossing row, the off-check
// coupled across channels, optional backtracking.  All state is carried.
//
// What bounds it on the H100: at the engine's shape, [128, 3] per launch,
// nothing but latency: 1.5 KB in, a few hundred bytes of state, ~50 K
// float operations.  The one-thread-per-channel kernel (detector.cu) runs
// every pass of the block on 3 threads one sample after another: 128
// dependent loads at a stride of C, 128 accurate log2f and 128 exp2f in a
// row, then the compare loops, and three barriers for the coupled max.
//
// What this design does about it:
// - All threads stage each [bsz, C] block in one coalesced pass into shared
//   memory, transposed to one column per channel (cp.async, 4 bytes each);
//   a multi-block call (the warmup) prefetches the next block into a second
//   stage while the current one computes.
// - The element-wise passes run across the warp's lanes: the dB conversion
//   (log2f), the linear relative envelope (exp2f, clip), the on-threshold
//   crossing (a ballot, then __ffs for the first row) and the off-check from
//   the coupled row (__any_sync): the Pallas kernel's db/rel/on/off chunk
//   split (pallas_detector.py:188-238, 278-320).
// - The true recurrences (the IIR, the fast and slow envelopes, the EMA
//   min/max) stay on lane 0, in the plain version's order, reading and
//   writing the staged column, with __syncwarp between passes.
// - The coupled off-check's row is the block's largest first-onset row
//   across all channels (pallas_detector.py:307-309): one slot per warp in
//   shared memory, one barrier, one __reduce_max_sync.
// State is updated in place: each warp reads its channel's state before the
// first barrier and lane 0 writes it back after the last, and every thread
// reads bt_pos before the first barrier, so the wrapper may pass the same
// buffers as input and output.
//
// Numerics: compiled with -fmad=false, so every multiply and add rounds on
// its own as the element-wise plain PyTorch version does, and log2f/exp2f
// are the accurate library functions: bit-identical to
// onset_fingerprinting_torch's plain detect_offline, as detector.cu is.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CH 32
#define FULL 0xffffffffu

// Field order and types must match ops/fused_detector.py::_DetParams
// (all 4-byte fields, no padding); the same block as detector.cu's.
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// block `blk` of x [T, C] into cols [C][ld], all threads, asynchronously
__device__ __forceinline__ void stage(float* cols, const float* x, int blk,
                                      int bsz, int C, int ld) {
    const float* xb = x + (size_t)blk * bsz * C;
    const int n = bsz * C;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int t = i / C;
        cp_async4(cols + (i - t * C) * ld + t, xb + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float bt_row(const float* bt, int pos, int r,
                                        int nbt, int C, int c) {
    return bt[(size_t)((pos + r) % nbt) * C + c];
}

__global__ void __launch_bounds__(32 * MAX_CH) detector_warp_kernel(
    DetParams p, const float* __restrict__ x, const float* __restrict__ on_p,
    const float* __restrict__ off_p, float* zi, float* fast, float* slow,
    float* mn_s, float* mx_s, uint8_t* gate_s, float* prev_s, int32_t* deb_s,
    float* bt, const int32_t* bt_pos_in, int32_t* bt_pos_out,
    uint8_t* on_out, int32_t* delta_out, float* rel_out) {
    extern __shared__ float smem[];  // two stages of [C][bsz + 1]
    __shared__ int blk_on[MAX_CH];
    const int C = p.C, bsz = p.bsz, ld = bsz + 1;
    const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
    const int nb = p.T / bsz;
    if (blockIdx.x > 0) {
        // a batch of streams (ofpt_detect_warp_streams): CTA s runs stream
        // s, its chunk, state and outputs stream-major; the thresholds are
        // shared
        const size_t s = blockIdx.x;
        x += s * p.T * C;
        if (zi) zi += s * 4 * C;
        fast += s * C;
        slow += s * C;
        mn_s += s * C;
        mx_s += s * C;
        gate_s += s * C;
        prev_s += s * C;
        deb_s += s * C;
        if (bt) bt += s * p.nbt * C;
        bt_pos_in += s;
        bt_pos_out += s;
        if (on_out) on_out += s * nb * C;
        if (delta_out) delta_out += s * nb * C;
        if (rel_out) rel_out += s * p.T * C;
    }

    // everything read here precedes the first barrier: the writes after the
    // last one may go to the same buffers
    int pos = bt_pos_in[0];
    float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
    if (p.use_iir) {
        z0 = zi[c];
        z1 = zi[C + c];
        z2 = zi[2 * C + c];
        z3 = zi[3 * C + c];
    }
    float yf = fast[c], ys = slow[c], mn = mn_s[c], mx = mx_s[c];
    bool gate = gate_s[c] != 0;
    float prev = prev_s[c];
    float deb = (float)deb_s[c];
    const float onp = on_p[c], offp = off_p[c];
    const float hi = -p.floor_db;

    if (nb > 0) stage(smem, x, 0, bsz, C, ld);
    for (int blk = 0; blk < nb; ++blk) {
        float* col = smem + (blk & 1) * C * ld + c * ld;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        // block blk is staged, and every warp is done with the other stage
        // and with blk_on
        __syncthreads();
        if (blk + 1 < nb)
            stage(smem + ((blk + 1) & 1) * C * ld, x, blk + 1, bsz, C, ld);
        // DF2T high-pass: a chain, on lane 0
        if (p.use_iir) {
            if (lane == 0) {
#pragma unroll 8
                for (int t = 0; t < bsz; ++t) {
                    const float xt = col[t];
                    const float y = p.b0 * xt + z0;
                    z0 = p.b1 * xt + z1 - p.a1 * y;
                    z1 = p.b2 * xt + z2 - p.a2 * y;
                    z2 = p.b3 * xt + z3 - p.a3 * y;
                    z3 = p.b4 * xt - p.a4 * y;
                    col[t] = y;
                }
            }
            __syncwarp();
        }
        // rectified, floor-clipped dB: across the lanes
        for (int t = lane; t < bsz; t += 32) {
            const float xdb = p.k_db * log2f(fabsf(col[t] + p.eps));
            col[t] = fmaxf(xdb, p.floor_db);
        }
        __syncwarp();
        // fast and slow envelopes, their dB difference: a chain, on lane 0
        // (unrolled, so that the column's loads run ahead of the chain)
        if (lane == 0) {
#pragma unroll 8
            for (int t = 0; t < bsz; ++t) {
                const float xdb = col[t];
                const float df = xdb - yf + p.eps;
                yf = yf + (df > 0.f ? p.fa : p.fr) * df;
                const float ds = xdb - ys + p.eps;
                ys = ys + (ds > 0.f ? p.sa : p.sr) * ds;
                col[t] = yf - ys;
            }
        }
        __syncwarp();
        // dB difference -> clipped linear relative envelope: across the lanes
        for (int t = lane; t < bsz; t += 32) {
            float r = exp2f(col[t] * p.k_lin) - p.eps;
            r = fminf(fmaxf(r, 0.f), hi);
            col[t] = r;
            if (p.emit_rel) rel_out[(size_t)(blk * bsz + t) * C + c] = r;
        }
        __syncwarp();
        // EMA min/max tracker: a chain, on lane 0, then to every lane
        if (!p.manual) {
            if (lane == 0) {
#pragma unroll 8
                for (int t = 0; t < bsz; ++t) {
                    const float r = col[t];
                    mn = r < p.minmin ? p.minmin
                                      : (r < mn ? r : mn * p.iam + r * p.am);
                    mx = r > mx ? r : mx * p.iax + r * p.ax;
                }
            }
            mn = __shfl_sync(FULL, mn, 0);
            mx = __shfl_sync(FULL, mx, 0);
        }
        if (p.warmup) continue;  // warmup_minmax: envelopes and min/max only

        // backtracking history: ring of the last nbt rel samples
        if (p.backtrack) {
            for (int t = lane; t < bsz; t += 32)
                bt[(size_t)((pos + t) % p.nbt) * C + c] = col[t];
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
        int first = bsz;
        if (!gate && deb < 1.f) {
            for (int base = 0; base < bsz; base += 32) {
                const int t = base + lane;
                bool hit = false;
                if (t < bsz) {
                    const float pv = t == 0 ? prev : col[t - 1];
                    hit = col[t] > on_th && pv < on_th;
                }
                const unsigned b = __ballot_sync(FULL, hit);
                if (b) {
                    first = base + __ffs(b) - 1;
                    break;
                }
            }
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
            if (lane == 0) blk_on[c] = on_idx;
            __syncthreads();
            off_from = __reduce_max_sync(FULL, lane < C ? blk_on[lane] : 0);
        }
        bool off_hit = false;
        for (int t = off_from + lane; t < bsz; t += 32)
            off_hit = off_hit || col[t] < off_th;
        if (__any_sync(FULL, off_hit)) gate = false;
        prev = col[bsz - 1];

        int delta = on_idx;
        if (p.backtrack && on) {
            __syncwarp();  // the lanes' history writes, for lane 0
            if (lane == 0) {
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
        }
        if (lane == 0) {
            on_out[(size_t)blk * C + c] = on ? 1 : 0;
            delta_out[(size_t)blk * C + c] = delta;
        }
    }

    __syncthreads();  // every read of the state above precedes these writes
    if (lane == 0) {
        if (p.use_iir) {
            zi[c] = z0;
            zi[C + c] = z1;
            zi[2 * C + c] = z2;
            zi[3 * C + c] = z3;
        }
        fast[c] = yf;
        slow[c] = ys;
        mn_s[c] = mn;
        mx_s[c] = mx;
        gate_s[c] = gate ? 1 : 0;
        prev_s[c] = prev;
        deb_s[c] = (int32_t)deb;
    }
    if (threadIdx.x == 0) bt_pos_out[0] = pos;
}

extern "C" const char* ofpt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// One launch over a whole chunk x [T, C] of each of `n_streams` streams
// (x [S, T, C], the state and outputs with a leading stream axis), C <= 32,
// one CTA of 32 * C threads per stream.  The state buffers are updated in
// place (bt_pos_in may be bt_pos_out).
extern "C" int ofpt_detect_warp_streams(
    const DetParams* hp, int n_streams, const float* x, const float* on_p,
    const float* off_p, float* zi, float* fast, float* slow, float* mn,
    float* mx, uint8_t* gate, float* prev, int32_t* deb, float* bt,
    const int32_t* bt_pos_in, int32_t* bt_pos_out, uint8_t* on_out,
    int32_t* delta_out, float* rel_out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const DetParams p = *hp;
    if (p.C < 1 || p.C > MAX_CH || p.bsz < 1 || n_streams < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)2 * p.C * (p.bsz + 1) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            detector_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    detector_warp_kernel<<<n_streams, 32 * p.C, smem, (cudaStream_t)stream>>>(
        p, x, on_p, off_p, zi, fast, slow, mn, mx, gate, prev, deb, bt,
        bt_pos_in, bt_pos_out, on_out, delta_out, rel_out);
    return (int)cudaGetLastError();
}

// One launch over a whole chunk x [T, C], C <= 32, on one CTA of 32 * C
// threads.  The state buffers are updated in place (bt_pos_in may be
// bt_pos_out).
extern "C" int ofpt_detect_warp(const DetParams* hp, const float* x,
                                const float* on_p, const float* off_p,
                                float* zi, float* fast, float* slow, float* mn,
                                float* mx, uint8_t* gate, float* prev,
                                int32_t* deb, float* bt,
                                const int32_t* bt_pos_in, int32_t* bt_pos_out,
                                uint8_t* on_out, int32_t* delta_out,
                                float* rel_out, void* stream) {
    cudaGetLastError();  // clear an error left by earlier, unrelated work
    const DetParams p = *hp;
    if (p.C < 1 || p.C > MAX_CH || p.bsz < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)2 * p.C * (p.bsz + 1) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            detector_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    detector_warp_kernel<<<1, 32 * p.C, smem, (cudaStream_t)stream>>>(
        p, x, on_p, off_p, zi, fast, slow, mn, mx, gate, prev, deb, bt,
        bt_pos_in, bt_pos_out, on_out, delta_out, rel_out);
    return (int)cudaGetLastError();
}
