"""Where K3's float32 kernel (``csrc/conv_stack.cu``) spends its time on the
card, at the fleet shape: the flagship stack (1 -> 5 x 7 features, kernels
1, 33, 64, 15, 15, 15, 1, padding 1, SiLU) on B = 131072 signals of
L = 256.

Each variant is a patched copy of the kernel's source, written to the build
directory at run time (the source in the package stays as it is), launched
through the package's own wrapper and timed by CUDA events over
``--launches`` launches:

- ``whole``: the kernel as it is;
- ``fma_only``: every activation load from shared memory (and its
  skewed address) replaced by a value made in registers (the FMAs and the
  weight loads stay);
- ``no_weight_loads``: the weights' shared-memory loads replaced by
  values made in registers; ``no_loads``: both kinds of load replaced;
- ``wps2``: two warps (64 lanes) per signal, so 32 warps per SM at 64
  registers a thread, lane tiles of 5, 4 and 3 positions for the
  flagship's layers (a design tried and not taken);
- ``unroll_i2``: the input-feature loop unrolled by two;
- ``loads_only``: each tap's ``TT x OW`` FMAs replaced by ``TT`` pairs of
  adds that keep its activation and weight loads live;
- ``layer_N``: only layer N computes (the others are skipped), and
  ``no_layers``: none does (x loaded, the output written), so each
  layer's time is ``layer_N - no_layers``, set against its FLOPs.

With ``--parent DIR`` (an unpacked earlier tree of this repository) it also
builds that tree's ``conv_stack.cu`` and launches it through that tree's
wrapper, and times parent, kernel, kernel, parent in turn.

With ``--cluster`` it splits K3's bf16 cluster kernel
(``csrc/conv_stack_mma_cluster.cu``) instead, at the realtime classifier's
shape (the flagship, B = 48 signals of L = 512), per call in a graph of 16
calls (``tools/step_bench.graph_ms``): the kernel with clusters of 8 and
of 16 CTAs (bit for bit against ``conv_stack_mma.cu`` first), in turns
with ``conv_stack_mma.cu`` (cluster, tensor-core, tensor-core, cluster),
and its patched variants:

- ``no_mma``: the products stubbed (the window and pair-table loads and
  the epilogue stay);
- ``exchange_only``: the units' product loops removed: the epilogues,
  the halo exchange and the cluster barriers;
- ``no_exchange``: the halo pull skipped (the windows read stale rows);
- ``barriers_only``: every warp unit and the pull skipped: the launch,
  the staging of x and the weights, the zero rows and one cluster
  barrier per layer, the kernel's floor;
- ``empty``: a kernel that returns at once, on the same grid, cluster
  shape and shared memory: the launch;
- ``stamps_unit``: the kernel with each CTA's thread 0 reading its SM's
  clock at the start, after the staging, and after each layer's units,
  the cluster barrier's arrival with the zero rows, its wait and the
  halo's pull, and lane 0's inside warp 0's units (written over the
  output in place of it), so each phase's cycles per CTA (median and
  largest over the CTAs of a call) are read apart; ``stamps_staging``
  splits the staging the same way;

then both kernels in turns (the cluster kernel on the route's cluster
size) at B = 48, 96, 112, 128, 224, 480, 1056, 2112 and 4224 on L = 256
and 512, the crossover that sets ``ops/conv_stack.CLUSTER_MAX_CTAS``.
Run on the card from the repository root:

    python -m onset_fingerprinting_torch.tools.conv_stack_split
    python -m onset_fingerprinting_torch.tools.conv_stack_split --parent DIR
    python -m onset_fingerprinting_torch.tools.conv_stack_split --cluster

It prints one JSON line last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from onset_fingerprinting_torch.ops import _cuda

#: the fleet shape: windows of 256 samples, 4 channels x 32768 hits
BATCH = 131072
LENGTH = 256
#: f32 FMA-unit peak of the H100 SXM (NVIDIA data sheet, 700 W), FLOP/s
F32_FLOPS = 67e12

#: the cluster kernel's shape (the realtime classifier: 3 channels x 16
#: hits of 512 samples), the calls of one graph, and the crossover's
#: batches and lengths
CLUSTER_BATCH = 48
CLUSTER_LENGTH = 512
GRAPH_CALLS = 16
CROSS_BATCHES = (48, 96, 112, 128, 224, 480, 1056, 2112, 4224)
CROSS_LENGTHS = (256, 512)

_ARRIVE = 'asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");'
_ARRIVE_RELAXED = ('asm volatile("barrier.cluster.arrive.relaxed.aligned;'
                   '\\n" ::: "memory");')

#: the clock stamps of the ``stamps_*`` variants: each CTA's thread 0 at
#: the start, after the staging, and after each layer's units, the
#: cluster barrier's arrival with the zero rows, its wait and the pull
_STAMPS = [
    ("__global__ void __launch_bounds__(THREADS, 1)\n",
     "__device__ __forceinline__ long long stamp() {\n"
     "    long long t;\n"
     "    asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: "
     "\"memory\");\n    return t;\n}\n\n"
     "__global__ void __launch_bounds__(THREADS, 1)\n"),
    ("    const int b0 = (blockIdx.x / d.ctas) * NS;\n",
     "    const int b0 = (blockIdx.x / d.ctas) * NS;\n"
     "    long long ts[4 * MAX_LAYERS + 2];\n    int nts = 0;\n"
     "    ts[nts++] = stamp();\n"),
    ("    __syncthreads();\n\n    for (int l = 0;",
     "    __syncthreads();\n    ts[nts++] = stamp();\n\n"
     "    for (int l = 0;"),
    ("        if (l == 0) cp_async_wait<0>();",
     "        ts[nts++] = stamp();\n        if (l == 0) cp_async_wait<0>();"),
    ("        cluster_wait();\n        pull(",
     "        ts[nts++] = stamp();\n        cluster_wait();\n"
     "        ts[nts++] = stamp();\n        pull("),
    ("        if (l + 2 == n_layers) cluster_arrive();  // this CTA's last "
     "pull\n        __syncthreads();\n",
     "        if (l + 2 == n_layers) cluster_arrive();  // this CTA's last "
     "pull\n        __syncthreads();\n        ts[nts++] = stamp();\n"),
    ("    // the last layer's positions of this CTA's range, from its own "
     "buffer\n",
     "    if (tid == 0)\n        for (int i = 0; i < nts; ++i)\n"
     "            reinterpret_cast<long long*>(out)[blockIdx.x * 128 + i] ="
     "\n                ts[i] - ts[0];\n"
     "    if (n_layers > 1) cluster_wait();\n    return;\n"
     "    // the last layer's positions of this CTA's range, from its own "
     "buffer\n"),
]

#: the cluster kernel's variants: (name, [(anchor, replacement), ...])
CLUSTER_VARIANTS = (
    ("no_mma", [("                                         uint32_t b0, "
                 "uint32_t b1) {\n",
                 "                                         uint32_t b0, "
                 "uint32_t b1) {\n    return;\n")]),
    ("exchange_only", [("    for (int i = 0; i < I; ++i) {\n"
                        "        const uint32_t ti",
                        "    for (int i = 0; i < I && S < 0; ++i) {\n"
                        "        const uint32_t ti")]),
    ("no_exchange", [("        pull(ly, n_ctas, l, rank,",
                      "        if (d.B < 0) pull(ly, n_ctas, l, rank,")]),
    ("barriers_only", [("        for (int u = warp; u < (q1 - q0) * n_fg;",
                        "        for (int u = warp; d.B < 0 && u < (q1 - q0) "
                        "* n_fg;"),
                       ("        pull(ly, n_ctas, l, rank,",
                        "        if (d.B < 0) pull(ly, n_ctas, l, rank,")]),
    ("stamps_unit", None),
    # the staging's parts: thread 0's clock after the cp.async issue, the
    # table, the rows of x, the biases and the wait
    ("stamps_staging", [
        ("__global__ void __launch_bounds__(THREADS, 1)\n",
         "__device__ __forceinline__ long long stamp() {\n"
         "    long long t;\n"
         "    asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: "
         "\"memory\");\n    return t;\n}\n\n"
         "__global__ void __launch_bounds__(THREADS, 1)\n"),
        ("    const int b0 = (blockIdx.x / d.ctas) * NS;\n",
         "    const int b0 = (blockIdx.x / d.ctas) * NS;\n"
         "    long long ts[8];\n    ts[0] = stamp();\n"),
        ("    cp_async_commit();\n    const float bv",
         "    cp_async_commit();\n    ts[1] = stamp();\n    const float bv"),
        ("    // layer 0's window rows of x, zero outside [0, L)\n",
         "    ts[2] = stamp();\n"
         "    // layer 0's window rows of x, zero outside [0, L)\n"),
        ("    if (tid < d.bias_words) bsm[tid] = bv;\n",
         "    ts[3] = stamp();\n    if (tid < d.bias_words) bsm[tid] = bv;\n"),
        ("    cp_async_wait<1>();  // layer 0's tables\n    __syncthreads();\n",
         "    ts[4] = stamp();\n"
         "    cp_async_wait<1>();  // layer 0's tables\n    __syncthreads();\n"
         "    ts[5] = stamp();\n"
         "    if (tid == 0)\n        for (int i = 0; i < 6; ++i)\n"
         "            reinterpret_cast<long long*>(out)[blockIdx.x * 128 + i] ="
         "\n                ts[i] - ts[0];\n    return;\n"),
    ]),
    # the barrier's arrival without its release (MEMBAR.ALL.GPU in SASS):
    # racy, for timing only
    ("arrive_relaxed", [(_ARRIVE, _ARRIVE_RELAXED)]),
    ("empty", [("    extern __shared__ __align__(16) unsigned char smem[];\n"
                "    __shared__ Layers ly;\n",
                "    if (d.B > 0) return;\n"
                "    extern __shared__ __align__(16) unsigned char smem[];\n"
                "    __shared__ Layers ly;\n")]),
)

#: ``stamps_unit``: ``stamps`` and, in warp 0's last unit of each layer,
#: lane 0's clock at the unit's start, after the products (the bias add
#: waits for them) and after its epilogue, written after the kernel's
#: stamps
_UNIT_STAMPS = [
    ("template <int OG>\n__device__ void mma_task(",
     "__shared__ long long ofpt_dbg[4 * MAX_LAYERS];\n"
     "__shared__ int ofpt_dbg_l;\n"
     "__device__ __forceinline__ long long ustamp() {\n"
     "    long long t;\n"
     "    asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: "
     "\"memory\");\n    return t;\n}\n"
     "template <int OG>\n__device__ void mma_task("),
    ("    float acc[2][OG][2][4];\n",
     "    float acc[2][OG][2][4];\n    const long long t_a = ustamp();\n"),
    ("    // one loop per activation: only the one that runs is fetched\n"
     "    switch (act) {",
     "    const long long t_b = ustamp();\n    switch (act) {"),
    ("                         \"r\"(*reinterpret_cast<const uint32_t*>(&v))\n"
     "                         : \"memory\");\n        }\n    }\n}\n",
     "                         \"r\"(*reinterpret_cast<const uint32_t*>(&v))\n"
     "                         : \"memory\");\n        }\n    }\n"
     "    if (threadIdx.x == 0) {\n"
     "        long long* r = ofpt_dbg + 4 * ofpt_dbg_l;\n"
     "        r[0] = t_a; r[1] = t_b; r[2] = ustamp();\n    }\n}\n"),
    ("        const int fg = ly.fg[l], n_fg = (O + fg - 1) / fg;\n",
     "        const int fg = ly.fg[l], n_fg = (O + fg - 1) / fg;\n"
     "        if (tid == 0) ofpt_dbg_l = l;\n"),
    ("                ts[i] - ts[0];\n",
     "                ts[i] - ts[0];\n"
     "    if (tid == 0)\n        for (int i = 0; i < 4 * n_layers; ++i)\n"
     "            reinterpret_cast<long long*>(out)[blockIdx.x * 128 + 40 + i]"
     " =\n                ofpt_dbg[i] - ts[0];\n"),
]

#: (name, [(anchor, replacement), ...], extra nvcc flags)
VARIANTS = (
    ("fma_only", [
        ("    return to_f32<S>(col[skew(r)]);", "    return __int_as_float(r);"),
    ], ()),
    ("no_weight_loads", [
        ("    const float4 a = *reinterpret_cast<const float4*>(p);",
         "    const float4 a = make_float4(__int_as_float((int)(size_t)p), "
         "1.f, 2.f, 3.f);"),
        ("        const float4 b = *reinterpret_cast<const float4*>(p + 4);",
         "        const float4 b = make_float4(4.f, 5.f, 6.f, 7.f);"),
    ], ()),
    ("no_loads", [
        ("    return to_f32<S>(col[skew(r)]);", "    return __int_as_float(r);"),
        ("    const float4 a = *reinterpret_cast<const float4*>(p);",
         "    const float4 a = make_float4(__int_as_float((int)(size_t)p), "
         "1.f, 2.f, 3.f);"),
        ("        const float4 b = *reinterpret_cast<const float4*>(p + 4);",
         "        const float4 b = make_float4(4.f, 5.f, 6.f, 7.f);"),
    ], ()),
    # two warps (64 lanes) per signal, 32 warps per SM at 64 registers a
    # thread, smaller lane tiles for the flagship's layers
    ("wps2", [
        ("u < n_chunks * n_og; u += 32)", "u < n_chunks * n_og; u += 64)"),
        ("        OFPT_TT(5) OFPT_TT(6) OFPT_TT(8)",
         "        OFPT_TT(3) OFPT_TT(4) OFPT_TT(5)"),
        ("    switch (d.TT[l] * 16 + d.OW[l]) {",
         "    switch ((l == 0 ? 5 : l == 1 ? 4 : 3) * 16 + d.OW[l]) {"),
        ("__launch_bounds__(512, 1)", "__launch_bounds__(512, 2)"),
        ("threadIdx.x & 31, warp = threadIdx.x >> 5;",
         "threadIdx.x & 63, warp = threadIdx.x >> 6;"),
        ("    for (size_t e = lane; e < 2 * feat_elems; e += 32)",
         "    for (size_t e = lane; e < 2 * feat_elems; e += 64)"),
        ("        cur[e] = from_f32<S>(0.f);\n    __syncwarp();",
         "        cur[e] = from_f32<S>(0.f);\n    __syncthreads();"),
        ("for (int t = lane; t < d.L; t += 32)",
         "for (int t = lane; t < d.L; t += 64)"),
        ("            __syncwarp();\n            run_layer<S>(d, l, cur, nxt, wl, "
         "lane);\n            __syncwarp();",
         "            run_layer<S>(d, l, cur, nxt, wl, lane);"),
        ("for (int e = lane; e < O * pad; e += 32) {",
         "for (int e = lane; e < O * pad; e += 64) {"),
        ("for (int e = lane; e < per; e += 32) {",
         "for (int e = lane; e < per; e += 64) {"),
        ("conv_stack_kernel<S><<<blocks, 32 * d.ns,",
         "conv_stack_kernel<S><<<blocks, 64 * d.ns,"),
    ], ()),
    # the input-feature loop unrolled by two
    ("unroll_i2", [
        ("        for (int i = 0; i < I; ++i) {\n            const S* col",
         "#pragma unroll 2\n        for (int i = 0; i < I; ++i) {\n"
         "            const S* col"),
    ], ()),
    ("loads_only", [
        ("#pragma unroll\n                        for (int o = 0; o < OW; ++o)\n"
         "                            acc[j][o] = fmaf(w[o], v, acc[j][o]);",
         "                        acc[j][j % OW] += v + w[j % OW];"),
        ("#pragma unroll\n                    for (int o = 0; o < OW; ++o)\n"
         "                        acc[j][o] = fmaf(w[o], a[j], acc[j][o]);",
         "                    acc[j][j % OW] += a[j] + w[j % OW];"),
    ], ()),
)
#: the per-layer variants: one source, the layer chosen at compile time
_LAYER_PATCH = (
    "            run_layer<S>(d, l, cur, nxt, wl, lane);",
    "            if (l == OFPT_ONLY) run_layer<S>(d, l, cur, nxt, wl, lane);",
)


def _patched(base: _cuda.Kernel, name: str, patches, flags=()) -> _cuda.Kernel:
    src = (_cuda.CSRC / base.source).read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"the {name} variant no longer applies")
        src = src.replace(old, new)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _cuda.BUILD_DIR / f"{base.name}_{name}.cu"
    if not path.exists() or path.read_text() != src:
        path.write_text(src)
    return _cuda.Kernel(f"{base.name}_{name}", str(path), base.entries,
                        extra_flags=tuple(flags))


def variants(n_layers: int) -> dict[str, _cuda.Kernel]:
    base = _cuda.CONV_STACK
    out = {name: _patched(base, name, patches, flags)
           for name, patches, flags in VARIANTS}
    for li in range(-1, n_layers):
        tag = "no_layers" if li < 0 else f"layer_{li}"
        out[tag] = _patched(base, "layer", [_LAYER_PATCH],
                            (f"-DOFPT_ONLY={li}",))
        out[tag].name = f"{base.name}_{tag}"
    return out


def layer_flops(length, weights, padding, batch) -> list[int]:
    t, out = length, []
    for w in weights:
        o, i, k = w.shape
        t = t + 2 * padding - k + 1
        out.append(2 * o * i * k * t * batch)
    return out


def events_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def clocks_under(fn, n: int) -> dict:
    """The SM clock (MHz) and board power (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs ``n`` times back to back."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [[float(v) for v in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    busy = rows[1:-1] or rows
    return dict(samples=len(rows),
                sm_mhz=sorted(r[0] for r in busy)[len(busy) // 2],
                power_w=sorted(r[1] for r in busy)[len(busy) // 2])


def with_library(lib, fn):
    """``fn`` run with ``_cuda.CONV_STACK`` launching ``lib``."""
    def run():
        saved = _cuda.CONV_STACK._lib
        _cuda.CONV_STACK._lib = lib
        try:
            return fn()
        finally:
            _cuda.CONV_STACK._lib = saved
    return run


def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def parent_runner(tree: Path):
    """The earlier tree's K3 kernel record (its source, entry points and
    build directory are that tree's) and its wrapper module, which
    launches through this package's ``_cuda.CONV_STACK``."""
    tree = tree.resolve() / "onset_fingerprinting_torch"
    cuda = _load_module("parent_cuda", tree / "ops/_cuda.py")
    return cuda, _load_module("parent_conv_stack", tree / "ops/conv_stack.py")


def stamps(cluster_fn, kern, x, out, ctas, n_layers) -> dict:
    """The ``stamps_unit`` variant's phases, in SM cycles from each CTA's
    start: the staging, then each layer's units (thread 0's warp), the
    cluster barrier's arrival and the zero rows, its wait, and the halo's
    pull (the last layer: units); in warp 0's last unit of each layer, its start after the
    layer's, its products and its epilogue.  The median and the largest
    over the CTAs of the last of 20 calls."""
    run = cluster_fn(x, out, kern, ctas)
    for _ in range(20):
        run()
    torch.cuda.synchronize()
    n_cta = -(-x.shape[0] // 16) * ctas
    raw = out.reshape(-1).view(torch.int64)[: n_cta * 128].reshape(
        n_cta, 128).cpu()
    # stamps: start, staged; per layer: units, arrived and zeroed, passed,
    # pulled; the last layer: units
    k = 4 * n_layers - 1
    t = raw[:, :k]
    names = ["staging"]
    for li in range(n_layers - 1):
        names += [f"units{li}", f"arrive+zero{li}", f"wait{li}",
                  f"pull{li}"]
    names.append(f"units{n_layers - 1}")
    cols = [t[:, 1:] - t[:, :-1]]
    layer_start = t[:, 1::4][:, :n_layers]
    u = raw[:, 40: 40 + 4 * n_layers].reshape(n_cta, n_layers, 4)
    for li in range(n_layers):
        names += [f"u{li}_start", f"u{li}_products", f"u{li}_epilogue"]
        cols += [u[:, li, :1] - layer_start[:, li: li + 1],
                 u[:, li, 1:2] - u[:, li, :1], u[:, li, 2:3] - u[:, li, 1:2]]
    steps = torch.cat(cols, 1).float()
    med = steps.median(0).values.tolist()
    top = steps.max(0).values.tolist()
    table = {n: (m, x_) for n, m, x_ in zip(names, med, top)}
    print(f"stamps, {ctas} CTAs (SM cycles, median / largest over "
          f"{n_cta} CTAs): " + ", ".join(
              f"{n} {m:.0f}/{x_:.0f}" for n, (m, x_) in table.items()),
          flush=True)
    return table


def cluster_main(smi: str) -> int:
    """``--cluster``: the cluster kernel split by its variants at the
    classifier's shape, in turns with the tensor-core kernel, and the
    crossover (module docstring)."""
    import ctypes

    from onset_fingerprinting_torch.ops.conv_stack import (
        CLUSTER_CTAS,
        _launch_cluster,
        _launch_mma,
        cluster_desc,
        cluster_plan,
    )
    from onset_fingerprinting_torch.tools.conv_stack_gate import (
        flagship_stack,
    )
    from onset_fingerprinting_torch.tools.step_bench import graph_ms

    base = _cuda.CONV_STACK_MMA_CLUSTER
    var = {name: _patched(base, name, patches or _STAMPS + _UNIT_STAMPS)
           for name, patches in CLUSTER_VARIANTS}
    logs = _cuda.build([base, _cuda.CONV_STACK_MMA, *var.values()])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    ws, bs = flagship_stack(seed=0)
    shapes = [tuple(w.shape) for w in ws]
    res = {"device": torch.cuda.get_device_name(0), "power": smi,
           "batch": CLUSTER_BATCH, "length": CLUSTER_LENGTH,
           "graph_calls": GRAPH_CALLS}

    def inputs(batch, length):
        x = torch.randn((batch, length), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(batch))
        t = length
        for o, _, k in shapes:
            t += 2 - k + 1
        return x, torch.empty((batch, t, shapes[-1][0]), device="cuda")

    def cluster_fn(x, out, kern=base, ctas=CLUSTER_CTAS):
        return lambda: _launch_cluster(kern, x, ws, bs, 1, "silu", out, ctas)

    def mma_fn(x, out):
        return lambda: _launch_mma(_cuda.CONV_STACK_MMA, x, ws, bs, 1,
                                   "silu", out)

    def ms(fn):
        return graph_ms([fn] * GRAPH_CALLS)

    x, out = inputs(CLUSTER_BATCH, CLUSTER_LENGTH)
    ref = torch.empty_like(out)
    mma_fn(x, ref)()
    occ = {}
    for ctas in (8, 16):
        got = torch.full_like(out, float("nan"))
        cluster_fn(x, got, ctas=ctas)()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"the cluster kernel ({ctas} CTAs) differs "
                                 f"from conv_stack_mma.cu")
        plan = cluster_plan(CLUSTER_LENGTH, shapes, 1, CLUSTER_BATCH, ctas)
        d = cluster_desc(plan, CLUSTER_BATCH, CLUSTER_LENGTH, "silu")
        n = ctypes.c_int(0)
        rc = base._lib.ofpt_conv_stack_mma_cluster_occupancy(
            ctypes.addressof(d), ctypes.addressof(n))
        occ[ctas] = dict(smem=plan.smem, resident_clusters=n.value, rc=rc)
    res["plan"] = occ
    print("bit for bit against conv_stack_mma.cu at clusters of 8 and 16; "
          "plans:", json.dumps(occ), flush=True)
    turns = []
    for tag in ("cluster8", "cluster16", "mma", "mma", "cluster16",
                "cluster8"):
        fn = (mma_fn(x, ref) if tag == "mma"
              else cluster_fn(x, out, ctas=int(tag[7:])))
        turns.append((tag, ms(fn)))
        print(f"{tag}: {turns[-1][1]:.5f} ms per call", flush=True)
    res["turns"] = turns
    split = {}
    for ctas in (8, 16):
        for name, kern in [("whole", base), *var.items()]:
            split[f"{name}_{ctas}"] = ms(cluster_fn(x, out, kern, ctas))
            print(f"{name} ({ctas} CTAs): {split[f'{name}_{ctas}']:.5f} ms",
                  flush=True)
    res["split"] = split
    for ctas in (8, 16):
        res[f"stamps_{ctas}"] = stamps(cluster_fn, var["stamps_unit"], x,
                                       out, ctas, len(shapes))
        run = cluster_fn(x, out, var["stamps_staging"], ctas)
        for _ in range(20):
            run()
        torch.cuda.synchronize()
        n_cta = -(-CLUSTER_BATCH // 16) * ctas
        t = out.reshape(-1).view(torch.int64)[: n_cta * 128].reshape(
            n_cta, 128)[:, :6].cpu().float()
        parts = (t[:, 1:] - t[:, :-1]).median(0).values.tolist()
        res[f"staging_{ctas}"] = dict(zip(
            ("cp.async issue", "table", "x rows", "biases", "wait"), parts))
        print(f"staging, {ctas} CTAs (SM cycles, median over CTAs):",
              res[f"staging_{ctas}"], flush=True)
    res["clocks"] = clocks_under(cluster_fn(x, out), 20000)
    print("SM clock and power while the kernel runs:", res["clocks"],
          flush=True)
    cross = []
    for length in CROSS_LENGTHS:
        for batch in CROSS_BATCHES:
            xb, ob = inputs(batch, length)
            row = dict(length=length, batch=batch)
            for tag in ("cluster", "mma", "mma2", "cluster2"):
                fn = mma_fn(xb, ob) if tag.startswith("mma") else \
                    cluster_fn(xb, ob)
                row[tag] = ms(fn)
            cross.append(row)
            print(f"L = {length}, B = {batch}: cluster {row['cluster']:.5f} "
                  f"/ {row['cluster2']:.5f}, tensor-core {row['mma']:.5f} / "
                  f"{row['mma2']:.5f} ms", flush=True)
    res["crossover"] = cross
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        simt_occupancy,
        simt_plan,
    )
    from onset_fingerprinting_torch.tools.conv_stack_gate import (
        flagship_stack,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--no-split", action="store_true",
                    help="time only the kernel (and the parent)")
    ap.add_argument("--cluster", action="store_true",
                    help="split the bf16 cluster kernel and measure its "
                    "crossover with the tensor-core kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_stack_split: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.cluster:
        return cluster_main(smi)
    ws, bs = flagship_stack(seed=0)
    x = torch.randn((BATCH, LENGTH), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    flops = layer_flops(LENGTH, ws, 1, BATCH)
    var = {} if args.no_split else variants(len(ws))
    parent = parent_runner(args.parent) if args.parent else None
    logs = _cuda.build([_cuda.CONV_STACK, *var.values()])
    if parent:
        logs.update({f"parent {k}": v for k, v in
                     parent[0].build([parent[0].CONV_STACK]).items()})
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    res = {"device": torch.cuda.get_device_name(0), "power": smi,
           "batch": BATCH, "length": LENGTH, "gflop": sum(flops) / 1e9,
           "bound_ms": 1e3 * sum(flops) / F32_FLOPS}
    shapes = [tuple(w.shape) for w in ws]
    plan = simt_plan(LENGTH, shapes, 1, 4)
    res["plan"] = dict(ns=plan.ns, smem=plan.smem, tt=[
        lp.tt for lp in plan.layers], ctas_per_sm=plan.ctas_per_sm,
        card_ctas_per_sm=simt_occupancy(LENGTH, shapes, 1, torch.float32))
    print("plan:", json.dumps(res["plan"]), flush=True)

    def run():
        return conv_stack(x, ws, bs, 1, "silu", torch.float32)

    ms = {"whole": events_ms(run, args.launches)}
    res["clocks"] = clocks_under(run, 100)
    print("SM clock and power while the kernel runs:", res["clocks"],
          flush=True)
    for name, kern in var.items():
        ms[name] = events_ms(with_library(kern._lib, run), args.launches)
        print(f"{name}: {ms[name]:.3f} ms", flush=True)
    res["ms"] = ms
    if var:
        floor = ms["no_layers"]
        res["layers"] = [
            dict(layer=li, ms=ms[f"layer_{li}"] - floor, gflop=f / 1e9,
                 tflops=f / (ms[f"layer_{li}"] - floor) / 1e9,
                 bound_ms=1e3 * f / F32_FLOPS)
            for li, f in enumerate(flops)]
        for r in res["layers"]:
            print(f"layer {r['layer']}: {r['ms']:.3f} ms, {r['gflop']:.2f} "
                  f"GFLOP, {r['tflops']:.1f} TFLOP/s (bound "
                  f"{r['bound_ms']:.3f} ms)", flush=True)
    if parent:
        kern, mod = parent[0].CONV_STACK, parent[1]

        def run_parent():
            return mod.conv_stack(x, ws, bs, 1, "silu", torch.float32)

        got = with_library(kern._lib, run_parent)()
        want = run()
        torch.cuda.synchronize()
        res["parent_vs_kernel_max_err"] = float((got - want).abs().max())
        pair = []
        for tag in ("parent", "kernel", "kernel", "parent"):
            fn = (with_library(kern._lib, run_parent) if tag == "parent"
                  else run)
            pair.append((tag, events_ms(fn, args.launches)))
            print(f"{tag}: {pair[-1][1]:.3f} ms", flush=True)
        res["pair"] = pair
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
