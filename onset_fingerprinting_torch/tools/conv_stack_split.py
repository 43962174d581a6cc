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
wrapper, and times parent, kernel, kernel, parent in turn.  Run on the card
from the repository root:

    python -m onset_fingerprinting_torch.tools.conv_stack_split
    python -m onset_fingerprinting_torch.tools.conv_stack_split --parent DIR

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
