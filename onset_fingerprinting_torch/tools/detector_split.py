"""Where K1's time goes: loads against arithmetic, and its SASS per sample.

Builds two variants of ``csrc/detector.cu`` at run time, in the build
directory (the sources in the package stay as they are):

- ``compute``: the block loop stages only the first block from device
  memory and then runs every later block on the column already in shared
  memory (the last block's relative envelope), so it times the arithmetic
  and the shared-memory traffic without the loads;
- ``loads``: the block loop stages each block and skips everything else.

Times each variant beside ``detector.cu`` itself at the fleet shape
``[32000, 32768]`` (events only, as the fleet path runs it) by CUDA
events, and counts the SASS of the innermost loops (``cuobjdump -sass``)
of these kernels and of the pipelined ``detector_pipe.cu`` (counted, not
timed: ``chip_smoke.py`` times it beside ``detector.cu``): instructions
per loop iteration, the samples one iteration handles (its most
shared-memory loads or stores), and their ratio.

``--coupled`` splits the pipe's coupled instantiation instead, at C = 3:
one lane group (mining's two launches, the warmup ``[48000, 3]`` and the
recording ``[299904, 3]``) and many (``[1024, 192000, 3]`` at the plan's
8 streams a CTA and at 10).  It times ``detector_warp.cu`` (named) and
the pipe in turns (old, new, new, old) at those shapes and at ``[128, 3]``
(per launch in a graph of 128), and patched copies of
``detector_pipe.cu`` with chains stubbed (``only_w0``, ``only_w1``,
``only_w2``: one warp computes, the others only hand the sub-blocks on;
``handoff``: none computes), with the dB and exp2 one lane per channel
at few lanes too or the few-lane layout at any width (``per_lane``,
``few_all``), with a rel ring of one block (``rel1``), and with few
lanes' sub-blocks of 16 or 32 rows instead of 64 (``few_sb16``,
``few_sb32``), and with one group's x and rel copied a row a lane
(``narrow``) instead of in 16-byte pieces.  Run on the card from the repository root:

    python -m onset_fingerprinting_torch.tools.detector_split
    python -m onset_fingerprinting_torch.tools.detector_split --coupled

It writes the SASS of every kernel to ``--out`` (default
``build/detector_split/``) and prints one JSON line last.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from onset_fingerprinting_torch.ops import _cuda

T, N_STREAMS = 32000, 8192

_STAGE = ("#pragma unroll 8\n"
          "        for (int t = 0; t < bsz; ++t) buf[t * bs] = xb[(size_t)t * C];")
_VARIANTS = {
    # stage the first block only; later blocks reuse the staged column
    "compute": (_STAGE, "if (blk == 0) {\n" + _STAGE + "\n        }"),
    # stage every block, then leave the block (one value read keeps the
    # staging live)
    "loads": (_STAGE, _STAGE + "\n        yf += buf[(bsz - 1) * bs];"
              "\n        continue;"),
}


def variant_source(src: str, name: str) -> str:
    old, new = _VARIANTS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"the {name} variant no longer applies")
    return src.replace(old, new)


# the coupled pipe's chains, each replaced by a plain hand-off of its
# sub-block (the rings, barriers, loads and stores stay)
_W0 = [
    ("                if (IIR) {\n#pragma unroll\n"
     "                    for (int r = 0; r < SBR; ++r) {\n"
     "                        const float xt = v[r];",
     "                if (false) {\n#pragma unroll\n"
     "                    for (int r = 0; r < SBR; ++r) {\n"
     "                        const float xt = v[r];"),
    ("spread<SBR>(dout, xin, SBR * ld, lane, db_of);",
     "spread<SBR>(dout, xin, SBR * ld, lane, [](float y) { return y; });"),
    ("for (int r = 0; r < SBR; ++r) v[r] = db_of(v[r]);",
     "for (int r = 0; r < SBR; ++r) v[r] = v[r];"),
]
_W1 = [
    ("const float df = xdb - yf + p.eps;\n"
     "                        yf = yf + (df > 0.f ? p.fa * df : p.fr * df);\n"
     "                        const float dsl = xdb - ys + p.eps;\n"
     "                        ys = ys + (dsl > 0.f ? p.sa * dsl : p.sr * dsl);\n"
     "                        v[r] = out_of(yf - ys);",
     "v[r] = xdb;"),
    ("spread<SBR>(rout, rout, SBR * ld, lane, rel_of);",
     "spread<SBR>(rout, rout, SBR * ld, lane, [](float d) { return d; });"),
]
_W2 = [
    ("const float rr = v[r];\n"
     "                    mn = rr < p.minmin ? p.minmin\n"
     "                                       : (rr < mn ? rr : mn * p.iam + rr * p.am);\n"
     "                    mx = rr > mx ? rr : mx * p.iax + rr * p.ax;",
     "mx = v[r];"),
    ("for (int r = 0; r < SBR; ++r) scan(v[r], jj * SBR + r);",
     "for (int r = 0; r < SBR; ++r) pv = v[r];"),
]


def _const(name, old, new):
    return [(f"constexpr {name} = {old};", f"constexpr {name} = {new};")]


COUPLED_VARIANTS = {
    "only_w0": _W1 + _W2,
    "only_w1": _W0 + _W2,
    "only_w2": _W0 + _W1,
    "handoff": _W0 + _W1 + _W2,
    # the dB and exp2 one lane per channel at few lanes too; the few-lane
    # layout (spread, 64-row sub-blocks) at any width
    "per_lane": _const("bool SPREAD", "true", "false"),
    "few_all": _const("int SPREAD_LANES", 8, 32),
    # a rel ring of one block; few lanes' sub-blocks of 16 or 32 rows
    "rel1": _const("int REL_BLOCKS", 2, 1),
    "few_sb16": _const("int SB_FEW", 64, 16),
    "few_sb32": _const("int SB_FEW", 64, 32),
    # one group a CTA: x and rel a row a lane, 4 bytes each, as at more
    "narrow": [("const bool wide = COUPLED && gpc == 1 &&",
                "const bool wide = false && COUPLED && gpc == 1 &&")],
}


def coupled_variant_source(src: str, name: str) -> str:
    for old, new in COUPLED_VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"the coupled {name} variant no longer "
                               "applies")
        src = src.replace(old, new)
    return src


def _patched_kernel(name: str, text: str, base: _cuda.Kernel,
                    entries: dict) -> _cuda.Kernel:
    path = _cuda.BUILD_DIR / f"{name}.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return _cuda.Kernel(name, str(path), entries,
                        extra_flags=base.flags[len(_cuda.NVCC_FLAGS):])


def coupled_variant_kernel(name: str) -> _cuda.Kernel:
    src = (_cuda.CSRC / _cuda.DETECTOR_PIPE.source).read_text()
    return _patched_kernel(f"detector_pipe_{name}",
                           coupled_variant_source(src, name),
                           _cuda.DETECTOR_PIPE,
                           _cuda.DETECTOR_PIPE_COUPLED.entries)


def variant_kernel(name: str) -> _cuda.Kernel:
    base = _cuda.DETECTOR
    src = (_cuda.CSRC / base.source).read_text()
    return _patched_kernel(f"detector_{name}", variant_source(src, name),
                           base, base.entries)


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_TARGET = re.compile(r"BRA\s+0x([0-9a-f]+)")


def sass_functions(lib: Path) -> dict[str, list[str]]:
    """SASS lines of each function in ``lib`` (``cuobjdump -sass``)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def inner_loops(lines: list[str]) -> list[dict]:
    """Innermost loops of one function (bodies between a backward branch
    and its target): instructions per iteration, FP32-pipe instructions
    (``F*`` and ``MUFU``), shared or generic loads and stores, MUFU and
    device loads, and the samples per iteration (its most loads or stores
    of the staged column: each sample of a per-sample loop touches it
    once)."""
    insns = []  # (address, opcode without modifiers, line)
    for line in lines:
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2).split(".")[0],
                          line))
    index = {a: i for i, (a, _, _) in enumerate(insns)}
    loops = set()
    for i, (addr, op, line) in enumerate(insns):
        t = _TARGET.search(line) if op == "BRA" else None
        if t and int(t.group(1), 16) <= addr:
            loops.add((index[int(t.group(1), 16)], i))
    out = []
    for s, e in sorted(loops):
        if any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
               for s2, e2 in loops):
            continue  # not innermost
        ops = [op for _, op, _ in insns[s:e + 1]]
        loads = sum(op in ("LDS", "LD") for op in ops)
        stores = sum(op in ("STS", "ST") for op in ops)
        samples = max(loads, stores, 1)
        fp = sum(op.startswith("F") or op == "MUFU" for op in ops)
        out.append(dict(start=hex(insns[s][0]), n=len(ops), fp=fp,
                        loads=loads, stores=stores,
                        mufu=ops.count("MUFU"),
                        ldg=sum(op in ("LDG", "LDGSTS") for op in ops),
                        samples=samples, per_sample=len(ops) / samples,
                        fp_per_sample=fp / samples))
    return out


def fleet_inputs(n_streams=N_STREAMS, t=T):
    from onset_fingerprinting_torch.ops.fused_detector import (
        make_fused_detector,
    )
    from onset_fingerprinting_torch.pipeline import fleet_detector_config
    from onset_fingerprinting_torch.workload import make_audio

    cfg = fleet_detector_config(n_streams)
    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=False)
    return fst, params, st0, make_audio(t, cfg.n_channels, seed=2)


def time_ms(fn, n=5):
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


#: mining's two launches (6b's recording) and 8c's batch of streams
MINING_WARM, MINING_T = 48000, 299904
STREAMS, STREAM_T = 1024, 192000


def mining_inputs():
    """Mining's detector (``offline_detector``: 3 channels, the 2 kHz
    high-pass, coupled) and a recording on the card."""
    from onset_fingerprinting_torch.detect.amplitude import offline_detector
    from onset_fingerprinting_torch.workload import make_audio

    fst, params, st0 = offline_detector(3, sr=96000)
    return fst, params, st0, make_audio(MINING_T, 3, seed=6)


def streams_inputs(n=STREAMS, t=STREAM_T):
    """8c's detector (3 channels, no high-pass, coupled), ``x [n, t, 3]`` and
    per-stream states (the initial one)."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import DetectorState
    from onset_fingerprinting_torch.ops.fused_detector import (
        make_fused_detector,
    )
    from onset_fingerprinting_torch.workload import make_audio

    fst, params, st0, _ = make_fused_detector(DetectorConfig(
        n_channels=3, block_size=128, hipass_freq=0.0, sr=96000),
        emit_rel=False)
    x = make_audio(t, 3 * n, seed=8).reshape(t, n, 3).transpose(0, 1)
    states = DetectorState(*(v.expand((n,) + tuple(v.shape)).contiguous()
                             for v in st0))
    return fst, params, states, x.contiguous()


def mining_launches(kernel, fst, params, st0, x):
    """Mining's two K1 launches on ``kernel``: the warmup, then the
    recording with rel (``detect_onsets_amplitude``'s calls)."""
    from onset_fingerprinting_torch.ops.fused_detector import _launch

    st = _launch(fst, params, st0, x[:MINING_WARM], False, True, kernel)[0]
    return _launch(fst, params, st, x, True, False, kernel)


def check_same(what, a, b):
    """Two K1 results ``(state, (on, deltas, rel))`` bit for bit."""
    (sa, oa), (sb, ob) = a, b
    same = all(torch.equal(u, v) for u, v in zip((*sa, *oa), (*sb, *ob))
               if u is not None)
    print(f"{what}: the coupled pipe and detector_warp.cu "
          f"{'bit-identical' if same else 'DIFFER'} ({int(oa[0].sum())} "
          "onsets)", flush=True)
    if not same:
        raise SystemExit(f"{what}: the coupled pipe differs")


def in_turns(fns: dict, n=3):
    """``{name: ms}``, CUDA events, each of ``fns`` timed twice in the order
    a, b, ..., b, a (the mean of its two times)."""
    names = list(fns)
    t = {k: [] for k in names}
    for k in names + names[::-1]:
        t[k].append(time_ms(fns[k], n))
    return {k: sum(v) / len(v) for k, v in t.items()}


def coupled_main(args) -> dict:
    from onset_fingerprinting_torch.ops.fused_detector import (
        coupled_plan,
        fused_detect_streams,
    )
    from onset_fingerprinting_torch.tools.step_bench import k1_times

    warp, pipe = _cuda.DETECTOR_WARP, _cuda.DETECTOR_PIPE_COUPLED
    variants = {n: coupled_variant_kernel(n) for n in args.variants.split(",")
                if n}
    kernels = {"detector_warp": warp, "detector_pipe_coupled": pipe,
               **{f"detector_pipe_{n}": k for n, k in variants.items()}}
    for name, log in _cuda.build(list(kernels.values())).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    res = {}
    fst, params, st0, x = mining_inputs()
    # the pipe against detector_warp.cu, bit for bit, before any time
    check_same("mining", mining_launches(pipe, fst, params, st0, x),
               mining_launches(warp, fst, params, st0, x))
    res["mining"] = in_turns({
        "detector_warp": lambda: mining_launches(warp, fst, params, st0, x),
        "detector_pipe_coupled": lambda: mining_launches(
            pipe, fst, params, st0, x)})
    print(f"mining's two launches [{MINING_WARM}, 3] + [{MINING_T}, 3]: "
          f"{res['mining']}", flush=True)
    res["mining_split"] = {n: time_ms(lambda k=k: mining_launches(
        k, fst, params, st0, x), 3) for n, k in variants.items()}
    print(f"  split (one group): {res['mining_split']}", flush=True)
    xb = x[:128].contiguous()
    res["step"] = k1_times(xb)
    print(f"[128, 3] per launch in a graph of 128: {res['step']}", flush=True)
    del x
    fst, params, states, xs = streams_inputs()
    plan = coupled_plan(STREAMS, 3, 128)
    for g in (None, 10):
        check_same(f"streams, {g or plan.groups_per_cta} a CTA",
                   fused_detect_streams(fst, params, states, xs, True,
                                        groups_per_cta=g),
                   fused_detect_streams(fst, params, states, xs, True,
                                        kernel=warp))
    res["streams"] = in_turns({
        "detector_warp": lambda: fused_detect_streams(
            fst, params, states, xs, kernel=warp),
        f"detector_pipe_coupled_g{plan.groups_per_cta}": lambda:
            fused_detect_streams(fst, params, states, xs),
        "detector_pipe_coupled_g10": lambda: fused_detect_streams(
            fst, params, states, xs, groups_per_cta=10)})
    print(f"[{STREAMS}, {STREAM_T}, 3]: {res['streams']} (plan: "
          f"{plan.groups_per_cta} streams a CTA, {plan.ctas} CTAs)",
          flush=True)
    for g in (plan.groups_per_cta, 10):
        res[f"streams_split_g{g}"] = {n: time_ms(
            lambda k=k, g=g: fused_detect_streams(
                fst, params, states, xs, groups_per_cta=g, kernel=k), 3)
            for n, k in variants.items()}
        print(f"  split ({g} groups a CTA): {res[f'streams_split_g{g}']}",
              flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    for name, k in kernels.items():
        if name == "detector_warp":
            continue
        for fn, lines in sass_functions(k.library_path()).items():
            # mining's coupled instantiation (IIR, EMIT) and 8c's (neither)
            if not ("ILb1ELb0ELb1ELb1EEv" in fn or "ILb0ELb0ELb0ELb1EEv" in fn):
                continue
            (args.out / f"{name}.{fn[:40]}.sass").write_text("\n".join(lines))
            for lp in inner_loops(lines):
                print(f"  {name} {fn[:48]} loop {lp['start']}: {lp['n']} "
                      f"insns ({lp['fp']} FP32 pipe), {lp['samples']} "
                      f"samples/iter (loads {lp['loads']}, stores "
                      f"{lp['stores']}, MUFU {lp['mufu']})", flush=True)
    return res


def main(argv=None) -> int:
    import argparse

    from onset_fingerprinting_torch.ops.fused_detector import _launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="detector,detector_compute,"
                    "detector_loads,detector_pipe",
                    help="comma-separated: detector, detector_compute, "
                    "detector_loads (timed and counted), detector_pipe "
                    "(counted)")
    ap.add_argument("--out", type=Path,
                    default=_cuda.BUILD_DIR.parent / "detector_split",
                    help="directory for the SASS listings")
    ap.add_argument("--coupled", action="store_true",
                    help="split the coupled pipe instead (see above)")
    ap.add_argument("--variants", default=",".join(COUPLED_VARIANTS),
                    help="with --coupled: the patched copies to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("detector_split: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if args.coupled:
        print(json.dumps(coupled_main(args)))
        return 0
    known = {"detector": lambda: _cuda.DETECTOR,
             "detector_pipe": lambda: _cuda.DETECTOR_PIPE,
             **{f"detector_{v}": lambda v=v: variant_kernel(v)
                for v in _VARIANTS}}
    kernels = {n: known[n]() for n in args.kernels.split(",")}
    for name, log in _cuda.build(list(kernels.values())).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    fst, params, st0, x = fleet_inputs()
    args.out.mkdir(parents=True, exist_ok=True)
    times = {}
    for name, k in kernels.items():
        if name != "detector_pipe":
            times[name] = time_ms(lambda k=k: _launch(fst, params, st0, x,
                                                      False, False, k))
            print(f"{name}: {times[name]:.3f} ms at [{T}, {x.shape[1]}]",
                  flush=True)
        for fn, lines in sass_functions(k.library_path()).items():
            (args.out / f"{name}.{fn[:40]}.sass").write_text(
                "\n".join(lines))
            for lp in inner_loops(lines):
                print(f"  {name} {fn[:48]} loop {lp['start']}: {lp['n']} "
                      f"insns ({lp['fp']} FP32 pipe), {lp['samples']} "
                      f"samples/iter -> {lp['per_sample']:.2f} "
                      f"({lp['fp_per_sample']:.2f} FP32 pipe)/sample (loads "
                      f"{lp['loads']}, stores {lp['stores']}, MUFU "
                      f"{lp['mufu']}, device loads {lp['ldg']})", flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
