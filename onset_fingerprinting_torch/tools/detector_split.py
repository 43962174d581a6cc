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
shared-memory loads or stores), and their ratio.  Run on the card from the
repository root:

    python -m onset_fingerprinting_torch.tools.detector_split

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


def variant_kernel(name: str) -> _cuda.Kernel:
    base = _cuda.DETECTOR
    src = (_cuda.CSRC / base.source).read_text()
    path = _cuda.BUILD_DIR / f"detector_{name}.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = variant_source(src, name)
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return _cuda.Kernel(f"detector_{name}", str(path), base.entries,
                        extra_flags=base.flags[len(_cuda.NVCC_FLAGS):])


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("detector_split: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
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
