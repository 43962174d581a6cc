"""Where the realtime engine's per-block step spends its time on the card,
split inside its two launches: K1 and the locate kernel, which writes the
block to the audio ring before it locates.

At the engine's configuration (``tools/realtime_sim``: 3 sensors, 128-sample
blocks, coupled K1, the locate kernel), with the timing and graph reading of
``tools/step_bench``:

- the captured step's graph: its nodes by type and its kernels;
- K1 at ``[128, 3]`` (``csrc/detector_warp.cu``) per launch in a graph of
  launches, as cumulative variants of its source: the block's load alone,
  then each pass of the block added in turn (dB, envelopes, linear,
  min/max), then pass 2 without and with the cross-channel off-check,
  beside an empty kernel;
- the locate kernel (``csrc/locate_block.cu``) per launch on the stream's
  quiet blocks and on its fired blocks in stream order, as cumulative
  variants: staging alone, then the slot logic without the lag-map scan
  and Newton, then with the scan, then whole; and the whole kernel on the
  quiet blocks with the ring write (``quiet_write``), in turns with the
  bare launches (``write``: the difference);
- the locate kernel with CC refinement (``tools/step_bench.refine_times``:
  each fired block refining against its own window) whole and cut after
  each of the refinement's two barriers: ``sections`` (the ring read, the
  medians and differences; no CC) and ``cc`` (the CC and each warp's
  argmax; no argmax over the warps, no heuristic), each cut leaving the
  onsets unrefined.

The variants are patched copies of the kernels' sources written to the
build directory at run time (the sources in the package stay as they
are).  Run on the card from the repository root:

    python -m onset_fingerprinting_torch.tools.step_split

It prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.tools.step_bench import (
    graph_ms,
    locate_calls,
    locate_times,
    refine_times,
    step_graph,
)

_CUT = "yf += col[bsz - 1];\n        continue;\n"
#: K1 variants, cumulative: (name, anchor, replacement)
K1_STEPS = (
    ("load", "        // DF2T high-pass: a chain",
     "        " + _CUT + "        // DF2T high-pass: a chain"),
    ("db", "        // fast and slow envelopes,",
     "        " + _CUT + "        // fast and slow envelopes,"),
    ("env", "        // dB difference -> clipped linear",
     "        " + _CUT + "        // dB difference -> clipped linear"),
    ("lin", "        // EMA min/max tracker",
     "        " + _CUT + "        // EMA min/max tracker"),
    ("minmax", "if (p.warmup) continue;", "continue;"),
    ("uncoupled", "        if (p.coupled) {\n            // reference quirk",
     "        if (false) {\n            // reference quirk"),
)
#: locate variants, cumulative
LOCATE_STEPS = (
    ("stage", "    const Slots old = sl;",
     "    if (tid == 0) hit_emits[0] = (uint8_t)(sh.order[C - 1] + sl.s0 +"
     " sl.o0 + sl.cnt + sl.age + sl.next_age + q0);\n    return;\n"
     "    const Slots old = sl;"),
    ("slots", "    const int nscan = sh.nscan[buf];",
     "    const int nscan = 0;"),
    ("scan", "        emit = solve_tdoa(tri, lag1 * d.c_over_sr, "
     "lag2 * d.c_over_sr, &px,\n                          &py);",
     "        emit = false;"),
)


_NO_REFINE = ("    if (warp == 0 && lane == 0) sh.ref[7] = 0;\n"
              "    __syncwarp();\n    return;\n")
#: refinement cuts, each on its own: (name, anchor, replacement)
REFINE_STEPS = (
    ("sections", "    // the CC at the tolerance window's lags:",
     _NO_REFINE + "    // the CC at the tolerance window's lags:"),
    ("cc", "    if (warp != 0) return;\n",
     "    if (warp != 0) return;\n" + _NO_REFINE),
)


def variants(base: _cuda.Kernel, steps) -> dict[str, _cuda.Kernel]:
    """One kernel per step: the source with that step's cut (each variant
    stops where its step ends and skips what comes after)."""
    src = (_cuda.CSRC / base.source).read_text()
    out = {}
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, old, new in steps:
        if src.count(old) != 1:
            raise RuntimeError(f"the {name} variant no longer applies")
        text = src.replace(old, new)
        path = _cuda.BUILD_DIR / f"{base.name}_{name}.cu"
        if not path.exists() or path.read_text() != text:
            path.write_text(text)
        out[name] = _cuda.Kernel(f"{base.name}_{name}", str(path),
                                 base.entries,
                                 extra_flags=base.flags[len(_cuda.NVCC_FLAGS):])
    return out


def main(argv=None) -> int:
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.ops.fused_detector import (
        launch_args,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.ops.locate_block import LocateBlock
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_split: CUDA is not available", file=sys.stderr)
        return 2
    k1v = variants(_cuda.DETECTOR_WARP, K1_STEPS)
    lov = variants(_cuda.LOCATE_BLOCK, LOCATE_STEPS)
    rfv = variants(_cuda.LOCATE_BLOCK, REFINE_STEPS)
    _cuda.build([_cuda.DETECTOR, _cuda.DETECTOR_WARP, _cuda.LOCATE_BLOCK,
                 *k1v.values(), *lov.values(), *rfv.values()])
    res = {"device": torch.cuda.get_device_name(0)}

    audio, _, _ = sim.synth_stream(20.0, 0)
    eng = sim.build_engine(None)
    eng.warmup(audio[: sim.WARMUP])
    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    res["graph"] = step_graph(eng, blocks[sim.WARMUP // 128:])
    print("graph:", json.dumps(res["graph"]), flush=True)

    # K1 at [128, 3]: the whole kernel, its variants, an empty launch
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=False)
    xb = blocks[len(blocks) // 2].contiguous()
    k1 = {}
    for name, kern in [("whole", _cuda.DETECTOR_WARP), *k1v.items()]:
        kk, entry, a, _, keep = launch_args(fst, params, st0, xb, False,
                                            False, kern)
        fn = getattr(kk._lib, entry)
        k1[name] = graph_ms([lambda: fn(*a[:-1], _cuda.stream())]
                            * args.launches)
        del keep
    k1["empty"] = graph_ms([lambda: _cuda.DETECTOR._lib.ofpt_empty(
        _cuda.stream())] * args.launches)
    res["k1"] = k1
    print("k1:", json.dumps(k1), flush=True)

    # the locate kernel on quiet blocks and on the fired ones in order
    lb = LocateBlock(eng.locator, 3, 128, device="cuda")
    l0, q0, quiet, fired, _ = locate_calls(audio, blocks, args.seconds)
    lo = {}
    saved = _cuda.LOCATE_BLOCK._lib
    for name, kern in [("whole", None), *lov.items()]:
        if kern is not None:
            _cuda.LOCATE_BLOCK._lib = kern._lib
        try:
            t = locate_times(lb, l0, q0, quiet, fired)
        finally:
            _cuda.LOCATE_BLOCK._lib = saved
        lo[f"quiet_{name}"] = t["quiet"]
        lo[f"fired_{name}"] = t["fired"]
        if name == "whole":
            lo["quiet_write"], lo["write"] = t["quiet_write"], t["write"]
    res["locate"] = lo
    res["locate_blocks"] = dict(fired=len(fired), quiet=len(quiet))
    print("locate:", json.dumps(lo), flush=True)

    # the refining kernel whole and cut after each of its barriers
    lb_cc = LocateBlock(eng.locator, 3, 128, cc_refine=True, device="cuda")
    rf = {}
    for name, kern in [("whole", None), *rfv.items()]:
        if kern is not None:
            _cuda.LOCATE_BLOCK._lib = kern._lib
        try:
            t = refine_times(lb_cc, l0, q0, quiet, fired, audio)
        finally:
            _cuda.LOCATE_BLOCK._lib = saved
        rf[f"fired_{name}"] = t["fired"]
        if name == "whole":
            rf["quiet_whole"] = t["quiet"]
    res["refine"] = rf
    print("refine:", json.dumps(rf), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
