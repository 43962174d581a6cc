"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from: for each seed, one short run of the cell at its own size (set-up,
a closed-loop window, the check), the compared numbers of the program and,
with ``--control``, of the control (the reference in the program's place,
computed one precision lower: the detector and the locator in bfloat16,
the CCCNN in float8 e4m3) on the same checked outputs.  One process reads
every seed, so the kernels are built and the card is set up once.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--control]

Prints one JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from portbench.run import _cache_dirs, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    _cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        res, lines = run_cell(ROOT, a.workload, seed, a.seconds, False,
                              control=a.control, readings=True)
        row = {"seed": seed, "correct": res["correct"],
               "program": res["readings"],
               "control": res.get("control"),
               "detail": [ln for ln in lines if ln.startswith("detail")],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
