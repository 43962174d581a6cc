"""Run one benchmark cell once and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its limits are found by name:
``BENCHMARK.json`` at the repository's root names the cell's
configuration file and traffic; the traffic is ``portbench/traffic/
<traffic>.json``, the limits ``portbench/limits/<cell>.json``, the system
under test ``portbench/systems/<config's "system">.py`` and every metric
``portbench/metrics/<metric>.py`` (a ``read(ctx)`` that returns the
metric's value, or None where the cell has nothing to read) or
``portbench/metrics/<metric>.json`` (a data entry that names one of the
shared readers of ``portbench/readers.py`` and its arguments).

The run builds the cell's inputs and weights from the seed on the card,
warms every shape the window uses (set-up), then drives a closed loop for
``--seconds``: one caller sends the next call when the last one's outputs
are on the host.  ``--trace 1`` runs the same window under the profiler and
reports the per-layer metrics instead of the end-to-end ones.  After the
window the outputs of calls drawn from the seed are compared with the
plain reference (``portbench/reference``), each number against its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = str(Path(__file__).resolve().parent)
if sys.path and sys.path[0] == HERE:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "onset_fingerprinting_tpu")


def _cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(root: Path, workload: str):
    """``(bench, cell, config, traffic, limits)`` by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    centry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / centry["file"]).read_text())
    base = root / "portbench"
    tr = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                    .read_text())
    lim_path = base / "limits" / f"{workload}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return bench, cell, cfg, tr, limits


def load_reader(root: Path, name: str):
    data = root / "portbench" / "metrics" / f"{name}.json"
    if data.exists():
        from portbench import readers

        entry = json.loads(data.read_text())
        fn = getattr(readers, entry.pop("reader"))
        entry.pop("about", None)
        return lambda ctx: fn(ctx, **entry)
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", faults=(),
             t_start: float | None = None, control: bool = False,
             readings: bool = False) -> tuple[dict, list]:
    """One run of a cell → ``(result, check lines)``.  ``device="cpu"``
    runs the program's plain versions (the tests' tiny cells);
    ``control`` also reads the lower-precision reference in the program's
    place on the same checked outputs (``result["control"]``);
    ``readings`` puts every number, compared or not, in
    ``result["readings"]``."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import common
    from portbench.tracing import Trace, kernel_presence

    marks = [time.perf_counter()]
    bench, cell, cfg, tr, limits = load_cell(root, workload)
    cuda = device == "cuda"
    mod = importlib.import_module(f"portbench.systems.{cfg['system']}")
    from onset_fingerprinting_torch.ops import _cuda
    unbuilt = [k for k in _cuda.KERNELS if not k.library_path().exists()]
    marks.append(time.perf_counter())
    if cuda:  # the card's context
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    system = mod.System(cfg, tr, seed, device, faults=faults)
    plan = common.KeepPlan(seed, tr.get("keep_every", 32),
                           tr.get("check_calls", 3))
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    system.warm()
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    # kernels that this run's set-up compiled (a fresh checkout's first run)
    built = sorted(k.name for k in unbuilt if k.library_path().exists())

    _cuda.reset_counts()
    if trace:
        system.trace_spans()
    tracer = Trace(cuda) if trace else None
    gc.collect()
    gc.freeze()
    segments = (torch.cuda.memory_stats().get("segment.all.allocated", 0)
                if cuda else 0)
    lat, failed, error = [], 0, None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    t1 = t0
    while True:
        a = time.perf_counter()
        try:
            system.step(plan.kept(system.calls))
        except Exception as e:  # a call that fails ends the window
            failed += 1
            error = f"{type(e).__name__}: {e}"
            break
        t1 = time.perf_counter()
        lat.append(t1 - a)
        if t1 >= end:
            break
    window_s = t1 - t0
    if tracer:
        tracer.stop()
    gc.unfreeze()
    launches = {k.name: k.launches for k in _cuda.KERNELS}
    plain = sum(k.plain_calls for k in _cuda.KERNELS)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:  # device memory the window had to allocate anew
        segments = torch.cuda.memory_stats().get(
            "segment.all.allocated", 0) - segments
    ctx = SimpleNamespace(
        cell=cell, config=cfg, traffic=tr, latencies=lat, window_s=window_s,
        calls=len(lat), work=len(lat) * system.stream_seconds,
        setup_s=setup_s, spans=system.span_ms() if trace else {},
        shapes=system.layer_shapes(),
        items_per_call=system.model_items_per_call(), trace=tracer)
    names = [m for m in bench["end_to_end" if not trace else "per_layer"]
             if workload in m.get("workloads", [workload])]
    metrics = {}
    for m in names:
        v = load_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": False, "attempted": len(lat) + failed,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": int(peak)},
              "built_kernels": len(built)}
    notes = []
    if tracer:
        result["device"]["busy_s"] = tracer.busy_s
        result["device"]["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
        missing = kernel_presence(tracer, _cuda) if cuda else []
        if missing:
            notes.append("kernels launched but absent from the trace: "
                         + ", ".join(missing))
    if error:
        notes.append(f"call {system.calls} failed: {error}")
    del tracer, ctx
    data = system.collect(plan)
    if cuda:
        torch.cuda.empty_cache()
    numbers = system.check(data)
    if control:
        result["control"] = system.check(data, control=True)
    compared = numbers.pop("compared")
    detail = numbers.pop("detail", {})
    if readings:
        result["readings"] = dict(numbers)
    detail["plain_calls"] = plain
    detail["window_segments"] = segments
    # set-up: the interpreter and PyTorch's import; the program's import;
    # the card's context; inputs, weights and the program; the warm calls
    # (with the kernels' build in a fresh checkout)
    detail["setup_parts_s"] = ",".join(
        f"{name}={b - a:.3f}" for name, a, b in zip(
            ("torch", "program", "context", "inputs", "warm"),
            [t_start] + marks, marks))
    detail["built_kernels"] = ",".join(built) or "none"
    detail["launches"] = ",".join(f"{k}:{v}" for k, v in launches.items()
                                  if v)
    check = {}
    lines = [f"detail {k} {v}" for k, v in detail.items()]
    lines.append(f"check compared_outputs {compared}")
    # the limits file names the numbers compared; the others are shown
    ok = failed == 0 and len(lat) > 0 and not notes and bool(limits)
    for k, v in numbers.items():
        if k not in limits:
            lines.insert(0, f"detail {k} {v!r} (not compared)")
            continue
        good = v <= limits[k]
        check[k] = {"value": v, "limit": limits[k]}
        ok = ok and good
        lines.append(f"check {k} {v!r} limit {limits[k]!r} "
                     f"{'ok' if good else 'FAILED'}")
    for k in set(limits) - set(numbers):
        ok = False
        lines.append(f"check {k} missing limit {limits[k]!r} FAILED")
    result["correct"] = bool(ok)
    result["check"] = check
    return result, notes + lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _cache_dirs()
    import torch

    bench, cell, *_ = load_cell(ROOT, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(ROOT, a.workload, a.seed, a.seconds,
                             bool(a.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print("modules loaded that the port must not load: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    if any(ln.startswith("kernels launched") for ln in lines):
        print("\n".join(lines), file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
