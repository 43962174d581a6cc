"""The window gathers K2 and K4 on the card: every kernel that takes the
fleet shape, on the same inputs, in one process.

For each of two hit distributions at the fleet width (x ``[32000, 32768]``,
G = 32768 hits, cps = 4, W = 256):

- ``random``: uniformly random ``(start, stream)`` pairs, the traffic of
  streams struck independently, with both clip edges;
- ``fleet``: the injected hit grid through ``top_hit_blocks`` and
  ``compact_hit_list`` with sample-anchored starts, as the fleet path
  builds its list (every stream's hits in the same blocks; the empty slots
  read stream 0 at row 0),

each kernel the route functions know (``ops/windows.gather_routes``,
``roll_routes``: ``old`` and ``vec``) is first held bit-exact to the
plain version (K2 in both contracts, K4 also against K2's block-aligned
windows), then timed with CUDA events: the mean of ``iters`` calls after a
warm call, in two rounds (kernels in order, then in reverse).  Beside each
time stand two floors from the run's own hits at 3.35 TB/s: the useful
bytes (each distinct input float read once, the output written once, the
indices read) and the sectors (each distinct 32-byte input sector, the
output's sectors, the indices).

Run on the card: ``python -m onset_fingerprinting_torch.tools.gather_bench``
(``--orders``: the same hits in other orders; ``--l2``: random hits on an
x the L2 holds; ``--granularity``: random rows of 4 to 32 bytes;
``--variants``: patched copies of the row-vector kernels).
``chip_smoke.py`` phase 1 calls :func:`run`.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from onset_fingerprinting_torch.ops import windows as ow
from onset_fingerprinting_torch.tools.fingerprint_anatomy import hit_grid
from onset_fingerprinting_torch.workload import (
    CHANNELS_PER_STREAM,
    HIT_FIRST,
    HIT_PERIOD,
    PRE,
    WINDOW,
    chunk_capacities,
    n_injected,
)

#: HBM bytes per second of the H100 SXM (NVIDIA data sheet, 700 W)
HBM_BPS = 3.35e12
SECTOR = 32  # bytes


def random_hits(t: int, c: int, cps: int, g: int, seed: int, device):
    """``g`` uniformly random ``(start, stream)`` pairs, int32; the first
    four starts sit on both clip edges."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, t, g).astype(np.int32)
    starts[:4] = [0, 5, t - 1, t - WINDOW - 3]
    sids = rng.integers(0, c // cps, g).astype(np.int32)
    return (torch.as_tensor(starts, device=device),
            torch.as_tensor(sids, device=device))


def fleet_hits(t: int, n_streams: int, device):
    """The fleet path's hit list for the injected grid: ``(starts, sids)``
    of ``compact_hit_list`` at the path's capacities, sample-anchored at
    the injected onsets (0 in the empty slots)."""
    max_hits, cap = chunk_capacities(n_streams, t)
    on = hit_grid(t, n_streams, 0, device)
    deltas = torch.zeros(on.shape, dtype=torch.int32, device=device)
    for k in range(n_injected(t)):
        onset = HIT_FIRST + HIT_PERIOD * k
        deltas[onset // 128] = onset % 128
    st, v = ow.top_hit_blocks(on, 128, n_streams, max_hits, deltas)
    starts, sids, _, _ = ow.compact_hit_list(st, v, cap)
    return starts, sids


def _distinct(keys: torch.Tensor) -> int:
    return int(torch.unique(keys.reshape(-1)).numel())


def gather_traffic(x_shape, starts, sids, cps, window, pre, anchored):
    """K2's ``(useful_bytes, sector_bytes)`` for these hits: distinct input
    floats (sectors) read once, the ``[N, cps, W]`` output written once,
    the two index vectors read once."""
    t, c = x_shape
    n = starts.shape[0]
    rows = ow._rows(starts.long(), t, window, pre, anchored)
    sids = torch.clamp(sids.long(), 0, c // cps - 1)
    r = rows[:, None, None] + torch.arange(window, device=rows.device)
    cols = (sids * cps)[:, None] + torch.arange(cps, device=rows.device)
    flat = r * c + cols[:, :, None]  # [N, cps, W]
    fixed = n * cps * window * 4 + 2 * n * 4
    return (_distinct(flat) * 4 + fixed,
            _distinct(flat // (SECTOR // 4)) * SECTOR + fixed)


def roll_traffic(x_shape, row_start, sids, cps, window):
    """K4's ``(useful_bytes, sector_bytes)``, counted as for K2 over the
    ``[N, W, 8]`` slabs."""
    t, c = x_shape
    n = row_start.shape[0]
    rows, cols = ow._roll_indices(row_start, sids, t, c, cps, window)
    flat = rows[:, :, None] * c + cols[:, None, :]  # [N, W, 8]
    fixed = n * window * 8 * 4 + 2 * n * 4
    return (_distinct(flat) * 4 + fixed,
            _distinct(flat // (SECTOR // 4)) * SECTOR + fixed)


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls after one warm call, by
    CUDA events."""
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


def _rounds(fns: dict, iters: int) -> dict:
    """Each function timed twice: in order, then in reverse order."""
    out = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            out[k].append(time_ms(fns[k], iters))
    return out


def _fmt(times: dict) -> str:
    return ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def bench_k2(x, starts, sids, cps=CHANNELS_PER_STREAM, iters=20,
             tag="") -> dict:
    """K2 on every route that takes the shape: bit-exact to plain in both
    contracts, then timed (sample-anchored, the path's contract)."""
    t, c = x.shape
    routes = ow.gather_routes(cps, WINDOW, x.data_ptr())
    for anchored in (True, False):
        plain = ow.gather_hit_windows_reference(x, starts, sids, cps, WINDOW,
                                                PRE, anchored)
        for name, route in routes.items():
            got = ow._launch_gather(route, x, starts, sids, cps, WINDOW, PRE,
                                    anchored)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"K2 {name} ({route.kernel.name}"
                  f") differs from plain, anchored={anchored} {tag}")
        del plain, got
    fns = {name: (lambda r=route: ow._launch_gather(
        r, x, starts, sids, cps, WINDOW, PRE, True))
        for name, route in routes.items()}
    rows = ow._rows(starts.long(), t, WINDOW, PRE, True)
    r = (rows[:, None] + torch.arange(WINDOW, device=x.device))[:, None, :]
    cols = (sids.long()[:, None] * cps + torch.arange(cps, device=x.device)
            )[:, :, None]
    fns["library"] = lambda: x[r, cols]
    fns["plain"] = lambda: ow.gather_hit_windows_reference(
        x, starts, sids, cps, WINDOW, PRE, True)
    times = _rounds(fns, iters)
    useful, sectors = gather_traffic(x.shape, starts, sids, cps, WINDOW, PRE,
                                     True)
    return dict(ms=times, useful_bytes=useful, sector_bytes=sectors)


def bench_k4(x, starts, sids, cps=CHANNELS_PER_STREAM, iters=20,
             tag="") -> dict:
    """K4 on every route that takes the shape, at the rows the anatomy
    gives it (the block-aligned rows of ``starts``): bit-exact to plain and
    to K2's block-aligned windows, then timed."""
    t, c = x.shape
    rows8 = torch.clamp(starts - PRE, 0, t - WINDOW) // 8 * 8
    routes = ow.roll_routes(cps, WINDOW, x.data_ptr())
    plain = ow.gather_windows_roll_reference(x, rows8, sids, cps, WINDOW)
    block = ow.gather_hit_windows_reference(x, starts, sids, cps, WINDOW, PRE,
                                            False)
    check(torch.equal(plain[:, :, :cps].transpose(1, 2), block),
          f"K4's plain slabs differ from K2's block-aligned windows {tag}")
    for name, route in routes.items():
        got = ow._launch_roll(route, x, rows8, sids, cps, WINDOW)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"K4 {name} ({route.kernel.name}) "
              f"differs from plain {tag}")
    del plain, block, got
    fns = {name: (lambda r=route: ow._launch_roll(r, x, rows8, sids, cps,
                                                  WINDOW))
           for name, route in routes.items()}
    ri, ci = ow._roll_indices(rows8, sids, t, c, cps, WINDOW)
    ri, ci = ri[:, :, None], ci[:, None, :]
    fns["library"] = lambda: x[ri, ci]
    fns["plain"] = lambda: ow.gather_windows_roll_reference(
        x, rows8, sids, cps, WINDOW)
    times = _rounds(fns, iters)
    useful, sectors = roll_traffic(x.shape, rows8, sids, cps, WINDOW)
    return dict(ms=times, useful_bytes=useful, sector_bytes=sectors)


def summary(name: str, r: dict) -> str:
    """One line: each route's two times, the floors."""
    return (f"{name}: {_fmt(r['ms'])} ms; useful-bytes bound "
            f"{1e3 * r['useful_bytes'] / HBM_BPS:.4f} ms, sector floor "
            f"{1e3 * r['sector_bytes'] / HBM_BPS:.4f} ms")


def run(x: torch.Tensor, n_streams: int, g: int, log=print,
        iters: int = 20) -> dict:
    """Both gathers on both distributions at ``x``'s shape → ``{"k2":
    {"random": ..., "fleet": ...}, "k4": {...}}`` (see :func:`bench_k2`),
    each summarised through ``log``."""
    t, c = x.shape
    hits = {"random": random_hits(t, c, CHANNELS_PER_STREAM, g, 3, x.device),
            "fleet": fleet_hits(t, n_streams, x.device)}
    out = {"k2": {}, "k4": {}}
    for dist, (starts, sids) in hits.items():
        out["k2"][dist] = bench_k2(x, starts, sids, iters=iters, tag=dist)
        log(summary(f"K2 {dist} ({len(starts)} hits)", out["k2"][dist]))
        out["k4"][dist] = bench_k4(x, starts, sids, iters=iters, tag=dist)
        log(summary(f"K4 {dist} ({len(starts)} hits)", out["k4"][dist]))
    return out


def order_sweep(x, starts, sids, log=print, iters: int = 20) -> dict:
    """The routed K2 and K4 on the same hits in other orders (the output
    order follows): as given; sorted by start; by (start, stream); by
    (stream, start).  Apart from the order the hits reach the card in, the
    work is the same, so a difference is the memory system's (how often
    concurrent reads share a DRAM page).  Also times the sort itself."""
    t, c = x.shape
    cps = CHANNELS_PER_STREAM
    n_streams = c // cps
    key_ts = starts.long() * n_streams + sids.long()
    key_st = sids.long() * t + starts.long()
    orders = {"given": None, "start": torch.argsort(starts, stable=True),
              "start_stream": torch.argsort(key_ts),
              "stream_start": torch.argsort(key_st)}
    k2 = ow.gather_kernel_for(cps, WINDOW, x.data_ptr())
    k4 = ow.roll_kernel_for(cps, WINDOW, x.data_ptr())
    fns = {}
    for name, perm in orders.items():
        st = starts if perm is None else starts[perm].contiguous()
        si = sids if perm is None else sids[perm].contiguous()
        rows8 = torch.clamp(st - PRE, 0, t - WINDOW) // 8 * 8
        fns[f"k2_{name}"] = (lambda s=st, i=si: ow._launch_gather(
            k2, x, s, i, cps, WINDOW, PRE, True))
        fns[f"k4_{name}"] = (lambda r=rows8, i=si: ow._launch_roll(
            k4, x, r, i, cps, WINDOW))
    fns["argsort_start_stream"] = lambda: torch.argsort(key_ts)
    times = _rounds(fns, iters)
    log(f"orders: {_fmt(times)} ms")
    return times


def l2_resident(log=print, iters: int = 20) -> dict:
    """The random-hit times at an x the L2 holds: 32768 hits (the same 8.4M
    window rows, the same output) on x ``[2048, 4096]`` (32 MB, resident
    in the 50 MB L2 after the warm call).  Beside the fleet width's times
    it says how much of those is DRAM reading isolated sectors at random
    rather than the kernels' own issue and stores."""
    t, c, cps = 2048, 4096, CHANNELS_PER_STREAM
    x = torch.randn(t, c, device="cuda")
    starts, sids = random_hits(t, c, cps, 32768, 3, x.device)
    rows8 = torch.clamp(starts - PRE, 0, t - WINDOW) // 8 * 8
    fns = {}
    for name, r in ow.gather_routes(cps, WINDOW, x.data_ptr()).items():
        fns[f"k2_{name}"] = (lambda r=r: ow._launch_gather(
            r, x, starts, sids, cps, WINDOW, PRE, True))
    for name, r in ow.roll_routes(cps, WINDOW, x.data_ptr()).items():
        fns[f"k4_{name}"] = (lambda r=r: ow._launch_roll(
            r, x, rows8, sids, cps, WINDOW))
    times = _rounds(fns, iters)
    log(f"L2-resident x [{t}, {c}], {len(starts)} random hits: "
        f"{_fmt(times)} ms")
    return times


def granularity(x, g: int, log=print, iters: int = 20) -> dict:
    """The routed K2 on ``g`` random hits at cps = 1, 2, 4 and 8 (window rows
    of 4, 8, 16 and 32 bytes, one sector each) on the same x, beside a
    fill of each output (``out.zero_()``, the same bytes written): whether
    a random row costs by its bytes or as one unit."""
    t, c = x.shape
    out = {}
    for cps in (1, 2, 4, 8):
        starts, sids = random_hits(t, c, cps, g, 3, x.device)
        route = ow.gather_kernel_for(cps, WINDOW, x.data_ptr())
        windows = torch.empty((g, cps, WINDOW), device=x.device)
        times = _rounds({
            "gather": lambda r=route, s=starts, i=sids, k=cps: (
                ow._launch_gather(r, x, s, i, k, WINDOW, PRE, True)),
            "fill": windows.zero_}, iters)
        out[cps] = times
        log(f"cps={cps} ({route.kernel.name}): gather "
            f"{times['gather'][0]:.4f}/{times['gather'][1]:.4f} ms, output "
            f"fill {times['fill'][0]:.4f}/{times['fill'][1]:.4f} ms")
    return out


#: patched copies of the row-vector kernels that ``--variants`` times
#: beside them: name -> {source: [(text, replacement), ...]}
_K2, _K4 = "gather_vec.cu", "gather_roll_vec.cu"
_ROWS = [("constexpr int ROWS = 4;", "constexpr int ROWS = {};")]
VARIANTS = {
    # 8 rows (K2) or vectors (K4) per thread, 2 (K4) per thread
    "rows8": {src: [(a, b.format(8)) for a, b in _ROWS] for src in (_K2, _K4)},
    "rows2": {_K4: [(a, b.format(2)) for a, b in _ROWS]},
    # 128 threads per CTA
    "threads128": {src: [("constexpr int THREADS = 256;",
                          "constexpr int THREADS = 128;")]
                   for src in (_K2, _K4)},
    # streaming (evict-first) stores of the output
    "stcs": {_K2: [("*reinterpret_cast<float4*>(dst + (size_t)c * W + h) = o;",
                    "__stcs(reinterpret_cast<float4*>(dst + (size_t)c * W + "
                    "h), o);")],
             _K4: [("dst[t + k * per_hit] = v[k];",
                    "__stcs(dst + t + k * per_hit, v[k]);")]},
    # a persistent grid (8 CTAs per SM on 132 SMs) walking the items with
    # a grid-stride loop
    "persistent": {src: [
        ("    const int e = blockIdx.x * THREADS + threadIdx.x;\n"
         f"    if (e < n * {per}) {{",
         f"    for (int e = blockIdx.x * THREADS + threadIdx.x; e < n * {per};"
         "\n         e += gridDim.x * THREADS) {"),
        (f"{kern}<<<(int)((items + THREADS - 1) / THREADS),",
         f"{kern}<<<(int)((items + THREADS - 1) / THREADS < 1056 ? "
         "(items + THREADS - 1) / THREADS : 1056),")]
        for src, per, kern in ((_K2, "quads", "gather_vec_kernel<CPS>"),
                               (_K4, "per_hit", "gather_roll_vec_kernel<V>"))},
}


def variant_route(route: ow.Route, name: str) -> ow.Route:
    """``route`` with its kernel built from a patched copy (under the build
    directory) of its source."""
    from onset_fingerprinting_torch.ops import _cuda

    base = route.kernel
    src = (_cuda.CSRC / base.source).read_text()
    for old, new in VARIANTS[name][base.source]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name} no longer applies to "
                               f"{base.source}")
        src = src.replace(old, new)
    path = _cuda.BUILD_DIR / f"{base.name}_{name}.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return route._replace(kernel=_cuda.Kernel(f"{base.name}_{name}",
                                              str(path), base.entries))


def variant_sweep(x, n_streams, g, log=print, iters: int = 20) -> dict:
    """The row-vector K2 and K4 against each patched variant and the old
    kernel, bit-exact first, then timed on both distributions."""
    from onset_fingerprinting_torch.ops import _cuda

    t, c = x.shape
    cps = CHANNELS_PER_STREAM
    k2 = ow.gather_routes(cps, WINDOW, x.data_ptr())
    k4 = ow.roll_routes(cps, WINDOW, x.data_ptr())
    k2v = {n: variant_route(k2["vec"], n) for n in VARIANTS
           if _K2 in VARIANTS[n]}
    k4v = {n: variant_route(k4["vec"], n) for n in VARIANTS
           if _K4 in VARIANTS[n]}
    _cuda.build([r.kernel for r in (*k2v.values(), *k4v.values())])
    out = {}
    for dist, (starts, sids) in (
            ("random", random_hits(t, c, cps, g, 3, x.device)),
            ("fleet", fleet_hits(t, n_streams, x.device))):
        rows8 = torch.clamp(starts - PRE, 0, t - WINDOW) // 8 * 8
        k2p = ow.gather_hit_windows_reference(x, starts, sids, cps, WINDOW,
                                              PRE, True)
        k4p = ow.gather_windows_roll_reference(x, rows8, sids, cps, WINDOW)
        fns = {}
        for name, r in {"old": k2["old"], "vec": k2["vec"], **k2v}.items():
            check(torch.equal(ow._launch_gather(r, x, starts, sids, cps,
                                                WINDOW, PRE, True), k2p),
                  f"K2 variant {name} differs from plain")
            fns[f"k2_{name}"] = (lambda r=r, s=starts, i=sids:
                                 ow._launch_gather(r, x, s, i, cps, WINDOW,
                                                   PRE, True))
        for name, r in {"old": k4["old"], "vec": k4["vec"], **k4v}.items():
            check(torch.equal(ow._launch_roll(r, x, rows8, sids, cps, WINDOW),
                              k4p), f"K4 variant {name} differs from plain")
            fns[f"k4_{name}"] = (lambda r=r, s=rows8, i=sids:
                                 ow._launch_roll(r, x, s, i, cps, WINDOW))
        del k2p, k4p
        out[dist] = _rounds(fns, iters)
        log(f"variants, {dist}: {_fmt(out[dist])} ms")
    return out


def main() -> int:
    import subprocess

    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.workload import make_audio

    if not torch.cuda.is_available():
        raise SystemExit("gather_bench needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    logs = _cuda.build([_cuda.GATHER, _cuda.GATHER_VEC, _cuda.GATHER_ROLL,
                        _cuda.GATHER_ROLL_VEC])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    n_streams = 8192
    x = make_audio(32000, n_streams * CHANNELS_PER_STREAM, seed=4)
    say = lambda s: print(s, flush=True)  # noqa: E731
    out = run(x, n_streams, 32768, log=say)
    if "--orders" in sys.argv:
        for dist, hits in (
                ("random", random_hits(32000, x.shape[1], 4, 32768, 3,
                                       "cuda")),
                ("fleet", fleet_hits(32000, n_streams, "cuda"))):
            say(f"{dist}:")
            out[f"orders_{dist}"] = order_sweep(x, *hits, log=say)
    if "--granularity" in sys.argv:
        out["granularity"] = granularity(x, 32768, log=say)
    if "--l2" in sys.argv:
        out["l2_resident"] = l2_resident(log=say)
    if "--variants" in sys.argv:
        out["variants"] = variant_sweep(x, n_streams, 32768, log=say)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
