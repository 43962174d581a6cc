"""The realtime engine's per-block step on the card, K1 and the locate
kernel (with the ring write, where the checkout folds it in).

At the engine's configuration (``tools/realtime_sim``: 3 sensors, 128-sample
blocks, coupled K1, the locate kernel) over the first seconds of the
synthetic stream:

- the captured step's graph: its nodes by type (kernel, memcpy, ...) and
  its kernels, read through libcuda's graph calls (:func:`graph_nodes`)
  from the step captured as ``realtime/engine._GraphedStep`` captures it;
- the step's device time, per replay of the engine's own graph (each
  between CUDA events, the stream held back first, median and p99) and per
  step in one graph of 256 consecutive steps (:func:`graph_ms`);
- K1 at ``[128, 3]`` per launch in a graph of launches: the kernel the
  engine runs, ``detector.cu`` and an empty kernel;
- the locate kernel per launch in a graph of launches: on the stream's
  quiet blocks, and on its fired blocks in stream order, each from the
  state the one before left (the state restored before every replay);
  where the locate step takes the block (``block=``), also on the quiet
  blocks with the ring write, whose time is the difference;
- the locate kernel with CC refinement the same way (:func:`refine_times`),
  each fired block refining against its own window: a small ring of the
  stream's frames up to the block, written beforehand, so that the launch
  writes no ring and the same call runs on a checkout whose step writes
  its ring in another launch.

It reads the engine through the entry points that this package has had
since the engine was ported, so the same file measures an older checkout
too (copied into its ``tools/``).  Run on the card from the repository
root:

    python -m onset_fingerprinting_torch.tools.step_bench

It prints one JSON line last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import inspect
import json
import sys

import numpy as np
import torch

from onset_fingerprinting_torch.ops import _cuda


def graph_ms(calls, reps=20, before=None):
    """Device time per call of ``calls`` captured in order in one CUDA
    graph, replayed ``reps`` times, each replay between CUDA events (so no
    host time enters).  ``before()`` runs ahead of each replay, untimed."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    total = 0.0
    for r in range(reps + 1):
        if before is not None:
            before()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        if r:  # the first replay warms up
            total += s.elapsed_time(e)
    return total / (reps * len(calls))


def per_launch_ms(fn, n, backlog_cycles=1e8, chunk=200):
    """Median and p99 device time of ``fn(i)`` over ``n`` calls, each
    between its own CUDA events.  The calls go in chunks of ``chunk``, each
    chunk behind a spin kernel of ``backlog_cycles`` (1e8 ~ 50 ms), so that
    the host has enqueued a whole chunk before the card reaches it and the
    events read the card's time; in one long run the queue of pending
    launches fills and the card then waits for the host between calls."""
    d = []
    for base in range(0, n, chunk):
        m = min(chunk, n - base)
        st = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        en = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        torch.cuda.synchronize()
        torch.cuda._sleep(int(backlog_cycles))
        for i in range(m):
            st[i].record()
            fn(base + i)
            en[i].record()
        torch.cuda.synchronize()
        d += [a.elapsed_time(b) for a, b in zip(st, en)]
    return float(np.median(d)), float(np.percentile(d, 99))


_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "sem_signal", "sem_wait",
               "mem_alloc", "mem_free", "batch_mem_op", "conditional")


class _KernelParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS (v2) of libcuda
    _fields_ = [("func", ctypes.c_void_p)] + [
        (n, ctypes.c_uint) for n in ("gx", "gy", "gz", "bx", "by", "bz",
                                     "smem")] + [
        ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> tuple[dict, list]:
    """``({node type: count}, [kernel names])`` of a graph captured with
    ``keep_graph=True``, through libcuda's graph calls."""
    cu = ctypes.CDLL("libcuda.so.1")
    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(h, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types, names = collections.Counter(), []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kind = (_NODE_TYPES[t.value] if 0 <= t.value < len(_NODE_TYPES)
                else str(t.value))
        types[kind] += 1
        if kind == "kernel":
            p = _KernelParams()
            name = ctypes.c_char_p()
            rc = cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                  ctypes.byref(p))
            if rc == 0 and p.func:
                rc = cu.cuFuncGetName(ctypes.byref(name),
                                      ctypes.c_void_p(p.func))
            elif rc == 0 and p.kern:
                rc = cu.cuKernelGetName(ctypes.byref(name),
                                        ctypes.c_void_p(p.kern))
            names.append(name.value.decode() if rc == 0 and name.value
                         else "?")
    return dict(types), names


def _flat(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _flat(sub)]


def _capture_step(eng, state, block):
    """One step as ``_GraphedStep`` captures it: the step, then every new
    state tensor that is not the given one copied into it."""
    new, _ = eng._step(state, block, eng.params)
    for dst, src in zip(_flat(state), _flat(new)):
        if src is not dst:
            dst.copy_(src)


def step_graph(eng, blocks, steps=256):
    """Nodes of the engine's captured step, and its device time per step
    in one graph of ``steps`` consecutive steps over ``blocks``, on a copy
    of the engine's state."""
    from onset_fingerprinting_torch.realtime.engine import EngineState, _clone

    state = EngineState(*_clone(eng.state))
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        _capture_step(eng, state, blocks[0])
    types, names = graph_nodes(g)
    ms = graph_ms([lambda b=b: _capture_step(eng, state, b)
                   for b in blocks[:steps]], reps=5)
    return dict(types=types, nodes=sum(types.values()),
                kernels=dict(collections.Counter(names)), step_ms=ms)


def locate_calls(audio, blocks, seconds):
    """The locate kernel's inputs on the stream's first ``seconds``, from
    K1 (the routed kernel) one block per launch after the warmup, called as
    the engine's step calls it (``out=`` the state itself, where the
    checkout's K1 takes ``out``): the initial locator state and queue,
    ``(on, deltas, counter)`` of the quiet blocks (the first 64) and of the
    fired ones in stream order, and K1's ``(on [nb, 3], deltas [nb, 3],
    final state, warmed state)``."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.locate.multilaterate import (
        LocatorState,
        locator_init,
    )
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.ops.locate_block import EventQueue
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, st0, functional = make_fused_detector(cfg, emit_rel=False)
    warm = fused_warmup_minmax(fst, params, st0, torch.as_tensor(
        audio[: sim.WARMUP // 128 * 128], device="cuda"))
    in_place = "out" in inspect.signature(fused_detect_offline).parameters

    def run(det, x):
        if in_place:
            return fused_detect_offline(fst, params, det, x, False, out=det)
        return functional(det, x)

    i32 = dict(dtype=torch.int32, device="cuda")
    quiet, fired, ons, ds = [], [], [], []
    det = type(warm)(*(v.clone() for v in warm))
    for i in range(int(seconds * sim.SR) // 128):
        det, (on, d, _) = run(det, blocks[i])
        ons.append(on)
        ds.append(d)
        call = (on[0], d[0], torch.tensor(128 * i, **i32))
        if bool(on.any()):
            fired.append(call)
        elif len(quiet) < 64:
            quiet.append(call)
    lstate = LocatorState(*locator_init(8, "cuda"))
    queue = EventQueue(torch.zeros((sim.EVENT_QUEUE, 2), device="cuda"),
                       *(torch.zeros(sim.EVENT_QUEUE, **i32)
                         for _ in range(2)), torch.zeros((), **i32))
    return (lstate, queue, quiet, fired,
            (torch.cat(ons), torch.cat(ds), det, warm))


def k1_times(xb, launches=128, reverse=False):
    """K1 at the engine's shape ``xb [128, 3]``, per launch in a graph of
    ``launches`` bare launches (the state carried from one to the next):
    the routed kernel, the coupled pipe (named: the route gives it longer
    chunks), ``detector.cu`` and an empty kernel, in that order or
    ``reverse``."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.ops.fused_detector import (
        kernel_for,
        launch_args,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=False)
    out = {}
    kernels = [kernel_for(fst.plain), _cuda.DETECTOR_PIPE_COUPLED,
               _cuda.DETECTOR, None]
    _cuda.build(kernels[:-1])  # loaded where the caller has not
    for kern in kernels[::-1] if reverse else kernels:
        if kern is None:
            out["empty"] = graph_ms([lambda: _cuda.DETECTOR._lib.ofpt_empty(
                _cuda.stream())] * launches)
            continue
        kk, entry, a, _, keep = launch_args(fst, params, st0, xb, False,
                                            False, kern)
        fn = getattr(kk._lib, entry)
        out[kk.name] = graph_ms([lambda: fn(*a[:-1], _cuda.stream())]
                                * launches)
        del keep
    return out


def locate_times(lb, l0, q0, quiet, fired) -> dict:
    """The locate kernel per launch in a graph of launches: on the quiet
    blocks, and on the fired blocks in stream order, each from the state
    the one before left (restored before every replay).  Takes the
    kernel's in-place contract where it has one."""
    from onset_fingerprinting_torch.ops.locate_block import locate_block

    in_place = "out" in inspect.signature(locate_block).parameters
    work = [v.clone() for v in (*l0, *q0)] + [c.clone() for _, _, c in fired]
    pristine = [v.clone() for v in work]

    def restore():
        for w, p in zip(work, pristine):
            w.copy_(p)

    lw, qw = type(l0)(*work[:5]), type(q0)(*work[5:9])

    def step(l, q, on, d, count):
        if in_place:
            return locate_block(lb, l, q, on, d, count, out=(l, q, count))
        return locate_block(lb, l, q, on, d, count)

    def chain():
        lq = (lw, qw)
        for (on, d, _), count in zip(fired, work[9:]):
            lq = step(*lq, on, d, count)[:2]

    out = dict(
        quiet=graph_ms([lambda c=c: step(lw, qw, *c) for c in quiet]),
        fired=graph_ms([chain], before=restore) / len(fired),
        quiet_blocks=len(quiet), fired_blocks=len(fired), in_place=in_place)
    if "block" in inspect.signature(locate_block).parameters:
        # the quiet launches again with the ring write (into a ring of the
        # engine's 16 s), in turns with the bare ones
        from onset_fingerprinting_torch.core.ring_buffer import ring_init

        ring = ring_init(16 * 96000, (3,), device="cuda")
        xb = torch.zeros((128, 3), device="cuda")
        write = [graph_ms([lambda c=c: locate_block(
            lb, lw, qw, *c, ring, out=(lw, qw, c[2]), block=xb)
            for c in quiet])]
        bare = graph_ms([lambda c=c: step(lw, qw, *c) for c in quiet])
        write.append(graph_ms([lambda c=c: locate_block(
            lb, lw, qw, *c, ring, out=(lw, qw, c[2]), block=xb)
            for c in quiet]))
        out.update(quiet_write=float(np.mean(write)),
                   write=float(np.mean(write)) - (out["quiet"] + bare) / 2)
    return out


#: frames of the small rings the refinement is timed on (>= its window)
SMALL_RING = 1024


def small_ring(audio, end: int, cap: int = SMALL_RING):
    """A ring of ``cap`` frames on the card holding the stream's frames
    ``[end - cap, end)`` at their slots (frame s at s mod cap; zeros before
    the stream), its counter ``end``."""
    from onset_fingerprinting_torch.core.ring_buffer import ring_init

    ring = ring_init(cap, (audio.shape[1],), device="cuda")
    s = np.arange(end - cap, end)
    keep = s >= 0
    data = np.zeros((cap, audio.shape[1]), np.float32)
    data[s[keep] % cap] = audio[s[keep]]
    ring.data.copy_(torch.as_tensor(data))
    ring.counter.fill_(end)
    return ring


def refine_times(lb, l0, q0, quiet, fired, audio, block: int = 128) -> dict:
    """The locate kernel with CC refinement (``lb.cc_refine``) per launch
    in a graph of launches, as :func:`locate_times`: on the quiet blocks,
    and on the fired ones in stream order from the state the one before
    left, each call given a small ring of the stream up to its block's end
    (the ring as the step's write leaves it; no launch writes it)."""
    from onset_fingerprinting_torch.ops.locate_block import locate_block

    def with_rings(calls):
        return [(on, d, c.clone(), small_ring(audio, int(c) + block))
                for on, d, c in calls]

    quiet, fired = with_rings(quiet), with_rings(fired)
    work = [v.clone() for v in (*l0, *q0)] + [c.clone() for *_, c, _ in fired]
    pristine = [v.clone() for v in work]

    def restore():
        for w, p in zip(work, pristine):
            w.copy_(p)

    lw, qw = type(l0)(*work[:5]), type(q0)(*work[5:9])

    def chain():
        lq = (lw, qw)
        for (on, d, _, ring), count in zip(fired, work[9:]):
            lq = locate_block(lb, *lq, on, d, count, ring,
                              out=(*lq, count))[:2]

    return dict(
        quiet=graph_ms([lambda c=c: locate_block(
            lb, lw, qw, c[0], c[1], c[2], c[3], out=(lw, qw, c[2]))
            for c in quiet]),
        fired=graph_ms([chain], before=restore) / len(fired),
        quiet_blocks=len(quiet), fired_blocks=len(fired))


def main(argv=None) -> int:
    from onset_fingerprinting_torch.ops.locate_block import LocateBlock
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="the stream's first seconds for the locate kernel")
    ap.add_argument("--replays", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_bench: CUDA is not available", file=sys.stderr)
        return 2
    _cuda.build()
    res = {"device": torch.cuda.get_device_name(0)}

    audio, _, _ = sim.synth_stream(20.0, 0)
    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    eng = sim.build_engine(None)
    eng.warmup(audio[: sim.WARMUP])

    # the step: the engine's own graph per replay, then one graph of steps
    g = eng._graph

    def replay(i):
        g.block.copy_(blocks[i % len(blocks)])
        g.graph.replay()

    med, p99 = per_launch_ms(replay, args.replays)
    res["step"] = dict(replay_median_ms=med, replay_p99_ms=p99,
                       **step_graph(eng, blocks[sim.WARMUP // 128:]))
    print("step:", json.dumps(res["step"]), flush=True)
    res["k1"] = k1_times(blocks[len(blocks) // 2].contiguous())
    print("k1:", json.dumps(res["k1"]), flush=True)
    l0, q0, quiet, fired, _ = locate_calls(audio, blocks, args.seconds)
    res["locate"] = locate_times(LocateBlock(eng.locator, 3, 128,
                                             device="cuda"),
                                 l0, q0, quiet, fired)
    print("locate:", json.dumps(res["locate"]), flush=True)
    res["refine"] = refine_times(
        LocateBlock(eng.locator, 3, 128, cc_refine=True, device="cuda"),
        l0, q0, quiet, fired, audio)
    print("refine:", json.dumps(res["refine"]), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
