"""Streaming cross-correlation correctness and speed (port of
examples/cc_bench.py).

Streams sine + noise through ``ops.xcorr.streaming_cc_update``, compares
every 50th block's full CC against ``np.correlate(mode='full')`` (the
reference harness's check, at its bar of 1e-3), times numpy's dense
recompute, the per-block update over ``--pairs`` sensor pairs (one host to
device copy and one update a block) and ``streaming_cc_scan`` over all the
blocks at once.

No TPU kernel computes this (the JAX example runs jitted XLA) and the port
writes none: every time here is plain PyTorch (cuFFT and elementwise
kernels) on ``device``, by the host clock around a synchronised run.

Run: python -m onset_fingerprinting_torch.tools.cc_bench [--cpu]
[--pairs 64] [--n 256] [--block 64] [--blocks 2000]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.ops.xcorr import (
    streaming_cc_init,
    streaming_cc_scan,
    streaming_cc_update,
)

#: the reference harness's bar on |CC - np.correlate|
BAR = 1e-3


def signals(n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """The demo's two streams: 300 Hz sines half a radian apart plus
    uniform noise, from numpy's legacy generator seeded 0."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 10, n_samples)
    a = (np.sin(2 * np.pi * t * 300) + 0.01 * rs.rand(n_samples)
         ).astype(np.float32)
    b = (np.sin(2 * np.pi * t * 300 + 0.5) + 0.01 * rs.rand(n_samples)
         ).astype(np.float32)
    return a, b


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def correctness(a, b, n: int, block: int, dev) -> tuple[float, int]:
    """One pair, block by block on ``dev``; every 50th block (once the
    window is full) against ``np.correlate`` → (max |err|, blocks
    checked)."""
    state = streaming_cc_init(n, device=dev)
    max_err, checked = 0.0, 0
    for i in range(0, len(a) - block + 1, block):
        state, res = streaming_cc_update(
            state, torch.as_tensor(a[i : i + block]).to(dev),
            torch.as_tensor(b[i : i + block]).to(dev))
        if i >= n and (i // block) % 50 == 0:
            lo = i + block - n
            golden = np.correlate(a[lo : i + block], b[lo : i + block],
                                  "full")
            max_err = max(max_err, float(np.max(np.abs(
                res.cpu().numpy() - golden))))
            checked += 1
    return max_err, checked


def numpy_recompute(a, b, n: int, block: int) -> float:
    """The reference harness's baseline: numpy's dense recompute of every
    window (seconds)."""
    t0 = time.perf_counter()
    for i in range(n - block, len(a) - block + 1, block):
        np.correlate(a[i - (n - block) : i + block],
                     b[i - (n - block) : i + block], "full")
    return time.perf_counter() - t0


def pair_streams(a, b, pairs: int) -> tuple[np.ndarray, np.ndarray]:
    """``pairs`` independent pairs: the streams rolled by 0 .. pairs-1."""
    return (np.stack([np.roll(a, k) for k in range(pairs)]),
            np.stack([np.roll(b, k) for k in range(pairs)]))


def per_block(ab, bb, n: int, block: int, dev) -> tuple[float, torch.Tensor]:
    """Every block of every pair through one update, one host to device
    copy of the block each (seconds, the last CC ``[pairs, 2n-1]``)."""
    p = ab.shape[0]
    state = streaming_cc_init(n, (p,), device=dev)
    streaming_cc_update(state, torch.as_tensor(ab[:, :block]).to(dev),
                        torch.as_tensor(bb[:, :block]).to(dev))  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(0, ab.shape[1] - block + 1, block):
        state, r = streaming_cc_update(
            state, torch.as_tensor(ab[:, i : i + block]).to(dev),
            torch.as_tensor(bb[:, i : i + block]).to(dev))
    float(r.sum())
    return time.perf_counter() - t0, r


def blocks(ab, bb, block: int, device="cpu"
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pairs' whole blocks as ``[nb, pairs, block]`` tensors on
    ``device``, the scan's input."""
    p = ab.shape[0]
    usable = (ab.shape[1] // block) * block
    return tuple(torch.as_tensor(np.ascontiguousarray(
        v[:, :usable].reshape(p, -1, block).swapaxes(0, 1))).to(device)
        for v in (ab, bb))


def scan(ab, bb, n: int, block: int, dev) -> tuple[float, torch.Tensor]:
    """All blocks at once from the device (``streaming_cc_scan``), timed
    on its second run (seconds, the CCs ``[nb, pairs, 2n-1]``)."""
    blocks_a, blocks_b = blocks(ab, bb, block, dev)
    state = streaming_cc_init(n, (ab.shape[0],), device=dev)
    streaming_cc_scan(state, blocks_a, blocks_b)
    _sync(dev)
    t0 = time.perf_counter()
    _, ccs = streaming_cc_scan(state, blocks_a, blocks_b)
    float(ccs[-1].sum())
    return time.perf_counter() - t0, ccs


def run(n: int = 256, block: int = 64, n_blocks: int = 2000,
        pairs: int = 64, device=None, log=print) -> dict:
    """The demo's four runs on ``device`` (None = the card)."""
    dev = resolve_device(device)
    a, b = signals(block * n_blocks)
    max_err, checked = correctness(a, b, n, block, dev)
    log(f"correctness: max |err| {max_err:.2e} over {checked} checked "
        f"blocks ({'OK' if max_err < BAR else 'FAIL'} @ {BAR:g}, the "
        "reference's bar)")
    t_np = numpy_recompute(a, b, n, block)
    log(f"numpy dense recompute: {t_np:.3f}s for {n_blocks} blocks")
    ab, bb = pair_streams(a, b, pairs)
    t_dev, last = per_block(ab, bb, n, block, dev)
    log(f"{dev.type} streaming CC (per-block dispatch, plain PyTorch): "
        f"{t_dev:.3f}s for {n_blocks} blocks x {pairs} pairs -> "
        f"{n_blocks * pairs / t_dev:.0f} block-updates/s")
    t_scan, ccs = scan(ab, bb, n, block, dev)
    log(f"{dev.type} streaming CC (streaming_cc_scan, plain PyTorch): "
        f"{t_scan:.3f}s -> {n_blocks * pairs / t_scan:.0f} block-updates/s "
        f"({t_np / (t_scan / pairs):.1f}x numpy per pair)")
    return dict(max_err=max_err, checked=checked, last=last, ccs=ccs,
                seconds=dict(numpy=t_np, per_block=t_dev, scan=t_scan))


def gate(res: dict) -> bool:
    return res["checked"] > 0 and res["max_err"] < BAR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=2000,
                    help="number of blocks to stream")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)
    res = run(args.n, args.block, args.blocks, args.pairs,
              "cpu" if args.cpu else None)
    return 0 if gate(res) else 1


if __name__ == "__main__":
    sys.exit(main())
