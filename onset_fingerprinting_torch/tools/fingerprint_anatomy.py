"""Device-only anatomy of the fingerprint stage (port of
``examples/fingerprint_anatomy.py``).

Times each component of the fleet path's fingerprint half, per chunk, at
bench.py's operating point (8192 four-channel streams, chunks of 32000
samples, a 32768-slot compacted global hit list), on synthetic events: the
bench hit grid on channel 0 of each stream, at most ``MAX_HITS`` hits per
stream.  Each row is the median over ``iters`` iterations of one call, timed
with CUDA events on the card (the host clock on the CPU); every iteration
draws new audio from a seeded generator and shifts the hit grid by one
block, after one untimed warm-up iteration.

Rows: ``top_hit_blocks``, ``compact_hit_list``, ``gather`` (kernel K2,
sample-anchored), ``gather_roll_raw_NW8`` (kernel K4),
``gather_roll_+transpose`` (K4, then ``[:, :, :cps].transpose(1, 2)``
materialised), ``model_apply`` (the flagship CCCNN in bfloat16),
``model_apply_pairs`` (the same with ``cc_pairs='all'``,
``cc_pair_lags=112``), ``model_conv_stack`` (K3 alone),
``model_conv_stack_cudnn`` (the same stack as an ``F.conv1d`` chain),
``model_dft_cc`` (the DFT self-correlation alone, at the bf16 model's
precision: one bf16 pass accumulating in f32), ``model_dft_cc_f32`` (the
same head in full f32, as the bf16 model ran it before it took the JAX
package's precision) and ``model_dft_cc_contiguous`` (the bf16 head on a
contiguous copy of the features instead of the conv stack's transposed
view; the copy itself is not timed).

The example's TPU-only rows are left out: the gather's MXU precision
variants, its DMA ring-depth sweep (``gather_nbuf*``), its grouped-step
sweep (``gather_mh*``) and the Toeplitz conv stacks
(``model_conv_stack_mxu*``).  They tune TPU tilings of functions that the
port computes once, exactly.

Built in: K4's windows, sliced and transposed, must equal K2's
block-aligned windows bit for bit (the relation the example relies on); a
mismatch raises.

Run: ``python -m onset_fingerprinting_torch.tools.fingerprint_anatomy``
(on the card; ``--cpu`` for a small run of the plain versions).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops.conv_stack import conv_stack
from onset_fingerprinting_torch.ops.windows import (
    compact_hit_list,
    gather_hit_windows,
    gather_windows_roll,
    top_hit_blocks,
)
from onset_fingerprinting_torch.ops.xcorr import batch_self_correlate_dft
from onset_fingerprinting_torch.workload import (
    CHANNELS_PER_STREAM,
    FLAGSHIP,
    HIT_FIRST,
    HIT_PERIOD,
    PRE,
    WINDOW,
    cccnn_flax_params,
    n_injected,
)

CPS = CHANNELS_PER_STREAM
BLOCK = 128
MAX_HITS = 6  # per-stream capacity per chunk (fingerprint_anatomy.py:37)
#: the pair-correlation head of the example (fingerprint_anatomy.py:182)
PAIR_HEAD = dict(cc_pairs="all", cc_pair_lags=112)
ROWS = (
    "top_hit_blocks", "compact_hit_list", "gather", "gather_roll_raw_NW8",
    "gather_roll_+transpose", "model_apply", "model_apply_pairs",
    "model_conv_stack", "model_conv_stack_cudnn", "model_dft_cc",
    "model_dft_cc_f32", "model_dft_cc_contiguous",
)


def hit_grid(chunk: int, n_streams: int, shift: int, device) -> torch.Tensor:
    """Dense events ``[chunk/128, S*cps]``: the bench hit grid, moved
    ``shift`` blocks later, on channel 0 of every stream."""
    on = torch.zeros((chunk // BLOCK, n_streams * CPS), dtype=torch.bool,
                     device=device)
    for k in range(n_injected(chunk)):
        on[(HIT_FIRST + HIT_PERIOD * k) // BLOCK + shift, ::CPS] = True
    return on


def _model(config: dict, device) -> CCCNN:
    model = CCCNN(input_size=WINDOW, dtype=torch.bfloat16, **config)
    model.load_state_dict(cccnn_state_dict_from_flax(
        cccnn_flax_params(config, seed=0)))
    return model.to(device).eval()


def _timed(fn, device):
    """``(ms, result)`` of one call: CUDA events on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t0), out


def main(device=None, n_streams: int = 8192, chunk: int = 32000,
         capacity: int = 32768, iters: int = 5,
         outputs: dict | None = None) -> dict[str, float]:
    """Per-chunk ms of each row (see the module docstring), median over
    ``iters``.  ``outputs``, when given, receives the last iteration's
    ``preds`` and ``preds_pairs`` (``[capacity, 2]``), the head's input
    ``feats`` (``[capacity, C, K, V]``) and its bf16 output ``cc``."""
    dev = resolve_device(device)
    t = chunk
    model = _model(FLAGSHIP, dev)
    model_pairs = _model(dict(FLAGSHIP, **PAIR_HEAD), dev)
    ws = [m.weight for m in model.convs]
    bs = [m.bias for m in model.convs]
    gen = torch.Generator(device=dev)
    times = {name: [] for name in ROWS}
    for it in range(iters + 1):  # iteration 0 warms up, untimed
        gen.manual_seed(it)
        x = torch.randn((t, n_streams * CPS), generator=gen, device=dev)
        on = hit_grid(t, n_streams, it, dev)
        row = {}

        def run(name, fn):
            row[name], out = _timed(fn, dev)
            return out

        with torch.inference_mode():
            st_pad, v_pad = run("top_hit_blocks", lambda: top_hit_blocks(
                on, BLOCK, n_streams, MAX_HITS))
            starts, sids, _, dropped = run(
                "compact_hit_list",
                lambda: compact_hit_list(st_pad, v_pad, capacity))
            if int(dropped):
                raise RuntimeError(f"hit list dropped {int(dropped)} hits "
                                   f"(capacity {capacity})")
            windows = run("gather", lambda: gather_hit_windows(
                x, starts, sids, CPS, WINDOW, PRE, anchored=True))
            rows8 = torch.clamp(starts - PRE, 0, t - WINDOW) // 8 * 8
            run("gather_roll_raw_NW8", lambda: gather_windows_roll(
                x, rows8, sids, CPS, WINDOW))
            rolled = run("gather_roll_+transpose", lambda: gather_windows_roll(
                x, rows8, sids, CPS, WINDOW)[:, :, :CPS].transpose(1, 2)
                .contiguous())
            block = gather_hit_windows(x, starts, sids, CPS, WINDOW, PRE,
                                       anchored=False)
            if not torch.equal(rolled, block):
                raise RuntimeError(
                    "roll-gather windows differ from the block-aligned "
                    "gather's")
            preds = run("model_apply", lambda: model(windows))
            preds_pairs = run("model_apply_pairs", lambda: model_pairs(windows))
            feats = run("model_conv_stack", lambda: conv_stack(
                windows.reshape(-1, WINDOW), ws, bs, model.padding,
                model.activation, model.dtype))
            run("model_conv_stack_cudnn", lambda: model.chain_features(
                windows))
            # the head's input as the model builds it: [G, C, K, V]
            feats = feats.reshape(capacity, CPS, *feats.shape[1:]).transpose(
                2, 3)
            cc = run("model_dft_cc", lambda: batch_self_correlate_dft(
                feats, sum_axis=2, precision="default"))
            run("model_dft_cc_f32", lambda: batch_self_correlate_dft(
                feats, sum_axis=2))
            contiguous = feats.contiguous()
            run("model_dft_cc_contiguous", lambda: batch_self_correlate_dft(
                contiguous, sum_axis=2, precision="default"))
            del contiguous
        if it:
            for name in ROWS:
                times[name].append(row[name])
    if outputs is not None:
        outputs.update(preds=preds, preds_pairs=preds_pairs, feats=feats,
                       cc=cc)
    return {name: float(np.median(v)) for name, v in times.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU at 32 streams")
    args = ap.parse_args()
    kw = (dict(device="cpu", n_streams=32, chunk=20480, capacity=128)
          if args.cpu else {})
    for name, ms in main(**kw).items():
        print(f"{name:24s} {ms:9.3f} ms")
