"""The injected-hit fleet workload and its correctness gate.

Port of bench.py:55-73, 129-161, 383-387 and 407-430: many 4-channel
96 kHz streams carry a synthetic drum hit every ``HIT_PERIOD`` samples on
top of low-level noise; a detector is correct when it finds every injected
onset (recall) and nothing else (precision).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.ops.windows import top_hit_blocks

SR = 96000
CHANNELS_PER_STREAM = 4
WINDOW = 256  # reference flagship window (train.py:27 w=256)
PRE = 64  # samples before the onset in the fingerprint window
MAX_HITS = 16  # per-stream hit capacity per second of audio

# Injected hit grid: onsets at HIT_FIRST + k*HIT_PERIOD; a burst is injected
# only if it fully fits (onset + BURST_LEN + BURST_MARGIN <= t).
HIT_FIRST = 5000
HIT_PERIOD = 9600  # one hit every 100 ms at 96 kHz
BURST_LEN = 600
BURST_MARGIN = 100
#: distance (samples) within which a detected hit block matches the grid
MATCH_TOL = 512

#: the flagship CCCNN (bench.py:249-267): 7 conv layers, widths 1→5…5
FLAGSHIP = dict(
    output_size=2,
    channels=CHANNELS_PER_STREAM,
    layer_sizes=(5,) * 7,
    kernel_sizes=(1, 33, 64, 15, 15, 15, 1),
    dropout_rate=0.0,
    cc_impl="dft",
    cc_norm=True,
)


def n_injected(t: int) -> int:
    """Number of injected onsets per stream in ``t`` samples."""
    return max((t - HIT_FIRST - BURST_LEN - BURST_MARGIN) // HIT_PERIOD + 1, 0)


def chunk_capacities(n_streams: int, chunk_samples: int) -> tuple[int, int]:
    """``(max_hits, global_capacity)`` for one chunk (bench.py:383-387):
    the per-stream capacity scales with the chunk's duration (1.6x
    headroom over 10 hits/s, at least 4); the global budget has 1.33x
    headroom over the injected hits, rounded up to 128."""
    max_hits = max(math.ceil(MAX_HITS * chunk_samples / SR), 4)
    expected = n_streams * n_injected(chunk_samples)
    return max_hits, -(-(expected * 4 // 3) // 128) * 128


def hit_profile(t: int, device=None) -> torch.Tensor:
    """The injected burst train ``[t]`` float32 (bench.py:146-158)."""
    dev = resolve_device(device)
    tt = torch.arange(BURST_LEN, device=dev, dtype=torch.float32)
    burst = (torch.sin(2 * math.pi * 5000 / SR * tt) * torch.exp(-tt / 150)
             * 0.5)
    pattern = torch.cat([burst, torch.zeros(HIT_PERIOD - BURST_LEN,
                                            device=dev)])
    idx = torch.arange(t, device=dev) - HIT_FIRST
    phase = torch.remainder(idx, HIT_PERIOD)
    fit = t - (HIT_FIRST + BURST_LEN + BURST_MARGIN)
    return torch.where((idx >= 0) & (idx - phase <= fit), pattern[phase],
                       0.0)


def make_audio(t: int, c: int, seed: int = 0, device=None) -> torch.Tensor:
    """Fleet audio ``[t, c]`` float32 made on the device: Gaussian noise at
    1e-3 from a seeded ``torch.Generator`` plus the hit train on every
    channel."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((t, c), generator=g, device=dev, dtype=torch.float32)
    x.mul_(1e-3)
    x.add_(hit_profile(t, dev)[:, None])
    return x


def correctness(on: torch.Tensor, block_size: int, n_streams: int,
                max_hits: int, t: int) -> tuple[int, int, int]:
    """``(true positives, spurious, matched)`` of the detected hit blocks
    against the injected grid (bench.py:408-430).  A hit block is a true
    positive iff it lies within ``MATCH_TOL`` of the grid; recall counts
    distinct injected onsets matched."""
    n_exp = n_injected(t)
    starts, valid = top_hit_blocks(on, block_size, n_streams, max_hits)
    rel = torch.remainder(starts - HIT_FIRST, HIT_PERIOD)
    dist = torch.minimum(rel, HIT_PERIOD - rel)
    tp = valid & (dist <= MATCH_TOL)
    spurious = valid & ~tp
    k_idx = torch.round((starts - HIT_FIRST) / HIT_PERIOD).to(torch.int64)
    k_ok = tp & (k_idx >= 0) & (k_idx < n_exp)
    hit = torch.zeros((n_streams, n_exp + 1), dtype=torch.bool,
                      device=on.device)
    hit.scatter_(1, torch.where(k_ok, k_idx, n_exp), True)
    matched = hit[:, :n_exp].sum()
    return int(tp.sum()), int(spurious.sum()), int(matched)


def cccnn_flax_params(config: dict, seed: int = 0,
                      window: int = WINDOW) -> dict:
    """Random parameters in flax layout (numpy) for the CCCNN built from
    ``config`` (keyword arguments of ``models.cccnn.CCCNN``) on windows of
    ``window`` samples: LeCun-normal conv and dense kernels, drawn in that
    order from one seeded generator; zero biases; GroupNorm scale 1 and
    bias 0.  The repo ships no trained checkpoint."""
    shape = CCCNN(input_size=window, **config)
    rng = np.random.default_rng(seed)
    stack = {}
    for i, conv in enumerate(shape.convs):
        o, cin, k = conv.weight.shape
        stack[f"Conv_{i}"] = {
            "kernel": (rng.standard_normal((k, cin, o)) / np.sqrt(k * cin))
            .astype(np.float32),
            "bias": np.zeros(o, np.float32),
        }
    for i, norm in enumerate(shape.norms):
        stack[f"GroupNorm_{i}"] = {
            "scale": np.ones(norm.num_channels, np.float32),
            "bias": np.zeros(norm.num_channels, np.float32),
        }
    dense_in, out = shape.fc.in_features, shape.fc.out_features
    dense = {
        "kernel": (rng.standard_normal((dense_in, out)) / np.sqrt(dense_in))
        .astype(np.float32),
        "bias": np.zeros(out, np.float32),
    }
    return {"params": {"_ConvStack_0": stack, "Dense_0": dense}}


def flagship_flax_params(seed: int = 0, window: int = WINDOW) -> dict:
    """Random flagship CCCNN parameters in flax layout (see
    :func:`cccnn_flax_params`)."""
    return cccnn_flax_params(FLAGSHIP, seed, window)
