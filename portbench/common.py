"""Pieces the systems share: model weights from the seed, which calls are
kept for the check, and the compared numbers."""

from __future__ import annotations

import numpy as np
import torch

#: onsets past a stream's last event (the serve path's empty key)
EV_BIG = 2 ** 30


def cccnn_weights(model_cfg: dict, window: int, seed: int, device) -> dict:
    """Random CCCNN weights from ``seed`` in one draw on ``device``:
    normal conv weights at 2 / sqrt(fan-in) (SiLU halves a small signal,
    so at LeCun's 1 / sqrt(fan-in) seven layers leave the biases'
    constant and the output no longer depends on the window), a
    LeCun-normal dense layer, biases at 0.01 standard deviation.
    ``{"conv_w": [[O, I, K]], "conv_b": [[O]], "fc_w": [out, in], "fc_b":
    [out]}`` float32."""
    widths, kernels = model_cfg["layer_sizes"], model_cfg["kernel_sizes"]
    pad = model_cfg.get("padding", 1)
    shapes, cin, v = [], 1, window
    for o, k in zip(widths, kernels):
        shapes += [(o, cin, k), (o,)]
        cin, v = o, v + 2 * pad - (k - 1)
    c, out = model_cfg["channels"], model_cfg["output_size"]
    dense_in = c * (2 * v - 1) + c
    shapes += [(out, dense_in), (out,)]
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device=device)
    g.manual_seed((seed * 7919 + 17) % (2 ** 63))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    leaves, i = [], 0
    for n_leaf, s in enumerate(shapes):
        m = int(np.prod(s))
        t = flat[i:i + m].reshape(s)
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else 0
        gain = 2.0 if n_leaf < len(shapes) - 2 else 1.0
        leaves.append(t * gain / np.sqrt(fan_in) if fan_in else t * 0.01)
        i += m
    return {"conv_w": leaves[0:-2:2], "conv_b": leaves[1:-2:2],
            "fc_w": leaves[-2], "fc_b": leaves[-1]}


def state_dict_of(w: dict) -> dict:
    """The CCCNN module's ``state_dict`` keys for :func:`cccnn_weights`."""
    sd = {}
    for i, (cw, cb) in enumerate(zip(w["conv_w"], w["conv_b"])):
        sd[f"convs.{i}.weight"], sd[f"convs.{i}.bias"] = cw, cb
    sd["fc.weight"], sd["fc.bias"] = w["fc_w"], w["fc_b"]
    return sd


def to_cpu(w: dict) -> dict:
    return {k: ([t.detach().cpu() for t in v] if isinstance(v, list)
                else v.detach().cpu()) for k, v in w.items()}


class HostCopy:
    """The outputs of a call copied into host buffers allocated once
    (pinned on the card's host), so that every call's copy does the same
    work; ``copy(tensors, keep)`` returns host tensors, fresh ones where
    the call is kept for the check."""

    def __init__(self):
        self.bufs = None

    def copy(self, tensors, keep: bool) -> list:
        if self.bufs is None:
            self.bufs = [torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=t.is_cuda) for t in tensors]
        for b, t in zip(self.bufs, tensors):
            b.copy_(t)
        return [b.clone() for b in self.bufs] if keep else self.bufs


class KeepPlan:
    """Which calls keep their inputs and outputs for the check: call 0
    (the start) and about one in ``every`` others, drawn from the seed
    before any call runs; after the window, ``n`` of the kept calls drawn
    from the seed are checked."""

    def __init__(self, seed: int, every: int, n: int):
        self.rng = np.random.default_rng([seed, 1])
        self.n = n
        self.flags = self.rng.random(1 << 20) < 1.0 / every
        self.flags[0] = True

    def kept(self, i: int) -> bool:
        return bool(self.flags[i]) if i < len(self.flags) else False

    def choose(self, kept_calls) -> list:
        """Call 0 and ``n - 1`` others of ``kept_calls``."""
        rest = sorted(c for c in kept_calls if c != 0)
        k = min(self.n - 1, len(rest))
        pick = self.rng.choice(len(rest), size=k, replace=False) if k else []
        return [0] + sorted(rest[j] for j in pick)


def rel_gap(a, b) -> float:
    """Largest ``|a - b|`` over the scale of ``b`` (its largest magnitude),
    0 for two empty arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0 if a.size == 0 else float("inf")
    scale = float(np.max(np.abs(b)))
    d = np.abs(a - b)
    if not np.all(np.isfinite(d)):
        return float("inf")
    return float(np.max(d)) / max(scale, 1e-30)


def yard_gap(a, b, y, rms: bool = False) -> float:
    """The answers ``a``'s largest gap to the reference's ``b`` (with
    ``rms``, the gaps' root mean square) over the same of the yardstick
    ``y``: the reference's own answers one precision lower (float8) on the
    same windows.  The yardstick measures how far rounding moves these
    weights' answers, which differs from seed to seed by a factor of
    three, so that the ratio reads alike on every seed: a sound bfloat16
    program reads about a tenth, the float8 control exactly 1."""
    a, b, y = (np.asarray(v, np.float64) for v in (a, b, y))
    if b.size == 0:
        return 0.0
    d, e = np.abs(a - b), np.abs(y - b)
    if not np.all(np.isfinite(d)):
        return float("inf")
    if rms:
        return float(np.sqrt(np.mean(d * d)) / max(np.sqrt(np.mean(e * e)),
                                                   1e-30))
    return float(np.max(d)) / max(float(np.max(e)), 1e-30)
