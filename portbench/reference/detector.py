"""The amplitude onset detector, written plainly in NumPy.

The algorithm (FluCoMa AmpSlice style, as the reference repository's
``detection.py`` describes it): a 4th-order Butterworth high-pass (direct
form II transposed), the rectified signal in dB clipped at a floor, a fast
and a slow attack/release envelope follower on it, their difference turned
back into a linear relative envelope, an EMA min/max tracker that scales
the on and off thresholds, and per block of samples a hysteresis gate with
a cooldown.  Channels are independent except for the off-gate of a
*coupled* detector, which per block ignores rows before the latest first
onset among the channels of one stream.

Every array is ``[T, L]`` or ``[L]``: L lanes, each lane one channel of one
stream, so that many (stream, call) pairs run in one pass.  ``q`` is the
rounding applied after every arithmetic operation: the identity for the
float32 reference, :func:`to_bf16` for the lower-precision control.  The
high-pass runs in float32 either way and only its output is rounded: in
bfloat16 its poles leave the unit circle and it diverges.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy import signal as _sig

F32 = np.float32
EPS = F32(1e-10)


def ident(a):
    return a


def to_bf16(a):
    """Round float32 values to the nearest bfloat16 (ties to even), kept in
    a float32 array."""
    a = np.array(a, dtype=np.float32)
    b = a.view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
         ) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


@dataclass(frozen=True)
class Detector:
    """The constants of one detector configuration (float32 where the
    algorithm computes in float32)."""

    block: int
    floor: float
    fa: float
    fr: float
    sa: float
    sr_: float
    on: float
    off: float
    cooldown: int
    am: float
    ax: float
    minmin: float
    coupled: bool
    b: tuple
    a: tuple

    @staticmethod
    def from_config(d: dict) -> "Detector":
        """From a configuration's ``detector`` section (keys of the
        reference's ``AmplitudeOnsetDetector``)."""
        if d.get("backtrack", False):
            raise ValueError("the reference detector has no backtracking")
        if max(np.atleast_1d(d["on_threshold"])) > 1:
            raise ValueError("manual thresholds are not part of this cell")
        if d["hipass_freq"]:
            b, a = _sig.butter(4, d["hipass_freq"], btype="high",
                               output="ba", fs=d["sr"])
            b, a = tuple(F32(v) for v in b), tuple(F32(v) for v in a)
        else:
            b, a = (), ()
        return Detector(
            block=int(d["block_size"]), floor=F32(d["floor"]),
            fa=F32(1.0 / d["fast_attack"]), fr=F32(1.0 / d["fast_release"]),
            sa=F32(1.0 / d["slow_attack"]), sr_=F32(1.0 / d["slow_release"]),
            on=F32(d["on_threshold"]), off=F32(d["off_threshold"]),
            cooldown=int(d["cooldown"]), am=F32(d["minmax_alpha_min"]),
            ax=F32(d["minmax_alpha_max"]), minmin=F32(d["minmax_floor"]),
            coupled=bool(d["coupled_off_gate"]), b=b, a=a)


def init_state(det: Detector, lanes: int) -> dict:
    """The detector's start: envelopes at the floor, the tracker at
    (0, 10), the gate open, no cooldown."""
    f = lambda v: np.full(lanes, v, np.float32)  # noqa: E731
    return dict(zi=np.zeros((len(det.b) - 1 if det.b else 0, lanes),
                            np.float32),
                fast=f(det.floor), slow=f(det.floor), min_val=f(0.0),
                max_val=f(10.0), gate=np.zeros(lanes, bool),
                prev_rel=f(0.0), debounce=np.zeros(lanes, np.int32))


def _highpass(det: Detector, x, zi, q=ident):
    if not det.b:
        return x, zi
    b, a = det.b, det.a
    order = len(b) - 1
    z = [zi[i].copy() for i in range(order)]
    y = np.empty_like(x)
    for t in range(x.shape[0]):
        xt = x[t]
        yt = q(q(b[0] * xt) + z[0])
        for i in range(order - 1):
            z[i] = q(q(q(b[i + 1] * xt) + z[i + 1]) - q(a[i + 1] * yt))
        z[order - 1] = q(q(b[order] * xt) - q(a[order] * yt))
        y[t] = yt
    return y, np.stack(z)


def scan(det: Detector, st: dict, x: np.ndarray, q=ident):
    """The per-sample chains over ``x [T, L]`` from ``st``: returns the new
    (zi, fast, slow, min_val, max_val), the relative envelope ``[T, L]``
    and the tracker's values at the end of every block."""
    x = np.asarray(x, np.float32)
    y, zi = _highpass(det, x, st["zi"])
    y = q(y)
    k_db = F32(20.0 / math.log2(10.0))
    k_lin = F32(math.log2(10.0) / 20.0)
    xdb = np.maximum(q(k_db * q(np.log2(np.abs(q(y + EPS))))), det.floor)
    xdb = q(xdb)
    fast, slow = st["fast"].copy(), st["slow"].copy()
    diff = np.empty_like(xdb)
    for t in range(xdb.shape[0]):
        df = q(q(xdb[t] - fast) + EPS)
        fast = q(fast + q(np.where(df > 0, det.fa, det.fr) * df))
        ds = q(q(xdb[t] - slow) + EPS)
        slow = q(slow + q(np.where(ds > 0, det.sa, det.sr_) * ds))
        diff[t] = q(fast - slow)
    rel = q(q(np.exp2(q(diff * k_lin))) - EPS)
    rel = np.clip(rel, F32(0.0), -det.floor).astype(np.float32)
    mn, mx = st["min_val"].copy(), st["max_val"].copy()
    iam, iax = F32(1.0) - det.am, F32(1.0) - det.ax
    nb = x.shape[0] // det.block
    mins = np.empty((nb, x.shape[1]), np.float32)
    maxs = np.empty_like(mins)
    for t in range(rel.shape[0]):
        r = rel[t]
        mn = np.where(r < det.minmin, det.minmin,
                      np.where(r < mn, r, q(q(mn * iam) + q(r * det.am))))
        mx = np.where(r > mx, r, q(q(mx * iax) + q(r * det.ax)))
        if (t + 1) % det.block == 0:
            mins[t // det.block] = mn
            maxs[t // det.block] = mx
    return (zi, fast, slow, mn.astype(np.float32), mx.astype(np.float32)), \
        rel, mins, maxs


def warmup(det: Detector, st: dict, x: np.ndarray, q=ident) -> dict:
    """Advance the filter, envelopes and tracker over the lead-in ``x``
    without detecting."""
    (zi, fast, slow, mn, mx), _, _, _ = scan(det, st, x, q)
    return dict(st, zi=zi, fast=fast, slow=slow, min_val=mn, max_val=mx)


def detect(det: Detector, st: dict, x: np.ndarray, q=ident,
           group: int = 1):
    """Detect over ``x [T, L]`` (T a multiple of the block) from ``st`` →
    ``(new state, on [nb, L] bool, deltas [nb, L] int32)``.  ``group``: the
    channels of one stream (consecutive lanes) that a coupled off-gate
    couples."""
    (zi, fast, slow, mn, mx), rel, mins, maxs = scan(det, st, x, q)
    bsz = det.block
    nb, lanes = mins.shape
    gate, debounce = st["gate"].copy(), st["debounce"].copy()
    prev = st["prev_rel"].copy()
    ons = np.zeros((nb, lanes), bool)
    deltas = np.zeros((nb, lanes), np.int32)
    rows = np.arange(bsz)[:, None]
    for k in range(nb):
        r = rel[k * bsz:(k + 1) * bsz]
        on_th = q(q(maxs[k] * det.on) + mins[k])
        off_th = q(q(maxs[k] * det.off) + mins[k])
        prev_full = np.concatenate([prev[None], r[:-1]])
        crossed = ((r > on_th) & ~gate & (debounce < 1)
                   & (prev_full < on_th))
        on = crossed.any(axis=0)
        idx = np.where(on, np.argmax(crossed, axis=0), 0)
        gate = gate | on
        debounce = np.where(on, det.cooldown, debounce)
        debounce = np.where(debounce > 0, debounce - bsz,
                            debounce).astype(np.int32)
        off = r < off_th
        if det.coupled:
            first = idx.reshape(-1, group).max(axis=1).repeat(group)
            off &= rows >= first
        else:
            off &= rows >= idx
        gate = np.where(off.any(axis=0), False, gate)
        ons[k], deltas[k] = on, idx
        prev = r[-1]
    new = dict(zi=zi, fast=fast, slow=slow, min_val=mn, max_val=mx,
               gate=gate, prev_rel=prev.astype(np.float32),
               debounce=debounce.astype(np.int32))
    return new, ons, deltas
