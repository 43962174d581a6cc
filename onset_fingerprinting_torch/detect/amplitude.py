"""Multi-channel streaming amplitude onset detector in plain PyTorch.

Port of ``onset_fingerprinting_tpu.detect.amplitude`` (reference:
onset_fingerprinting/detection.py:595-888): FluCoMa-AmpSlice-style fast
minus slow AR envelope on rectified floor-clipped dB, adaptive min/max
thresholds, per-channel hysteresis, cooldown debounce and optional
backtracking, as a per-block step

    (state, block [B, C]) -> (state, (on [C], deltas [C], rel [B, C]))

Here the per-sample recurrences are a Python loop of element-wise tensor
ops over the samples, vectorised across channels.  This is the plain
version of the fused detector kernel (``ops/fused_detector.py``): every
sample runs the same float32 operations in the same order, so on the card
the kernel is bit-identical to it.  The kernel's wrappers count the
calls they make to it (``_cuda.Kernel.plain_calls``).

The host-facing wrappers (JAX amplitude.py:455-625) go through the fused
detector: :class:`AmplitudeOnsetDetector` (the reference's per-block call
contract) and :func:`detect_onsets_amplitude` (a whole recording, the
mining path), which on the card run K1 and on the CPU its plain version.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.tree import write_into
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.ops.filters import butterworth

_LOG2_10_OVER_20 = math.log2(10.0) / 20.0
_20_OVER_LOG2_10 = 20.0 / math.log2(10.0)
_EPS = 1e-10


def _f32(v: float) -> float:
    return float(np.float32(v))


class DetectorState(NamedTuple):
    """Carried streaming state (float32/int32/bool, shape [.., C])."""

    zi: torch.Tensor         # [order, C] high-pass filter state
    fast: torch.Tensor       # [C] fast AR envelope
    slow: torch.Tensor       # [C] slow AR envelope
    min_val: torch.Tensor    # [C] EMA minimum of relative envelope
    max_val: torch.Tensor    # [C] EMA maximum of relative envelope
    gate: torch.Tensor       # [C] bool hysteresis state
    prev_rel: torch.Tensor   # [C] last rel sample of the previous block
    debounce: torch.Tensor   # [C] int32 cooldown countdown
    bt_buffer: torch.Tensor  # [Nb, C] rel ring for backtracking (Nb may be 0)
    bt_pos: torch.Tensor     # scalar int32 ring cursor


@dataclass(frozen=True)
class _Static:
    """Static detector parameters (float32-rounded where the reference
    rounds them)."""

    n_channels: int
    block_size: int
    floor: float
    fast_attack: float
    fast_release: float
    slow_attack: float
    slow_release: float
    cooldown: int
    manual: bool
    use_hipass: bool
    backtrack: bool
    bt_size: int
    bt_alpha: float
    bt_tol: float
    alpha_min: float
    alpha_max: float
    minmin: float
    #: reference quirk (detection.py:790): the off-threshold check ignores
    #: rows before the block's cross-channel first-onset index.  False =
    #: per-channel gating, required when independent streams are batched
    #: as channels.
    coupled_off: bool = True


class DetectorParams(NamedTuple):
    on_threshold: torch.Tensor   # [C]
    off_threshold: torch.Tensor  # [C]
    b: torch.Tensor  # IIR numerator (unused when use_hipass=False)
    a: torch.Tensor  # IIR denominator


def _make_static(cfg: DetectorConfig) -> _Static:
    if cfg.backtrack and cfg.backtrack_buffer_size < cfg.block_size:
        # the reference asserts this too (detection.py:716-718)
        raise ValueError(
            f"backtrack_buffer_size ({cfg.backtrack_buffer_size}) must be "
            f">= block_size ({cfg.block_size}) when backtrack=True"
        )
    bt_alpha = np.float32(2.0 / (cfg.backtrack_smooth_size + 1))
    return _Static(
        n_channels=cfg.n_channels,
        block_size=cfg.block_size,
        floor=float(cfg.floor),
        fast_attack=_f32(1.0 / cfg.fast_attack),
        fast_release=_f32(1.0 / cfg.fast_release),
        slow_attack=_f32(1.0 / cfg.slow_attack),
        slow_release=_f32(1.0 / cfg.slow_release),
        cooldown=int(cfg.cooldown),
        manual=bool(np.max(cfg.on_threshold) > 1),
        use_hipass=cfg.hipass_freq != 0,
        backtrack=cfg.backtrack,
        bt_size=int(cfg.backtrack_buffer_size) if cfg.backtrack else 0,
        bt_alpha=float(bt_alpha),
        bt_tol=_f32((1 - bt_alpha) ** cfg.backtrack_buffer_size),
        alpha_min=float(cfg.minmax_alpha_min),
        alpha_max=float(cfg.minmax_alpha_max),
        minmin=float(cfg.minmax_floor),
        coupled_off=cfg.coupled_off_gate,
    )


def sample_constants(static: _Static) -> dict:
    """The float32 constants of the per-sample recurrences, shared by the
    plain loop and the kernel so that both use identical values."""
    am, ax = np.float32(static.alpha_min), np.float32(static.alpha_max)
    alpha = np.float32(static.bt_alpha)
    return dict(
        eps=_f32(_EPS), k_db=_f32(_20_OVER_LOG2_10),
        k_lin=_f32(_LOG2_10_OVER_20), floor=_f32(static.floor),
        fa=static.fast_attack, fr=static.fast_release,
        sa=static.slow_attack, sr=static.slow_release,
        am=float(am), ax=float(ax),
        iam=float(np.float32(1) - am), iax=float(np.float32(1) - ax),
        minmin=_f32(static.minmin),
        bt_alpha=float(alpha), bt_omba=float(np.float32(1) - alpha),
        bt_tol=_f32(static.bt_tol),
    )


def detector_init(
    cfg: DetectorConfig, device=None
) -> tuple[_Static, DetectorParams, DetectorState]:
    """Build (static config, params, initial state) on ``device`` (None =
    the card).  Initial values mirror detection.py:697-711: envelopes at
    ``floor``, min/max tracker at (0, 10)."""
    dev = resolve_device(device)
    static = _make_static(cfg)
    c = cfg.n_channels
    if static.use_hipass:
        iir = butterworth(cfg.hipass_freq, c, order=4, sr=cfg.sr,
                          btype="high", device=dev)
        b, a, zi = iir.b, iir.a, iir.zi
    else:
        b = torch.ones(1, dtype=torch.float32, device=dev)
        a = torch.ones(1, dtype=torch.float32, device=dev)
        zi = torch.zeros((0, c), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    params = DetectorParams(
        on_threshold=torch.as_tensor(cfg.on_threshold, **f32).expand(c)
        .contiguous(),
        off_threshold=torch.as_tensor(cfg.off_threshold, **f32).expand(c)
        .contiguous(),
        b=b,
        a=a,
    )
    state = DetectorState(
        zi=zi,
        fast=torch.full((c,), cfg.floor, **f32),
        slow=torch.full((c,), cfg.floor, **f32),
        min_val=torch.zeros((c,), **f32),
        max_val=torch.full((c,), 10.0, **f32),
        gate=torch.zeros((c,), dtype=torch.bool, device=dev),
        prev_rel=torch.zeros((c,), **f32),
        debounce=torch.zeros((c,), dtype=torch.int32, device=dev),
        bt_buffer=torch.zeros((static.bt_size, c), **f32),
        bt_pos=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return static, params, state


def iir_step(b: list, a: list, z: list, xt: torch.Tensor,
             use_hipass: bool):
    """One sample of the DF2T high-pass (identity when off) → ``(z, y)``."""
    if not use_hipass:
        return z, xt
    order = len(z)
    y = b[0] * xt + z[0]
    z = [
        (b[i + 1] * xt + z[i + 1] if i + 1 < order else b[i + 1] * xt)
        - a[i + 1] * y
        for i in range(order)
    ]
    return z, y


def db_step(k: dict, y: torch.Tensor) -> torch.Tensor:
    """Rectified floor-clipped dB of the filtered sample (no recurrence)."""
    xdb = k["k_db"] * torch.log2(torch.abs(y + k["eps"]))
    return torch.clamp(xdb, min=k["floor"])


def iir_db_step(k: dict, b: list, a: list, z: list, xt: torch.Tensor,
                use_hipass: bool):
    """One sample of the first chain: DF2T high-pass (identity when off)
    → rectified floor-clipped dB.  Returns ``(z, xdb)``."""
    z, y = iir_step(b, a, z, xt, use_hipass)
    return z, db_step(k, y)


def envelope_step(k: dict, yf: torch.Tensor, ys: torch.Tensor,
                  xdb: torch.Tensor):
    """One sample of the fast and slow AR envelopes → ``(yf, ys, their
    dB difference)``."""
    eps = k["eps"]
    df = xdb - yf + eps
    yf = yf + torch.where(df > 0, k["fa"], k["fr"]) * df
    ds = xdb - ys + eps
    ys = ys + torch.where(ds > 0, k["sa"], k["sr"]) * ds
    return yf, ys, yf - ys


def rel_step(k: dict, d: torch.Tensor) -> torch.Tensor:
    """The envelopes' dB difference → clipped linear relative envelope (no
    recurrence)."""
    rel = torch.exp2(d * k["k_lin"]) - k["eps"]
    return torch.clamp(rel, 0.0, -k["floor"])


def envelope_rel_step(k: dict, yf: torch.Tensor, ys: torch.Tensor,
                      xdb: torch.Tensor):
    """One sample of the second chain: fast and slow AR envelopes → clipped
    linear relative envelope.  Returns ``(yf, ys, rel)``."""
    yf, ys, d = envelope_step(k, yf, ys, xdb)
    return yf, ys, rel_step(k, d)


def minmax_step(k: dict, mn: torch.Tensor, mx: torch.Tensor,
                rel: torch.Tensor):
    """One sample of the third chain: the EMA min/max tracker."""
    mn = torch.where(
        rel < k["minmin"], k["minmin"],
        torch.where(rel < mn, rel, mn * k["iam"] + rel * k["am"]),
    )
    mx = torch.where(rel > mx, rel, mx * k["iax"] + rel * k["ax"])
    return mn, mx


def _fused_sample_scan(static: _Static, params: DetectorParams,
                       state: DetectorState, x: torch.Tensor):
    """One pass over the B samples of a block: IIR high-pass → rectified
    floor-clipped dB → fast & slow AR envelopes → relative envelope →
    EMA min/max (the three chains above, sample by sample).  Returns
    ((zi, fast, slow, min, max), rel [B, C])."""
    k = sample_constants(static)
    b = params.b.tolist()
    a = params.a.tolist()
    z = list(state.zi.unbind(0))
    yf, ys, mn, mx = state.fast, state.slow, state.min_val, state.max_val
    rels = []
    for xt in x.to(torch.float32).unbind(0):
        z, xdb = iir_db_step(k, b, a, z, xt, static.use_hipass)
        yf, ys, rel = envelope_rel_step(k, yf, ys, xdb)
        if not static.manual:
            mn, mx = minmax_step(k, mn, mx, rel)
        rels.append(rel)
    zi = torch.stack(z) if state.zi.shape[0] else state.zi
    return (zi, yf, ys, mn, mx), torch.stack(rels)


def _backtrack(static: _Static, buffer_lin: torch.Tensor,
               deltas: torch.Tensor) -> torch.Tensor:
    """Walk each onset backwards through the EMA-smoothed history while the
    envelope keeps decreasing (envelope_follower.c:59-85), for every
    channel at once (callers keep the channels that fired)."""
    k = sample_constants(static)
    n = static.bt_size
    alpha, omba, tol = k["bt_alpha"], k["bt_omba"], k["bt_tol"]
    c = buffer_lin.shape[1]
    chans = torch.arange(c, device=buffer_lin.device)
    i = static.block_size - deltas.long()
    cur = buffer_lin[(n - i) % n, chans]
    i = i + 1
    prev = buffer_lin[(n - i) % n, chans]  # negative index wraps, as in numpy
    prevs = alpha * prev + omba * cur
    d = deltas.clone()
    active = torch.ones(c, dtype=torch.bool, device=buffer_lin.device)
    for _ in range(n):
        go = active & (cur > prevs) & ((prevs - prev).abs() > tol) & (i + 1 < n)
        d = torch.where(go, d - 1, d)
        i = torch.where(go, i + 1, i)
        cur = torch.where(go, prevs, cur)
        new_prev = buffer_lin[torch.clamp(n - i, 0, n - 1), chans]
        prev = torch.where(go, new_prev, prev)
        prevs = torch.where(go, alpha * prev + omba * cur, prevs)
        active = go
    return d


def detect_block(static: _Static, params: DetectorParams,
                 state: DetectorState, x: torch.Tensor):
    """Process one ``[B, C]`` block → ``(state, (on [C] bool, deltas [C]
    int32, rel [B, C]))``: channel c fired iff ``on[c]``, at block-relative
    sample ``deltas[c]`` (detection.py:727-798)."""
    bsz = static.block_size
    (zi, yf, ys, mn, mx), rel = _fused_sample_scan(static, params, state, x)
    dev = rel.device
    if static.backtrack:
        nb = static.bt_size
        idx = (state.bt_pos + torch.arange(bsz, device=dev)) % nb
        bt_buffer = state.bt_buffer.clone()
        bt_buffer[idx] = rel
        bt_pos = ((state.bt_pos + bsz) % nb).to(torch.int32)
    else:
        bt_buffer, bt_pos = state.bt_buffer, state.bt_pos

    if static.manual:
        on_th, off_th = params.on_threshold, params.off_threshold
    else:
        on_th = mx * params.on_threshold + mn
        off_th = mx * params.off_threshold + mn

    crossed_on = (rel > on_th) & ~state.gate & (state.debounce < 1)
    prev_full = torch.cat([state.prev_rel[None], rel[:-1]], dim=0)
    crossed_on &= prev_full < on_th
    on = crossed_on.any(dim=0)
    # first crossing row, 0 where none (the argmax of the bool column)
    row = torch.arange(bsz, device=dev)[:, None]
    on_idx = torch.where(crossed_on, row, bsz).amin(dim=0)
    on_idx = torch.where(on, on_idx, 0).to(torch.int32)

    gate = state.gate | on
    debounce = torch.where(on, static.cooldown, state.debounce)
    debounce = torch.where(debounce > 0, debounce - bsz, debounce)
    debounce = debounce.to(torch.int32)

    crossed_off = rel < off_th
    if static.coupled_off:
        crossed_off &= row >= on_idx.max()
    else:
        crossed_off &= row >= on_idx[None, :]
    gate = torch.where(crossed_off.any(dim=0), False, gate)

    deltas = on_idx
    if static.backtrack:
        n = static.bt_size
        lin = (bt_pos + torch.arange(n, device=dev)) % n
        bt_deltas = _backtrack(static, bt_buffer[lin], deltas)
        deltas = torch.where(on, bt_deltas, deltas).to(torch.int32)

    new_state = DetectorState(
        zi=zi, fast=yf, slow=ys, min_val=mn, max_val=mx, gate=gate,
        prev_rel=rel[-1], debounce=debounce, bt_buffer=bt_buffer,
        bt_pos=bt_pos,
    )
    return new_state, (on, deltas, rel)


def warmup_minmax(static: _Static, params: DetectorParams,
                  state: DetectorState, x: torch.Tensor) -> DetectorState:
    """Warm up envelopes and min/max tracker on ``x [T, C]`` without
    detecting (detection.py:827-840).  T must be a multiple of the block
    size."""
    bsz = static.block_size
    for blk in x.reshape(-1, bsz, x.shape[-1]):
        (zi, yf, ys, mn, mx), _ = _fused_sample_scan(static, params, state,
                                                      blk)
        state = state._replace(zi=zi, fast=yf, slow=ys, min_val=mn,
                               max_val=mx)
    return state


def detect_offline(static: _Static, params: DetectorParams,
                   state: DetectorState, x: torch.Tensor, out=None):
    """Run the block detector over a whole recording ``[T, C]`` (T a
    multiple of the block size) → ``(state, (on [nb, C] bool, deltas
    [nb, C] int32, rel [T, C]))`` (detection.py:73-82).  ``out``: a state
    (it may be the input one) that the new state is copied into and
    returned as."""
    bsz = static.block_size
    c = x.shape[-1]
    ons, ds, rels = [], [], []
    for blk in x.reshape(-1, bsz, c):
        state, (on, d, rel) = detect_block(static, params, state, blk)
        ons.append(on)
        ds.append(d)
        rels.append(rel)
    if out is not None:
        state = write_into(out, state)
    if not ons:
        dev = x.device
        return state, (torch.zeros((0, c), dtype=torch.bool, device=dev),
                       torch.zeros((0, c), dtype=torch.int32, device=dev),
                       x[:0].to(torch.float32))
    return state, (torch.stack(ons), torch.stack(ds), torch.cat(rels))


def detect_offline_chunked(
    static: _Static,
    params: DetectorParams,
    state: DetectorState,
    x,
    chunk_blocks: int = 4096,
    emit_rel: bool = True,
) -> tuple[DetectorState, tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Constant-memory offline detection over arbitrarily long recordings.

    The detector carries all its state across blocks, so chunk-by-chunk is
    exact.  Each chunk of ``chunk_blocks`` blocks goes to the state's
    device and through the fused detector (its kernel on the card, the
    plain version on the CPU); results come back as host arrays.
    """
    from onset_fingerprinting_torch.ops.fused_detector import (
        detector_static,
        fused_detect_offline,
    )

    dev = state.fast.device
    fstatic = detector_static(static, params)
    bsz = static.block_size
    t = (x.shape[0] // bsz) * bsz
    step = chunk_blocks * bsz
    ons, deltas, rels = [], [], []
    for start in range(0, t, step):
        xc = torch.as_tensor(x[start: min(start + step, t)], device=dev,
                             dtype=torch.float32)
        state, (on, d, rel) = fused_detect_offline(
            fstatic, params, state, xc.contiguous(), emit_rel
        )
        ons.append(on.cpu().numpy())
        deltas.append(d.cpu().numpy())
        if emit_rel:
            rels.append(rel.cpu().numpy())
    c = x.shape[1]
    on = np.concatenate(ons) if ons else np.zeros((0, c), bool)
    d = np.concatenate(deltas) if deltas else np.zeros((0, c), np.int32)
    rel = (np.concatenate(rels) if rels else np.zeros((0, c), np.float32)
           ) if emit_rel else None
    return state, (on, d, rel)


class AmplitudeOnsetDetector:
    """Stateful host-facing detector with the reference's call contract
    (detection.py:727-798): ``od(x [B, C]) -> (channels, deltas, rel)``.
    Every block goes through the fused detector on ``device`` (None = the
    card: K1; ``"cpu"``: its plain version)."""

    def __init__(self, n_signals: Optional[int] = None, block_size: int = 32,
                 cfg: Optional[DetectorConfig] = None, device=None,
                 **kwargs):
        if cfg is None:
            cfg = DetectorConfig(n_channels=n_signals, block_size=block_size,
                                 **kwargs)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.static, self.params, self.state = detector_init(cfg,
                                                             self.device)

    def _run(self, x):
        from onset_fingerprinting_torch.ops.fused_detector import (
            detector_static,
            fused_detect_offline,
        )

        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                             device=self.device)
        self.state, (on, deltas, rel) = fused_detect_offline(
            detector_static(self.static, self.params), self.params,
            self.state, xt)
        return on, deltas, rel

    def __call__(self, x: np.ndarray):
        on, deltas, rel = self._run(x)
        on = on[0].cpu().numpy()
        deltas = deltas[0].cpu().numpy()
        channels = np.nonzero(on)[0]
        return list(channels), list(deltas[channels]), rel.cpu().numpy()

    def init_minmax_tracker(self, x: np.ndarray) -> None:
        from onset_fingerprinting_torch.ops.fused_detector import (
            detector_static,
            fused_warmup_minmax,
        )

        t = (len(x) // self.cfg.block_size) * self.cfg.block_size
        if t:
            self.state = fused_warmup_minmax(
                detector_static(self.static, self.params), self.params,
                self.state, torch.as_tensor(
                    np.ascontiguousarray(x[:t], np.float32),
                    device=self.device))

    def init(self, x: np.ndarray, verbose: bool = True) -> np.ndarray:
        """Bulk threshold calibration from representative audio
        (detection.py:842-888): warm the envelopes on 0.1-0.5 s (assumed
        quiet), derive absolute on/off thresholds from the relative
        envelope's median over the first second (noise floor) and its max
        (performance peak), and switch to those manual thresholds (the
        reference leaves ``manual`` False after init, a latent defect the
        JAX package fixes).  Returns the per-channel relative noise
        thresholds."""
        import dataclasses

        from onset_fingerprinting_torch.ops.filters import sliding_max

        bsz = self.cfg.block_size
        sr = self.cfg.sr
        t = (len(x) // bsz) * bsz
        lo = (int(0.1 * sr) // bsz) * bsz
        hi = (int(0.5 * sr) // bsz) * bsz
        self.init_minmax_tracker(x[lo:min(hi, t)])
        state = self.state
        _, _, rel = self._run(x[:t])
        self.state = state
        first_sec = rel[: min(sr, t)]
        mins = torch.quantile(first_sec, 0.5, dim=0)
        maxs = torch.amax(rel, dim=0)
        on_abs = maxs * self.cfg.on_threshold + mins
        off_abs = maxs * self.cfg.off_threshold + mins
        noise_max = torch.quantile(sliding_max(rel, int(sr * 0.01)), 0.5,
                                   dim=0)
        noise_thresh = ((noise_max - mins) / maxs).cpu().numpy()
        if verbose:
            print("Approx. relative noise thresholds at "
                  f"{[float(np.round(v, 3)) for v in noise_thresh]}!")
        self.static = dataclasses.replace(self.static, manual=True)
        self.params = self.params._replace(
            on_threshold=on_abs.to(torch.float32).contiguous(),
            off_threshold=off_abs.to(torch.float32).contiguous())
        return noise_thresh


def offline_detector(
    n_channels: int,
    block_size: int = 128,
    floor: float = -70.0,
    hipass_freq: float = 2000.0,
    fast_ar: tuple[float, float] = (3.0, 383.0),
    slow_ar: tuple[float, float] = (2205.0, 2205.0),
    on_threshold: float = 0.5,
    off_threshold: float = 0.1,
    cooldown: int = 1323,
    backtrack: bool = False,
    backtrack_buffer_size: int = 128,
    backtrack_smooth_size: int = 5,
    sr: int = 96000,
    device=None,
):
    """``(fused static, params, initial state)`` of
    :func:`detect_onsets_amplitude`'s detector on ``device`` (None = the
    card), thresholds per channel."""
    from onset_fingerprinting_torch.ops.fused_detector import detector_static

    dev = resolve_device(device)
    cfg = DetectorConfig(
        n_channels=n_channels,
        block_size=block_size,
        floor=floor,
        hipass_freq=hipass_freq,
        fast_attack=fast_ar[0],
        fast_release=fast_ar[1],
        slow_attack=slow_ar[0],
        slow_release=slow_ar[1],
        on_threshold=np.max(on_threshold) if np.ndim(on_threshold)
        else on_threshold,
        off_threshold=np.max(off_threshold) if np.ndim(off_threshold)
        else off_threshold,
        cooldown=cooldown,
        backtrack=backtrack,
        backtrack_buffer_size=backtrack_buffer_size,
        backtrack_smooth_size=backtrack_smooth_size,
        sr=sr,
    )
    static, params, state = detector_init(cfg, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    params = params._replace(
        on_threshold=torch.as_tensor(np.asarray(on_threshold, np.float32),
                                     **f32).expand(n_channels).contiguous(),
        off_threshold=torch.as_tensor(np.asarray(off_threshold, np.float32),
                                      **f32).expand(n_channels).contiguous())
    return detector_static(static, params), params, state


def detect_onsets_amplitude(
    x: np.ndarray,
    block_size: int = 128,
    floor: float = -70.0,
    hipass_freq: float = 2000.0,
    fast_ar: tuple[float, float] = (3.0, 383.0),
    slow_ar: tuple[float, float] = (2205.0, 2205.0),
    on_threshold: float = 0.5,
    off_threshold: float = 0.1,
    cooldown: int = 1323,
    backtrack: bool = False,
    backtrack_buffer_size: int = 128,
    backtrack_smooth_size: int = 5,
    sr: int = 96000,
    backend: str = "scan",
    device=None,
):
    """Offline amplitude detection over a whole recording ``[N, C]`` (the
    reference driver's contract, detection.py:19-86): the min/max tracker
    warms on the first 0.5 s, then every full block is detected.  Returns
    ``(channels, onsets, rel)`` with onsets as absolute sample indices.

    On the card (``device=None``) the warmup and the detection are one K1
    launch each over the whole span (``ops/fused_detector``); on the CPU
    both run the plain detector.  ``backend`` ("scan" or "pallas", the JAX
    package's two programs) is accepted for the signature's sake: both
    name the same computation here."""
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
    )

    if backend not in ("scan", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    fstatic, params, state = offline_detector(
        x.shape[1], block_size=block_size, floor=floor,
        hipass_freq=hipass_freq, fast_ar=fast_ar, slow_ar=slow_ar,
        on_threshold=on_threshold, off_threshold=off_threshold,
        cooldown=cooldown, backtrack=backtrack,
        backtrack_buffer_size=backtrack_buffer_size,
        backtrack_smooth_size=backtrack_smooth_size, sr=sr, device=device)
    f32 = dict(dtype=torch.float32, device=state.fast.device)
    xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), **f32)
    warm = (min(int(0.5 * sr), len(x)) // block_size) * block_size
    if warm:
        state = fused_warmup_minmax(fstatic, params, state,
                                    xt[:warm].contiguous())
    t = (len(x) // block_size) * block_size
    _, (on, deltas, rel) = fused_detect_offline(fstatic, params, state,
                                                xt[:t].contiguous())
    on = on.cpu().numpy()
    deltas = deltas.cpu().numpy()
    blocks, chans = np.nonzero(on)
    order = np.argsort(blocks, kind="stable")
    channels = list(chans[order])
    onsets = list(blocks[order] * block_size
                  + deltas[blocks[order], chans[order]])
    return channels, onsets, rel.cpu().numpy()
