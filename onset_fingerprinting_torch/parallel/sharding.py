"""Sharded offline processing over a ``torch.distributed`` mesh: data
parallel over streams and halo time sharding (port of
``onset_fingerprinting_tpu.parallel.sharding``).

The JAX package writes each of these as one ``shard_map`` program over a
``jax.sharding.Mesh``.  Here each rank of the mesh (one process, one card)
runs its shard with the port's kernels, and the results meet in
``torch.distributed`` collectives over the mesh axis's process group:

- :func:`detect_offline_sharded`: a batch of recordings ``[S, T, C]``
  split over the ``data`` axis, each rank's streams folded into the
  channel axis of one wide detector (K1's pipe on the card);
- :func:`detect_offline_time_sharded`: ONE long recording split by time,
  each rank re-running the detector over ``halo`` samples of its left
  neighbour's segment before its own and discarding those outputs (the
  detector's state forgets exponentially, so the halo reproduces the
  sequential result);
- :func:`detect_events_time_sharded`: the same with each rank's events
  reduced to a fixed-capacity queue and ``all_gather``-ed
  (``dist.all_gather_into_tensor``), so every rank holds the global event
  set;
- :func:`make_detect_fingerprint_sharded`: detect → hit list → window
  gather (K2) → fingerprint model (K3) per rank, the multi-card form of
  the fleet pipeline;
- :func:`make_detect_locate_sharded`: detect → fixed-capacity locate →
  classify per stream, the multi-card form of the realtime engine's step
  (the coupled detector over a batch of streams in one K1 launch, the
  events through ``csrc/locate_block.cu``'s stream-batched entry).

Every function takes the GLOBAL input (each rank takes its shard) and
returns the GLOBAL result on every rank, as the JAX functions return
global arrays: a rank's outputs are gathered over the axis.  Without a
process group the mesh has one device and nothing is gathered.  On the
card each stage runs its kernel; on the CPU its plain version (JAX's
``backend=`` and ``interpret=`` have no counterpart).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from onset_fingerprinting_torch.detect.amplitude import (
    DetectorParams,
    DetectorState,
)
from onset_fingerprinting_torch.ops.fused_detector import (
    detector_static,
    fused_detect_offline,
    fused_detect_streams,
)
from onset_fingerprinting_torch.parallel.mesh import Mesh
from onset_fingerprinting_torch.utils.metrics import trace


def _as_tensor(x, device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device)


def _gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on dim 0 in mesh
    order (``dist.all_gather_into_tensor``); ``t`` itself without a
    process group."""
    group = mesh.group(axis)
    if group is None:
        return t
    n = mesh.shape[axis]
    src = t.contiguous()
    if src.dtype == torch.bool:  # carried as bytes on every backend
        src = src.to(torch.uint8)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.dtype)


def shard_batch(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's slice of ``x``'s leading axis, on its device (the axis
    length must divide by the mesh axis)."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                         f"{n} devices")
    per = x.shape[0] // n
    i = mesh.index(axis)
    return _as_tensor(x[i * per: (i + 1) * per], mesh.device).contiguous()


def _halo_geometry(static, t: int, n_dev: int, halo: Optional[int]
                   ) -> tuple[int, int, int]:
    """``(halo, seg, nb_orig)`` of the time sharding of a ``[t, C]``
    recording over ``n_dev`` devices (JAX's ``_halo_segments``): the halo
    rounded up to whole blocks (default ~3 slow-envelope time constants),
    the segment a whole number of blocks per device with the recording
    zero-padded UP to ``n_dev * seg`` (never floor-truncated: flooring
    would drop up to ``n_dev*block_size - 1`` trailing samples and any
    onsets in them), and the ``t // block_size`` whole blocks the
    sequential run processes: output blocks at global index ``>=
    nb_orig`` cover only padding and are discarded."""
    bsz = static.block_size
    if halo is None:
        halo = int(3 * max(static.cooldown, 2205))
    halo = ((halo + bsz - 1) // bsz) * bsz
    nb_orig = t // bsz
    seg = ((t + n_dev * bsz - 1) // (n_dev * bsz)) * bsz
    return halo, seg, nb_orig


def _halo_segment(x: torch.Tensor, d: int, halo: int, seg: int
                  ) -> torch.Tensor:
    """Device ``d``'s segment ``[halo + seg, C]`` of ``x``: its left warm-up
    halo (zeros before the recording's start: segment 0 warms up from the
    initial state like the sequential run), then its ``seg`` samples
    (zeros past the end)."""
    t, c = x.shape
    start, stop = d * seg - halo, d * seg + seg
    lo, hi = max(start, 0), min(stop, t)
    part = x[lo:hi]
    pad_l, pad_r = lo - start, stop - hi
    if pad_l or pad_r:
        part = torch.cat([x.new_zeros((pad_l, c)), part,
                          x.new_zeros((pad_r, c))])
    return part.contiguous()


def _tile_streams(static, params: DetectorParams, state: DetectorState,
                  per_dev: int, c: int):
    """Widen a per-stream detector config to ``per_dev`` streams folded
    into channels: the caller's exact static config, params and state tiled
    across the stream axis, with per-channel gating (the detector is
    channel-independent)."""
    static_l = dataclasses.replace(
        static, n_channels=per_dev * c, coupled_off=False
    )
    params_l = DetectorParams(
        on_threshold=params.on_threshold.repeat(per_dev),
        off_threshold=params.off_threshold.repeat(per_dev),
        b=params.b,
        a=params.a,
    )
    state_l = DetectorState(
        zi=state.zi.repeat(1, per_dev),
        fast=state.fast.repeat(per_dev),
        slow=state.slow.repeat(per_dev),
        min_val=state.min_val.repeat(per_dev),
        max_val=state.max_val.repeat(per_dev),
        gate=state.gate.repeat(per_dev),
        prev_rel=state.prev_rel.repeat(per_dev),
        debounce=state.debounce.repeat(per_dev),
        bt_buffer=state.bt_buffer.repeat(1, per_dev),
        bt_pos=state.bt_pos.clone(),
    )
    return static_l, params_l, state_l


def _to(tree, device):
    return type(tree)(*(v.to(device) for v in tree))


def _detect_wide(static, params, state, wide: torch.Tensor, per_dev: int,
                 c: int, emit_rel: bool):
    """The streams folded into ``wide [T, per_dev*c]`` through one
    per-channel detector (K1's pipe on the card) → per-stream ``(on
    [per_dev, nb, c], deltas, rel [per_dev, T, c] or None)``."""
    static_l, params_l, state_l = _tile_streams(static, params, state,
                                                per_dev, c)
    fst = detector_static(static_l, params_l)
    _, (on, deltas, rel) = fused_detect_offline(fst, params_l, state_l,
                                                wide, emit_rel=emit_rel)
    t = wide.shape[0]

    def unfold(a, d0):
        return a.reshape(d0, per_dev, c).movedim(1, 0)

    nb = t // static.block_size
    return (unfold(on, nb), unfold(deltas, nb),
            None if rel is None else unfold(rel, t))


def detect_offline_sharded(static, params: DetectorParams,
                           state: DetectorState, x, mesh: Mesh):
    """The fused offline detector over a batch ``[S, T, C]`` sharded over
    the mesh's first axis.

    Each rank folds its streams into the channel axis and runs ONE wide
    per-channel detector over them (no collectives until the results are
    gathered), so independent streams never couple through the reference's
    cross-channel off-gate.  Returns per-stream ``(on [S, nb, C], deltas
    [S, nb, C], rel [S, T, C])``; the detector state is not carried out."""
    n_streams, t, c = x.shape
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    assert n_streams % n_dev == 0, "streams must divide the mesh axis"
    per_dev = n_streams // n_dev
    xb = shard_batch(mesh, x, axis)
    wide = xb.movedim(0, 1).reshape(t, per_dev * c).contiguous()
    on, deltas, rel = _detect_wide(static, _to(params, mesh.device),
                                   _to(state, mesh.device), wide, per_dev,
                                   c, True)
    return (_gather(mesh, axis, on), _gather(mesh, axis, deltas),
            _gather(mesh, axis, rel))


def _segment_events(static, params, state, x, mesh, halo, axis,
                    emit_rel: bool):
    """This rank's halo segment through the caller's detector (K1 routed
    by its config on the card), halo outputs dropped → ``(d, on [nb_local,
    C], deltas, rel or None, halo, seg, nb_orig)``."""
    n_dev = mesh.shape[axis]
    bsz = static.block_size
    halo, seg, nb_orig = _halo_geometry(static, x.shape[0], n_dev, halo)
    d = mesh.index(axis)
    xs = _halo_segment(torch.as_tensor(x), d, halo, seg).to(mesh.device)
    params = _to(params, mesh.device)
    fst = detector_static(static, params)
    _, (on, deltas, rel) = fused_detect_offline(
        fst, params, _to(state, mesh.device), xs, emit_rel=emit_rel)
    skip = halo // bsz
    return (d, on[skip:], deltas[skip:],
            None if rel is None else rel[halo:], halo, seg, nb_orig)


def detect_offline_time_sharded(static, params: DetectorParams,
                                state: DetectorState, x, mesh: Mesh,
                                halo: Optional[int] = None,
                                axis: str = "data"):
    """Detect over ONE long recording ``[T, C]`` sharded by time with a
    warm-up halo.  Returns dense per-block ``(on, deltas, rel)`` covering
    the same ``T // block_size`` whole blocks the sequential run
    processes (halo outputs discarded per shard; the tail zero-padded up to
    a whole number of blocks per device and the padding blocks dropped,
    never real samples).

    ``halo`` defaults to ~3 slow-envelope time constants (rounded up to the
    block size): enough for the detector's exponential state to forget the
    segment boundary."""
    bsz = static.block_size
    c = x.shape[1]
    _, on, deltas, rel, _, _, nb_orig = _segment_events(
        static, params, state, x, mesh, halo, axis, emit_rel=True)
    on = _gather(mesh, axis, on).reshape(-1, c)[:nb_orig]
    deltas = _gather(mesh, axis, deltas).reshape(-1, c)[:nb_orig]
    rel = _gather(mesh, axis, rel).reshape(-1, c)[: nb_orig * bsz]
    return on, deltas, rel


def events_from_dense(on, deltas, block_size: int
                      ) -> tuple[list[int], list[int]]:
    """Dense per-block (on, deltas) → (channels, absolute onset samples)."""
    on = np.asarray(on.cpu() if torch.is_tensor(on) else on)
    deltas = np.asarray(deltas.cpu() if torch.is_tensor(deltas) else deltas)
    blocks, chans = np.nonzero(on)
    onsets = blocks * block_size + deltas[blocks, chans]
    return list(chans), list(onsets)


#: the empty event slot's key (int32 onsets sort before it)
_BIG = 2**30


def detect_events_time_sharded(static, params: DetectorParams,
                               state: DetectorState, x, mesh: Mesh,
                               halo: Optional[int] = None,
                               axis: str = "data", capacity: int = 64,
                               return_dropped: bool = False):
    """Detect over one long recording ``[T, C]`` time-sharded across the
    mesh, with cross-rank event aggregation on the devices.

    Each rank runs the detector over its halo-warmed segment, reduces its
    dense per-block outputs to a fixed-capacity queue ``(onset, channel)``
    ordered by onset, and the queues are ``all_gather``-ed over the axis
    (``dist.all_gather_into_tensor`` of ``[K]`` buffers): every rank ends
    up holding the global event set.

    Returns host ``(channels [N], onsets [N])`` sorted by onset.
    ``capacity`` bounds the events per segment; overflow drops a segment's
    LATEST events and is never silent: the raw per-segment counts ride the
    same collective, a :class:`UserWarning` names the drops, and
    ``return_dropped=True`` also returns the ``[D]`` drop counts."""
    n_dev = mesh.shape[axis]
    bsz = static.block_size
    t, c = x.shape
    if t + n_dev * bsz >= _BIG:
        # onset keys share the int32 range with the _BIG empty-slot key
        raise ValueError(
            f"recording of {t} samples exceeds the {_BIG}-sample "
            "(~3.1 h @ 96 kHz) limit of the int32 event keys; chunk the "
            "recording (detect_offline_chunked) and offset the results"
        )
    d, on, deltas, _, _, seg, nb_orig = _segment_events(
        static, params, state, x, mesh, halo, axis, emit_rel=False)
    nb_local = on.shape[0]
    dev = on.device
    blk = torch.arange(nb_local, dtype=torch.int32, device=dev)[:, None]
    # blocks past the sequential run's whole-block count cover only the
    # zero padding
    on = on & (d * nb_local + blk < nb_orig)
    onset_abs = d * seg + blk * bsz + deltas
    key = torch.where(on, onset_abs, _BIG).reshape(-1)
    chan = torch.arange(c, dtype=torch.int32, device=dev).expand(
        nb_local, c).reshape(-1)
    order = torch.sort(key, stable=True).indices[:capacity]
    ev_onsets = key[order].to(torch.int32).contiguous()  # _BIG: empty slot
    ev_chans = chan[order].contiguous()
    n_raw = on.sum(dtype=torch.int32).reshape(1)
    # the collective: every rank receives every segment's queue, and the
    # raw counts ride along so overflow is reported, never silent
    g_onsets = _gather(mesh, axis, ev_onsets).cpu().numpy()
    g_chans = _gather(mesh, axis, ev_chans).cpu().numpy()
    g_counts = _gather(mesh, axis, n_raw).cpu().numpy()
    dropped = np.maximum(g_counts - capacity, 0)
    if dropped.any():
        warnings.warn(
            f"detect_events_time_sharded: event-queue overflow, dropped "
            f"{int(dropped.sum())} event(s) beyond capacity={capacity} "
            f"(per-segment drops: {dropped.tolist()}); raise `capacity`",
            UserWarning,
            stacklevel=2,
        )
    valid = g_onsets < _BIG
    onsets = g_onsets[valid]
    chans = g_chans[valid]
    order = np.argsort(onsets, kind="stable")
    if return_dropped:
        return chans[order], onsets[order], dropped
    return chans[order], onsets[order]


def stream_events(on: torch.Tensor, deltas: torch.Tensor, block_size: int,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each stream's first ``capacity`` events in onset order from its dense
    per-block ``(on, deltas) [S, nb, C]`` → ``(onsets [S, E] int32, _BIG
    past the last real one; channels [S, E] int32)``, the order a stable
    sort gives (ties keep block-major, channel order, as ``jnp.argsort``)."""
    n, nb, c = on.shape
    dev = on.device
    blk = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    key = torch.where(on, blk * block_size + deltas, _BIG).reshape(n, -1)
    order = torch.sort(key, dim=1, stable=True).indices[:, :capacity]
    ch = torch.arange(c, dtype=torch.int32, device=dev).expand(nb, c)
    return (torch.gather(key, 1, order).to(torch.int32).contiguous(),
            ch.reshape(-1)[order].contiguous())


def _apply(model, model_params, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` in inference mode, with ``model_params`` (a state dict
    or None = the module's own) as flax's ``model.apply(params, x)``."""
    with torch.inference_mode():
        if model_params is None:
            return model(x)
        return torch.func.functional_call(model, model_params, (x,))


def make_detect_fingerprint_sharded(
    static,
    params: DetectorParams,
    state: DetectorState,
    shape: tuple,
    mesh: Mesh,
    model,
    window: int = 256,
    pre: int = 64,
    capacity: int = 16,
    layout: str = "stream",
    channels_per_stream: int | None = None,
    compact_capacity: int | None = None,
):
    """The reusable sharded fleet pipeline: fused detection (K1) →
    fixed-capacity hit lists → window gather (K2) → fingerprint model (K3)
    on each rank, gathered over the mesh's first axis.

    Returns ``run(x, model_params=None) -> (preds [S, capacity, out],
    starts [S, capacity] int32, valid [S, capacity] bool, n_dropped
    [n_devices] int32)``; ``n_dropped`` counts each rank's hits beyond the
    compaction budget (zeros when compaction is off).

    ``compact_capacity`` (per rank) runs the gather and the model over the
    globally compacted hit list (``ops/windows.compact_hit_list``): at most
    ``compact_capacity`` real hits instead of ``per_dev*capacity`` padded
    slots; the predictions are scattered back into the padded ``[S,
    capacity]`` layout, so the return contract is the same.  Hits beyond
    the budget are dropped zero-masked, flagged invalid and counted.

    :param shape: the input shape the callable serves: ``layout='stream'``
        ``[S, T, C]`` split over the first axis; ``layout='wide'`` ``[T,
        S*C]``, channels interleaved stream-major, split over columns (no
        transpose: the serving layout).
    :param model: a module mapping ``[B, C, window] → [B, out]``; the
        starts are block starts and the windows the gather's non-anchored
        contract, as in the JAX function.
    """
    from onset_fingerprinting_torch.ops.windows import (
        compact_hit_list,
        gather_block_windows,
        gather_hit_windows,
        top_hit_blocks,
    )

    if layout == "wide":
        t, c_total = shape
        c = channels_per_stream
        n_streams = c_total // c
    else:
        n_streams, t, c = shape
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    assert n_streams % n_dev == 0, "streams must divide the mesh axis"
    per_dev = n_streams // n_dev
    bsz = static.block_size
    dev = mesh.device
    static_l, params_l, state_l = _tile_streams(
        static, _to(params, dev), _to(state, dev), per_dev, c)
    fst = detector_static(static_l, params_l)
    model = model.to(dev).eval()

    def body(wide: torch.Tensor, mp):  # [T, per_dev*c] local wide channels
        _, (on, deltas, _) = fused_detect_offline(
            fst, params_l, state_l, wide, emit_rel=False)
        starts, valid = top_hit_blocks(on, bsz, per_dev, capacity)
        if compact_capacity is not None:
            # gather and model over the real hits only, then scatter the
            # predictions back into the padded [S, K] layout; overflow
            # beyond the budget is counted and returned, never silent
            n_slots = per_dev * capacity
            sts, sids, ok, n_dropped, idx = compact_hit_list(
                starts, valid, compact_capacity, return_indices=True)
            windows = gather_hit_windows(wide, sts, sids, c, window, pre,
                                         anchored=False)  # [G, c, W]
            p = _apply(model, mp, windows)
            p = torch.where(ok[:, None], p, 0.0)
            scatter = torch.where(ok, idx.long(), n_slots)
            preds = torch.zeros((n_slots + 1, p.shape[-1]), dtype=p.dtype,
                                device=p.device)
            preds[scatter] = p
            preds = preds[:n_slots].reshape(per_dev, capacity, -1)
            # slots beyond the budget stay zero AND are reported invalid
            kept = torch.zeros((n_slots + 1,), dtype=torch.bool,
                               device=p.device)
            kept[scatter] = True
            valid = valid & kept[:n_slots].reshape(per_dev, capacity)
            return preds, starts, valid, n_dropped.reshape(1)
        windows = gather_block_windows(wide, starts, c, window, pre,
                                       anchored=False)
        preds = _apply(model, mp, windows.reshape(per_dev * capacity, c,
                                                  window))
        preds = preds.reshape(per_dev, capacity, -1)
        preds = torch.where(valid[..., None], preds, 0.0)
        return preds, starts, valid, torch.zeros((1,), dtype=torch.int32,
                                                 device=preds.device)

    def run(x, model_params=None):
        i = mesh.index(axis)
        if layout == "wide":
            cols = slice(i * per_dev * c, (i + 1) * per_dev * c)
            wide = _as_tensor(x[:, cols], dev).contiguous()
        else:
            xb = shard_batch(mesh, x, axis)
            wide = xb.movedim(0, 1).reshape(t, per_dev * c).contiguous()
        out = body(wide, model_params)
        # preds/starts/valid stack over the axis; the per-rank [1] drop
        # counts concatenate to [n_devices]
        return tuple(_gather(mesh, axis, v) for v in out)

    return run


def make_detect_locate_sharded(
    static,
    params: DetectorParams,
    state: DetectorState,
    shape: tuple,
    mesh: Mesh,
    locator,
    model=None,
    event_capacity: int = 32,
    locator_capacity: int = 8,
    window: int = 256,
    pre: int = 64,
    axis: str = "data",
):
    """The sharded serve datapath, detect → fixed-capacity locate →
    (optionally) classify, per stream of a batch ``[S, T, C]`` split over
    the mesh axis (the multi-card form of the realtime engine's step).

    Each rank detects the onsets of its streams with the caller's detector
    (a coupled config: one K1 launch over the batch of streams, the pipe's
    coupled instantiation, several streams a CTA in lane groups; a
    per-channel one: the streams folded into channels, K1's pipe), orders each stream's first ``event_capacity`` events by onset,
    feeds them through the fixed-capacity locator (``csrc/
    locate_block.cu``'s stream-batched entry: one CTA per stream, Newton,
    the JAX function's ``lax.scan``), and classifies a window around each
    event with ``model``.  Streams are independent: no collective runs
    until the results are gathered.

    :param locator: host :class:`~..locate.multilaterate.Multilaterate3D`
        whose lag tables the locate step takes.
    :param model: optional module ``[B, C, window] → [B, out]`` applied to
        every event slot's window (zero-masked where not located).
    :returns: ``run(x, model_params=None) -> (points [S, E, 2] cm, onsets
        [S, E] int32, emits [S, E] bool, preds [S, E, out])`` with ``E =
        event_capacity``.  Slots beyond a stream's real events have
        ``emits`` False; ``points`` are zero where not emitted (the JAX
        function leaves the masked solve's value there).  Detected events
        beyond ``event_capacity`` per stream are dropped latest-first.

    Spans (``utils.metrics.trace``): ``drum.call`` around a call, inside it
    ``drum.detect`` (the state's expansion and K1), ``drum.events``,
    ``drum.locate``, and with ``model`` ``drum.windows`` (the windows' cut
    into a contiguous ``[S·E, C, window]``) and ``drum.classify`` (the
    model and the mask)."""
    from onset_fingerprinting_torch.ops.locate_block import (
        LocateBlock,
        locate_streams,
    )

    n_streams, t, c = shape
    n_dev = mesh.shape[axis]
    assert n_streams % n_dev == 0, "streams must divide the mesh axis"
    per_dev = n_streams // n_dev
    bsz = static.block_size
    dev = mesh.device
    params = _to(params, dev)
    state = _to(state, dev)
    e = event_capacity
    lb = LocateBlock(locator, c, bsz, capacity=locator_capacity, device=dev)
    if dev.type == "cuda":
        lb.check_kernel_shape()
    if static.coupled_off:
        fst = detector_static(static, params)
    if model is not None:
        model = model.to(dev).eval()

    def detect(xb: torch.Tensor):  # [per_dev, T, C]
        if static.coupled_off:
            states = DetectorState(*(
                v.expand((per_dev,) + tuple(v.shape)).contiguous()
                for v in state))
            _, (on, deltas, _) = fused_detect_streams(fst, params, states,
                                                      xb)
            return on, deltas
        wide = xb.movedim(0, 1).reshape(t, per_dev * c).contiguous()
        on, deltas, _ = _detect_wide(static, params, state, wide, per_dev,
                                     c, False)
        return on, deltas

    def run(x, model_params=None):
        with trace("drum.call"):
            xb = shard_batch(mesh, x, axis)
            with trace("drum.detect"):
                on, deltas = detect(xb)  # [per_dev, nb, C]
            with trace("drum.events"):
                ev_on, ev_ch = stream_events(on, deltas, bsz, e)
            with trace("drum.locate"):
                points, emits = locate_streams(lb, ev_on, ev_ch)
            if model is None:
                preds = torch.zeros((per_dev, ev_on.shape[1], 0),
                                    dtype=torch.float32, device=dev)
            else:
                with trace("drum.windows"):
                    starts = torch.clamp(
                        torch.where(ev_on < _BIG, ev_on, 0) - pre, 0,
                        t - window)
                    idx = starts[..., None] + torch.arange(window, device=dev)
                    sidx = torch.arange(per_dev, device=dev)[:, None, None]
                    wins = xb[sidx, idx.long()]  # [per_dev, E, window, C]
                    k = ev_on.shape[1]
                    cut = wins.reshape(per_dev * k, window, c).transpose(
                        1, 2).contiguous()
                with trace("drum.classify"):
                    p = _apply(model, model_params, cut)
                    del cut  # the model's input is not held to the end
                    preds = torch.where(emits[..., None],
                                        p.reshape(per_dev, k, -1).float(),
                                        0.0)
            return tuple(_gather(mesh, axis, v)
                         for v in (points, ev_on, emits, preds))

    return run


def detect_fingerprint_sharded(static, params: DetectorParams,
                               state: DetectorState, x, mesh: Mesh, model,
                               model_params=None, **kwargs):
    """One-shot wrapper over :func:`make_detect_fingerprint_sharded` (which
    see); for repeated serving calls build the pipeline once and reuse it.

    :returns: ``(preds [S, capacity, out], starts [S, capacity] int32,
        valid [S, capacity] bool, n_dropped [n_devices] int32)``."""
    run = make_detect_fingerprint_sharded(
        static, params, state, tuple(x.shape), mesh, model, **kwargs
    )
    return run(x, model_params)
