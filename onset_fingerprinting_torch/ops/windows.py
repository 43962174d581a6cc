"""Hit lists and onset-window extraction (port of
``onset_fingerprinting_tpu.ops.windows``).

For B batched streams stored channel-interleaved as ``x [T, S·cps]``:

- :func:`top_hit_blocks` turns the detector's dense ``on [nb, S·cps]``
  events into a fixed-capacity per-stream hit list ``[S, K]``;
- :func:`compact_hit_list` / :func:`compact_hits` compact hits into one
  global ``[G]`` list.  ``jnp.nonzero(size=…)`` has no sync-free torch
  counterpart, so ranks come from ``cumsum`` and a ``scatter`` into fixed
  ``[G]`` buffers; overflow is counted in a device scalar ``n_dropped``,
  never dropped silently;
- :func:`gather_hit_windows` cuts ``[N, cps, W]`` windows: kernel K2
  (``csrc/gather.cu``) for a CUDA tensor, the plain indexing version
  :func:`gather_hit_windows_reference` for a CPU tensor;
- :func:`gather_windows_roll` cuts window-major ``[N, W, 8]`` lane slabs
  of the wide layout: kernel K4 (``csrc/gather_roll.cu``) for a CUDA
  tensor, :func:`gather_windows_roll_reference` for a CPU tensor.
"""

from __future__ import annotations

import torch

from onset_fingerprinting_torch.ops import _cuda

LANE = 128  # lane tile of the wide layout


def top_hit_blocks(
    on: torch.Tensor,
    block_size: int,
    n_streams: int,
    capacity: int,
    deltas: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity per-stream hit list from dense detector events.

    :param on: ``[nb, S*cps]`` bool per-block fire flags
    :param deltas: optional ``[nb, S*cps]`` int32 within-block onsets; when
        given, starts are sample-anchored ``block*block_size + delta`` of
        the block's earliest firing channel
    :returns: ``(starts [S, K] int32, valid [S, K] bool)`` — the first
        ``capacity`` hit blocks of each stream, in time order.
    """
    nb = on.shape[0]
    cps = on.shape[1] // n_streams
    dev = on.device
    onc = on.reshape(nb, n_streams, cps)
    hit = onc.any(dim=-1)  # [nb, S]
    rank = torch.cumsum(hit.to(torch.int32), dim=0)  # [nb, S]
    keep = hit & (rank <= capacity)
    # slot (s, rank-1) of the flat [S*K] list; everything else goes to a
    # dump slot at the end (one row matches each kept slot exactly)
    dump = n_streams * capacity
    stream = torch.arange(n_streams, device=dev)[None, :]
    target = torch.where(keep, stream * capacity + rank - 1, dump).reshape(-1)
    blk = torch.arange(nb, device=dev, dtype=torch.int32)[:, None]
    starts = blk * block_size
    if deltas is not None:
        dmin = torch.where(onc, deltas.reshape(nb, n_streams, cps),
                           2**30).amin(dim=-1)  # [nb, S]
        starts = starts + dmin
    starts = starts.expand(nb, n_streams).reshape(-1).to(torch.int32)
    out = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    out.scatter_(0, target, starts)
    valid = torch.zeros(dump + 1, dtype=torch.bool, device=dev)
    valid.scatter_(0, target, keep.reshape(-1))
    valid = valid[:dump].reshape(n_streams, capacity)
    starts = torch.where(valid, out[:dump].reshape(n_streams, capacity), 0)
    return starts.to(torch.int32), valid


def _compact(flat: torch.Tensor, capacity: int):
    """First ``capacity`` True positions of ``flat`` (in order) →
    ``(idx [G] int64, zero where invalid; valid [G]; n_dropped int32)``."""
    n = flat.shape[0]
    dev = flat.device
    rank = torch.cumsum(flat.to(torch.int64), dim=0) - 1
    keep = flat & (rank < capacity)
    target = torch.where(keep, rank, capacity)
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, target, torch.arange(n, device=dev))
    total = flat.sum(dtype=torch.int32)
    valid = torch.arange(capacity, device=dev) < total
    idx = torch.where(valid, idx[:capacity], 0)
    n_dropped = torch.clamp(total - capacity, min=0).to(torch.int32)
    return idx, valid, n_dropped


def compact_hits(on: torch.Tensor, block_size: int, n_streams: int,
                 capacity: int):
    """Global fixed-capacity hit list compacted across all streams, in time
    order → ``(starts [G] int32, stream_ids [G] int32, valid [G] bool,
    n_dropped int32)``; invalid slots hold 0."""
    nb = on.shape[0]
    cps = on.shape[1] // n_streams
    flat = on.reshape(nb, n_streams, cps).any(dim=-1).reshape(-1)
    idx, valid, n_dropped = _compact(flat, capacity)
    starts = torch.where(valid, (idx // n_streams) * block_size, 0)
    sids = torch.where(valid, idx % n_streams, 0)
    return starts.to(torch.int32), sids.to(torch.int32), valid, n_dropped


def compact_hit_list(starts: torch.Tensor, valid: torch.Tensor,
                     capacity: int, return_indices: bool = False):
    """Compact a padded per-stream hit list ``[S, K]`` to a flat ``[G]`` →
    ``(starts [G] int32, stream_ids [G] int32, valid [G] bool, n_dropped
    int32)`` in stream-major order, plus ``idx [G] int32`` (each kept hit's
    flat slot in ``[S*K]``, 0 where invalid) with ``return_indices``."""
    s, k = starts.shape
    idx, valid_out, n_dropped = _compact(valid.reshape(-1), capacity)
    out_starts = torch.where(valid_out, starts.reshape(-1)[idx], 0)
    out = (
        out_starts.to(torch.int32),
        (idx // k).to(torch.int32),
        valid_out,
        n_dropped,
    )
    return out + (idx.to(torch.int32),) if return_indices else out


def _rows(starts: torch.Tensor, t: int, window: int, pre: int,
          anchored: bool) -> torch.Tensor:
    if anchored:
        return torch.clamp(starts - pre, 0, t - window - 8)
    return torch.clamp(starts - pre, 0, t - window) // 8 * 8


def gather_hit_windows_reference(x, starts, stream_ids, channels_per_stream,
                                 window, pre=0, anchored=False):
    """Plain version of K2: the same windows by advanced indexing."""
    _cuda.GATHER.plain_calls += 1
    t, c = x.shape
    cps = channels_per_stream
    dev = x.device
    rows = _rows(starts.long(), t, window, pre, anchored)
    sids = torch.clamp(stream_ids.long(), 0, c // cps - 1)
    r = rows[:, None] + torch.arange(window, device=dev)  # [N, W]
    cols = sids[:, None] * cps + torch.arange(cps, device=dev)  # [N, cps]
    return x[r[:, None, :], cols[:, :, None]].to(torch.float32)


def gather_hit_windows(
    x: torch.Tensor,
    starts: torch.Tensor,
    stream_ids: torch.Tensor,
    channels_per_stream: int,
    window: int,
    pre: int = 0,
    anchored: bool = False,
) -> torch.Tensor:
    """Windows for a flat per-hit ``(stream, start)`` list → ``[N, cps, W]``
    float32: ``windows[i, c, w] == x[row_i + w, stream_ids[i]*cps + c]``
    with ``row_i = clip(starts[i] - pre, 0, T - W - 8)`` when ``anchored``
    (exact onset anchoring) or ``clip(starts[i] - pre, 0, T - W)`` floored
    to 8 samples otherwise (the JAX package's two contracts)."""
    t, c = x.shape
    cps = channels_per_stream
    if c % cps:
        raise ValueError(f"C={c} is not a multiple of cps={cps}")
    if t < window + (8 if anchored else 0):
        raise ValueError(f"T={t} is shorter than the window read")
    if x.device.type == "cpu":
        return gather_hit_windows_reference(x, starts, stream_ids, cps,
                                            window, pre, anchored)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [T, C] tensor")
    n = starts.shape[0]
    for v in (starts, stream_ids):
        if (v.dtype != torch.int32 or v.shape != (n,) or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError("starts and stream_ids must be contiguous int32 "
                             f"[{n}] tensors on x's device")
    out = torch.empty((n, cps, window), dtype=torch.float32, device=x.device)
    if n:
        _cuda.GATHER.launch(
            "ofpt_gather", x.data_ptr(), starts.data_ptr(),
            stream_ids.data_ptr(), out.data_ptr(), n, t, c, cps, window, pre,
            int(anchored), _cuda.stream(),
        )
    return out


def gather_block_windows(x, block_starts, channels_per_stream, window,
                         pre=0, anchored=False):
    """Per-stream windows at ``block_starts [S, K]`` → ``[S, K, cps, W]``
    (stream s reads its own ``cps`` channels), same contracts as
    :func:`gather_hit_windows`."""
    s, k = block_starts.shape
    sids = torch.arange(s, dtype=torch.int32, device=block_starts.device)
    sids = sids.repeat_interleave(k)
    out = gather_hit_windows(
        x, block_starts.reshape(-1).to(torch.int32).contiguous(), sids,
        channels_per_stream, window, pre, anchored,
    )
    return out.reshape(s, k, channels_per_stream, window)


def _roll_indices(row_start, stream_ids, t, c, cps, window):
    """``(rows [N, W], cols [N, 8])`` int64 of K4's contract."""
    dev = row_start.device
    groups = LANE // cps
    r = torch.clamp(torch.div(row_start.long(), 8, rounding_mode="floor")
                    * 8, 0, t - window)
    sids = torch.clamp(stream_ids.long(), 0, c // cps - 1)
    lanes = ((sids % groups) * cps)[:, None] + torch.arange(8, device=dev)
    cols = (sids // groups * LANE)[:, None] + lanes % LANE
    return r[:, None] + torch.arange(window, device=dev), cols


def gather_windows_roll_reference(x, row_start, stream_ids,
                                  channels_per_stream, window):
    """Plain version of K4: the same ``[N, W, 8]`` slabs by one
    advanced-indexing read."""
    _cuda.GATHER_ROLL.plain_calls += 1
    t, c = x.shape
    rows, cols = _roll_indices(row_start, stream_ids, t, c,
                               channels_per_stream, window)
    return x[rows[:, :, None], cols[:, None, :]].to(torch.float32)


def gather_windows_roll(
    x: torch.Tensor,
    row_start: torch.Tensor,
    stream_ids: torch.Tensor,
    channels_per_stream: int,
    window: int,
) -> torch.Tensor:
    """Window-major lane slabs of the wide layout → ``[N, W, 8]`` float32
    (port of the JAX package's ``_gather_pallas_roll``):

    ``out[i, w, l] = x[r_i + w, tile_i*128 + (g_i*cps + l) mod 128]`` with
    ``r_i = clip(floor8(row_start_i), 0, T - W)``, ``tile_i = sid_i //
    (128/cps)`` and ``g_i = sid_i mod (128/cps)``.  Lanes ``l < cps`` are
    stream ``sid_i``'s channels; lanes ``cps..7`` hold the next streams of
    the same 128-lane tile, wrapping inside it (a lane rotation).  Stream
    ids are clamped to ``[0, C/cps - 1]``.  ``out[:, :, :cps].transpose(1,
    2)`` equals :func:`gather_hit_windows`'s block-aligned windows when
    ``row_start`` is its floored row.  Needs the wide layout: ``C % 128 ==
    0`` and ``128 % cps == 0``."""
    t, c = x.shape
    cps = channels_per_stream
    if c % LANE or LANE % cps:
        raise ValueError(
            f"the roll gather needs the wide layout (C={c} divisible by "
            f"{LANE} with cps={cps} dividing {LANE})"
        )
    if t < window:
        raise ValueError(f"T={t} is shorter than the window read")
    if x.device.type == "cpu":
        return gather_windows_roll_reference(x, row_start, stream_ids, cps,
                                             window)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [T, C] tensor")
    n = row_start.shape[0]
    for v in (row_start, stream_ids):
        if (v.dtype != torch.int32 or v.shape != (n,) or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError("row_start and stream_ids must be contiguous "
                             f"int32 [{n}] tensors on x's device")
    out = torch.empty((n, window, 8), dtype=torch.float32, device=x.device)
    if n:
        _cuda.GATHER_ROLL.launch(
            "ofpt_gather_roll", x.data_ptr(), row_start.data_ptr(),
            stream_ids.data_ptr(), out.data_ptr(), n, t, c, cps, window,
            _cuda.stream(),
        )
    return out
