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
- :func:`gather_hit_windows` cuts ``[N, cps, W]`` windows: kernel K2 for a
  CUDA tensor, the plain indexing version
  :func:`gather_hit_windows_reference` for a CPU tensor;
- :func:`gather_windows_roll` cuts window-major ``[N, W, 8]`` lane slabs
  of the wide layout: kernel K4 for a CUDA tensor,
  :func:`gather_windows_roll_reference` for a CPU tensor.

Each gather has two kernels on the card, and a route function says which
one a call takes (:func:`gather_kernel_for`, :func:`roll_kernel_for`; a
static test of the shape and of x's alignment, no fallback):

- ``csrc/gather_vec.cu`` / ``csrc/gather_roll_vec.cu``, row-vector copies
  (each thread issues a fixed count of 16-byte loads before its stores),
  wherever they take the shape;
- ``csrc/gather.cu`` / ``csrc/gather_roll.cu``, one float per thread,
  which take any shape: the route for the rest.

:func:`gather_routes` and :func:`roll_routes` name both where both take a
shape, so that a measurement can time them side by side.
:func:`gather_vec_addresses` and :func:`roll_vec_addresses` spell out the
row-vector kernels' addressing for the CPU tests, which replay it against
the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

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


class Route(NamedTuple):
    """The kernel a CUDA gather launches: its record, C entry point and
    instantiation (counted in ``kernel.variants``)."""

    kernel: _cuda.Kernel
    entry: str
    variant: str


#: cps values with an instantiation of the row-vector K2
VEC_CPS = (1, 2, 4, 8)
#: the row-vector kernels' ROWS: rows (K2) or vectors (K4) per thread
TILE_ROWS = 4


def vec_width(cps: int) -> int:
    """Floats per load of the row-vector K2: the largest of 4, 2, 1 that
    divides ``cps`` (and so C, and every window row's offset)."""
    return 4 if cps % 4 == 0 else 2 if cps % 2 == 0 else 1


def roll_vec_width(cps: int) -> int:
    """Floats per load of the row-vector K4: ``min(cps, 4)``, which divides
    every stream's first lane ``g * cps`` and 128, so no load straddles
    the rotation's wrap."""
    return min(cps, 4)


def gather_routes(cps: int, window: int, data_ptr: int = 0
                  ) -> dict[str, Route]:
    """Every K2 kernel that takes this shape, by name: ``old``
    (``gather.cu``, any shape) and ``vec`` (``gather_vec.cu``: cps in
    :data:`VEC_CPS`, W % 4 == 0, x aligned to its vector width)."""
    routes = {"old": Route(_cuda.GATHER, "ofpt_gather", "")}
    v = vec_width(cps)
    if cps in VEC_CPS and window % TILE_ROWS == 0 and data_ptr % (4 * v) == 0:
        routes["vec"] = Route(_cuda.GATHER_VEC, "ofpt_gather_vec",
                              f"cps{cps}")
    return routes


def gather_kernel_for(cps: int, window: int, data_ptr: int = 0) -> Route:
    """The kernel a CUDA gather of this shape runs on: the row-vector one
    where it takes the shape, else the old one."""
    routes = gather_routes(cps, window, data_ptr)
    return routes.get("vec", routes["old"])


def roll_routes(cps: int, window: int, data_ptr: int = 0
                ) -> dict[str, Route]:
    """Every K4 kernel that takes this (wide-layout) shape, by name:
    ``old`` (``gather_roll.cu``, any) and ``vec`` (``gather_roll_vec.cu``:
    ``W * 8 / V`` a multiple of :data:`TILE_ROWS`, x aligned to V
    floats)."""
    routes = {"old": Route(_cuda.GATHER_ROLL, "ofpt_gather_roll", "")}
    v = roll_vec_width(cps)
    if window * (8 // v) % TILE_ROWS == 0 and data_ptr % (4 * v) == 0:
        routes["vec"] = Route(_cuda.GATHER_ROLL_VEC, "ofpt_gather_roll_vec",
                              f"v{v}")
    return routes


def roll_kernel_for(cps: int, window: int, data_ptr: int = 0) -> Route:
    """The kernel a CUDA roll gather of this shape runs on: the row-vector
    one where it takes the shape, else the old one."""
    routes = roll_routes(cps, window, data_ptr)
    return routes.get("vec", routes["old"])


def gather_vec_addresses(starts, stream_ids, t, c, cps, window, pre=0,
                         anchored=False):
    """``gather_vec.cu``'s addressing.  Thread ``e = i * W/4 + q`` copies
    rows ``4q .. 4q+3`` of hit ``i``'s window → ``(loads [N, W/4, 4,
    cps/V], stores [N, W/4, cps])`` int64: the flat x offset of each
    V-float load (row r of the quad, vector j: channels ``jV .. jV+V-1``),
    all issued before the stores, and the flat out offset of each 16-byte
    store (channel c, rows ``4q .. 4q+3`` of ``out[i, c]``)."""
    dev = starts.device
    v = vec_width(cps)
    q = torch.arange(window // TILE_ROWS, device=dev)
    rows = _rows(starts.long(), t, window, pre, anchored)
    sids = torch.clamp(stream_ids.long(), 0, c // cps - 1)
    row = (rows[:, None, None, None] + TILE_ROWS * q[:, None, None]
           + torch.arange(TILE_ROWS, device=dev)[:, None])
    loads = row * c + (sids * cps)[:, None, None, None] + v * torch.arange(
        cps // v, device=dev)
    hit = torch.arange(starts.shape[0], device=dev)[:, None, None]
    stores = (hit * cps * window + torch.arange(cps, device=dev) * window
              + TILE_ROWS * q[:, None])
    return loads, stores


def roll_vec_addresses(row_start, stream_ids, t, c, cps, window):
    """``gather_roll_vec.cu``'s addressing.  Hit i's ``[W, 8]`` slab is
    ``W * 8 / V`` vectors of V floats in order; thread t of the hit's
    ``P = W * 8 / (V * 4)`` takes vectors ``p = t + kP``, k < 4 → ``(loads
    [N, P, 4], stores [N, P, 4])`` int64 flat offsets of each V-float load
    (row ``p // (8/V)``, lanes ``(lane0 + V * (p % (8/V))) & 127`` of the
    stream's tile) and store."""
    dev = row_start.device
    v = roll_vec_width(cps)
    lpr = 8 // v
    per_hit = window * lpr // TILE_ROWS
    groups = LANE // cps
    r = torch.clamp(row_start.long() & ~7, 0, t - window)
    sids = torch.clamp(stream_ids.long(), 0, c // cps - 1)
    tile = sids // groups
    lane0 = (sids - tile * groups) * cps
    p = (torch.arange(per_hit, device=dev)[:, None]
         + per_hit * torch.arange(TILE_ROWS, device=dev))
    loads = ((r[:, None, None] + p // lpr) * c + (tile * LANE)[:, None, None]
             + ((lane0[:, None, None] + v * (p % lpr)) & (LANE - 1)))
    hit = torch.arange(row_start.shape[0], device=dev)[:, None, None]
    return loads, hit * window * 8 + v * p


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
    route = gather_kernel_for(cps, window, x.data_ptr())
    return _launch_gather(route, x, starts, stream_ids, cps, window, pre,
                          anchored)


def _launch_gather(route: Route, x, starts, stream_ids, cps, window, pre,
                   anchored):
    """Launch K2 on ``route`` (checked by the caller).  Only a measurement
    names a route other than :func:`gather_kernel_for`'s."""
    t, c = x.shape
    n = starts.shape[0]
    out = torch.empty((n, cps, window), dtype=torch.float32, device=x.device)
    if n:
        route.kernel.launch(
            route.entry, x.data_ptr(), starts.data_ptr(),
            stream_ids.data_ptr(), out.data_ptr(), n, t, c, cps, window, pre,
            int(anchored), _cuda.stream(), variant=route.variant,
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
    route = roll_kernel_for(cps, window, x.data_ptr())
    return _launch_roll(route, x, row_start, stream_ids, cps, window)


def _launch_roll(route: Route, x, row_start, stream_ids, cps, window):
    """Launch K4 on ``route`` (checked by the caller).  Only a measurement
    names a route other than :func:`roll_kernel_for`'s."""
    t, c = x.shape
    n = row_start.shape[0]
    out = torch.empty((n, window, 8), dtype=torch.float32, device=x.device)
    if n:
        route.kernel.launch(
            route.entry, x.data_ptr(), row_start.data_ptr(),
            stream_ids.data_ptr(), out.data_ptr(), n, t, c, cps, window,
            _cuda.stream(), variant=route.variant,
        )
    return out
