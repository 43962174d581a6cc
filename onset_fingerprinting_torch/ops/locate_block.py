"""The realtime engine's per-block locate step: the block is written to the
device audio ring, every channel that fired in it goes through the
fixed-capacity locator in onset order, the completed hits go to the device
event queue, and the sample counter advances by the block.

This is the ring write and the locate half of the JAX engine's step
(``realtime/engine.py:232-320`` of the JAX package), which XLA fuses into
the block's program.
Written as PyTorch ops it is about a thousand small operations per channel
(the masked slot table, two feasibility tiers, twenty unrolled Newton
iterations), several thousand kernels per block: even replayed from a
CUDA graph that is more than the block's 1.333 ms.  So on the card it is
one kernel, ``csrc/locate_block.cu`` (counter ``_cuda.LOCATE_BLOCK``), and
:func:`locate_block_reference` is its plain version: the JAX step's masks
ported literally (``locate/multilaterate.make_locate_update``), which the
CPU runs and the card tests hold the kernel to.

Dispatch is by device, as for the other kernels: a CPU tensor runs the
plain version (counted in ``plain_calls``), a CUDA tensor launches the
kernel or raises.  The kernel takes the Newton locator or the learned one
(``model=FCNNBundle``, JAX multilaterate.py:789-815), with or without CC
refinement.

The ring write (``block=``, with ``ring=``): the step's block ``[B, C]``
goes to the ring at its head, wrapping, and the ring's counter advances by
B, in place, before anything reads the ring (the JAX step's
``core/ring_buffer.ring_write`` before its ``ring_read_last``).  On the
card it runs at the start of the same launch (variants named ``"ring"``,
``"ring+fcnn"``, ...); the plain version is ``core/ring_buffer.ring_write``
ahead of :func:`locate_block_reference` (counted in
``plain_variants["ring_write"]``).  Without ``block`` nothing is written.

CC refinement (``cc_refine=True``, JAX multilaterate.py:661-705): each
fired onset is refined against the oldest candidate group's seed over the
``window_len``-sample window of live audio ending at the block.  The step
passes the engine's audio ring itself (``ring=``): the kernel reads the
window's two channels straight from it, so the captured step needs no
``ring_read_last`` copy; the plain version reads the window with
``ring_read_last`` and runs the JAX step's refinement.  The kernel sums the
normalised CC directly at the tolerance window's lags where the plain
version takes an rFFT, so two lags within float32 rounding of each other
may pick differently: ``log=`` (an int32 ``[C, LOG_W]`` buffer) records
each update's refinement, and :func:`refine_reference` recomputes one in
the plain version, with the CC, to tell a tie from a fault.
:func:`cc_schedule_reference` is the kernel's CC schedule on the CPU (its
order of double sums, its first argmax, its heuristic), which the CPU
tests hold to the JAX package's refinement.

:func:`locate_streams` is the sharded serve path's offline entry: a batch
of streams' onset-ordered events through the same update from empty slot
tables (Newton or the learned locator, no refinement), one launch of the
kernel's stream-batched entry, one CTA per stream (variant ``"streams"``,
``"streams+fcnn"`` with a model);
:func:`locate_streams_reference` is the JAX function's ``lax.scan``.

The learned locator in the kernel: at construction the FCNN's eval-mode
BatchNorm is folded into each Dense (:func:`fold_fcnn`) and the layers are
packed into one float32 buffer (:func:`pack_fcnn`), which the kernel's
first warp evaluates one hidden unit per lane on a completion, in place of
the Newton solve; the depth and widths travel beside the buffer in a small
int32 array on the card (:meth:`FCNNPlan.header`), and the layer's two
activation vectors lie in the launch's dynamic shared memory, sized from
the widest layer.  :func:`fcnn_plan` states what the kernel takes: any
depth and width whose two vectors fit the launch's shared memory (beside
the CC refinement's sections), two lag features in, a point out, an
activation the kernel has; an FCNN outside it raises when the
``LocateBlock`` is built for the card.  :func:`fcnn_packed_reference`
evaluates the packed buffer on the CPU in the kernel's order of rounding.

The kernel updates the locator state, the queue and the counter in place.
Without ``out=`` the wrapper hands it fresh copies and the inputs stay as
they were; with ``out=`` (which may be the inputs themselves: the engine's
step passes its own state) the new state is written there, on the CPU by
``copy_``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

import numpy as np

from onset_fingerprinting_torch.core.ring_buffer import (
    RingBuffer,
    ring_read_last,
    ring_write,
)
from onset_fingerprinting_torch.core.tree import leaves, write_into
from onset_fingerprinting_torch.detect.refine import (
    cc_refine_adjust_jax,
    cc_refine_terms,
)
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate.multilaterate import (
    LOOKAROUND,
    NORM_CUTOFF,
    ONSET_TOL,
    LocatorState,
    Multilaterate3D,
    _at,
    locator_init,
    make_locate_update,
)
from onset_fingerprinting_torch.models.fcnn import ACTIVATIONS, FCNN
from onset_fingerprinting_torch.ops import _cuda

#: _BIG sorts the channels that did not fire after every real onset
_BIG = 10 ** 9
#: the kernel's static limits (csrc/locate_block.cu): a channel per thread
#: of its first warp when it reads the block, a slot per lane
MAX_CHANNELS = 32
MAX_SLOTS = 32
MAX_TIERS = 4
#: the kernel's shared memory (csrc/locate_block.cu): what its static
#: ``Shared`` struct may take, and the opt-in limit of one CTA on the H100
#: (static and dynamic together), in bytes
STATIC_SMEM = 2048
SMEM_OPTIN = 232448
#: words of the FCNN header the kernel reads in one load
#: (csrc/locate_block.cu::FW_LANES)
FW_LANES = 32
#: activation codes of csrc/locate_block.cu::act
ACT_CODES = {"relu": 0, "silu": 1, "leakyrelu": 2, "elu": 3, "tanh": 4,
             "sigmoid": 5}
MODEL_INPUTS = {"arrival": 0, "by_channel": 1}
#: ints per update in the refinement log (csrc/locate_block.cu::LOG_W):
#: done, go (a candidate existed), seed channel, channel, pos0, pos1,
#: c_seed, c_new, ok, the CC's argmax index
LOG_W = 10
LOG_FIELDS = ("done", "go", "ch0", "ch1", "pos0", "pos1", "c_seed", "c_new",
              "ok", "arg")
#: the sharded serve path's empty event key (parallel/sharding.py::_BIG)
EV_BIG = 2 ** 30
#: the kernel's CC schedule (csrc/locate_block.cu::CC_SEGS): each lag's
#: terms in CC_SEGS segments of the contribution range, summed apart
CC_SEGS = 8


class EventQueue(NamedTuple):
    """The device ring of located hits."""

    points: torch.Tensor  # [E, 2] float32
    onsets: torch.Tensor  # [E] int32 absolute onset sample
    emits: torch.Tensor   # [E] int32 start sample of the emitting block
    count: torch.Tensor   # 0-d int32 cumulative hit counter


class BlockHits(NamedTuple):
    onsets: torch.Tensor  # [C] int32 absolute onset sample of each channel
    points: torch.Tensor  # [C, 2] float32, zero where no hit completed
    emits: torch.Tensor   # [C] bool: a hit completed at this channel


class _LocDesc(ctypes.Structure):
    # must match csrc/locate_block.cu::LocDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "C", "G", "S", "H", "W", "E", "T", "B")] + [
        ("radius", ctypes.c_float), ("c_over_sr", ctypes.c_float),
        ("tols", ctypes.c_float * MAX_TIERS)] + [
        (n, ctypes.c_int) for n in (
            "has_model", "fcnn_w", "act", "model_input", "cc", "win_len",
            "ring_cap")]


class FCNNPlan(NamedTuple):
    """An FCNN as the kernel runs it: the widths from the input through
    each hidden layer to the output, and the activation's code."""

    widths: tuple
    act: int

    @property
    def smem(self) -> int:
        """Bytes of the layer's input and output vectors in the launch's
        shared memory: two of the widest layer, float32."""
        return 2 * max(self.widths) * 4

    def header(self, device=None) -> torch.Tensor:
        """The depth and widths as the kernel reads them: int32 ``[layers,
        width 0, ..., width layers]``, zeros after them to at least
        ``FW_LANES`` words (warp 0 reads the first ``FW_LANES`` in one
        load)."""
        words = [len(self.widths) - 1, *self.widths]
        words += [0] * max(0, FW_LANES - len(words))
        return torch.tensor(words, dtype=torch.int32, device=device)


def fcnn_plan(net: FCNN, smem_used: int = 0) -> FCNNPlan:
    """The kernel's plan for ``net``; raises ``ValueError`` for an FCNN the
    kernel does not take (there is no plain fallback on the card): one that
    does not map 2 lag features to a point, an activation the kernel has
    no code for, or two activation vectors of its widest layer past the
    launch's shared memory once ``smem_used`` bytes (the CC refinement's
    sections) are taken."""
    if not isinstance(net, FCNN):
        raise ValueError(f"the locate kernel takes an FCNN, not "
                         f"{type(net).__name__}")
    lins = [*net.layers, net.out]
    widths = (lins[0].in_features, *(lin.out_features for lin in lins))
    if widths[0] != 2 or widths[-1] != 2:
        raise ValueError(f"the locate kernel's FCNN plan maps 2 lag "
                         f"features to a point, not {widths[0]} -> "
                         f"{widths[-1]}")
    if net.activation not in ACT_CODES:
        raise ValueError(f"the locate kernel's FCNN plan has no activation "
                         f"{net.activation!r}")
    plan = FCNNPlan(widths, ACT_CODES[net.activation])
    room = SMEM_OPTIN - STATIC_SMEM - smem_used
    if plan.smem > room:
        raise ValueError(
            f"the locate kernel's FCNN plan holds two activation vectors "
            f"of the widest layer ({max(widths)} units) in shared memory: "
            f"{plan.smem} bytes, past the launch's {room} bytes "
            f"({SMEM_OPTIN} less {STATIC_SMEM} static and {smem_used} for "
            f"the CC refinement)")
    return plan


@torch.no_grad()
def fold_fcnn(net: FCNN) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``[(W [out, in], b [out]), ...]`` of ``net`` in eval mode, each
    hidden layer's BatchNorm folded into its Dense (in float64, rounded
    once to float32): ``W * s``, ``(b - mean) * s + beta`` with ``s = gamma
    / sqrt(var + eps)``, the port's ``fcnn.BatchNorm`` (flax's)."""
    out = []
    for i, lin in enumerate([*net.layers, net.out]):
        w = lin.weight.detach().double().cpu()
        b = (lin.bias.detach().double().cpu() if lin.bias is not None
             else torch.zeros(w.shape[0], dtype=torch.float64))
        if i < len(net.layers) and len(net.norms):
            bn = net.norms[i]
            sc = bn.weight.double().cpu() * torch.rsqrt(
                bn.running_var.double().cpu() + bn.eps)
            w = w * sc[:, None]
            b = (b - bn.running_mean.double().cpu()) * sc \
                + bn.bias.double().cpu()
        out.append((w.float(), b.float()))
    return out


def pack_fcnn(net: FCNN) -> tuple[FCNNPlan, torch.Tensor]:
    """The plan and one float32 buffer (on the CPU): for each layer its
    folded ``W`` row-major then ``b``."""
    plan = fcnn_plan(net)
    return plan, torch.cat([t.reshape(-1) for wb in fold_fcnn(net)
                            for t in wb])


def fcnn_packed_reference(plan: FCNNPlan, packed: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """The packed FCNN on ``x [N, 2]`` in the kernel's order of rounding:
    each unit starts at its bias and adds ``W[j, k] * h[k]`` for k in
    order, each product and sum rounded on its own; the activation after
    every hidden layer."""
    act = ACTIVATIONS[next(k for k, v in ACT_CODES.items()
                           if v == plan.act)]
    h = x.to(torch.float32)
    off = 0
    n = len(plan.widths) - 1
    for layer in range(n):
        nin, nout = plan.widths[layer], plan.widths[layer + 1]
        w = packed[off: off + nin * nout].reshape(nout, nin)
        acc = packed[off + nin * nout: off + nin * nout + nout].expand(
            h.shape[0], nout).clone()
        for k in range(nin):
            acc = acc + w[:, k] * h[:, k: k + 1]
        h = act(acc) if layer < n - 1 else acc
        off += nin * nout + nout
    return h


class LocateBlock:
    """The locate step of one engine: the locator's update function (its
    lag maps and geometry on ``device``, None = the card), the packed FCNN
    of a learned locator and the constants the kernel takes."""

    def __init__(self, locator: Multilaterate3D, n_channels: int,
                 block_size: int, capacity: int = 8, cc_refine: bool = False,
                 model=None, model_input: str = "arrival", device=None):
        self.model = model
        self.model_input = model_input
        self.fcnn = None
        self.fcnn_header = None
        if model is not None:
            # an FCNN the kernel cannot run raises here, before anything
            # reaches the card; the CPU runs any FCNN in its plain version
            try:
                self.fcnn = pack_fcnn(model.model)
            except ValueError:
                if device is None or torch.device(device).type == "cuda":
                    raise
        device = resolve_device(device)
        if self.fcnn is not None:
            self.fcnn = (self.fcnn[0], self.fcnn[1].to(device))
            self.fcnn_header = self.fcnn[0].header(device)
        self.update = make_locate_update(
            locator, capacity=capacity, cc_refine=cc_refine, model=model,
            model_input=model_input, device=device)
        self.tables = self.update.tables
        self.n_channels = n_channels
        self.block_size = block_size
        self.capacity = capacity
        self.cc_refine = cc_refine
        self.radius = float(locator.radius)
        self.c_over_sr = float(locator.c / locator.sr)
        self.tols = tuple(float(locator.samples_per_cm) * float(t)
                          for t in locator.feasibility_tols)
        self.window_len = self.update.window_len

    @property
    def cc_smem(self) -> int:
        """Bytes of the CC refinement's two sections (double) in the
        launch's shared memory, 0 without it."""
        return 2 * self.window_len * 8 if self.cc_refine else 0

    def check_kernel_shape(self) -> None:
        """Raise on what ``csrc/locate_block.cu`` does not take."""
        if self.n_channels > MAX_CHANNELS or self.capacity > MAX_SLOTS \
                or len(self.tols) > MAX_TIERS:
            raise ValueError(
                f"the locate kernel takes at most {MAX_CHANNELS} channels, "
                f"{MAX_SLOTS} slots and {MAX_TIERS} feasibility tiers")
        if self.model is not None:
            fcnn_plan(self.model.model, self.cc_smem)


def _fcnn_args(lb: LocateBlock, d: _LocDesc, device) -> tuple:
    """Set the learned locator's fields of ``d`` and return the packed
    buffer's and the header's pointers (None, None without a model)."""
    if lb.model is None:
        return None, None
    plan, packed = lb.fcnn
    if packed.device != device or lb.fcnn_header.device != device:
        raise ValueError("the packed FCNN must be on the events' device")
    d.has_model = 1
    d.fcnn_w = max(plan.widths)
    d.act = plan.act
    d.model_input = MODEL_INPUTS[lb.model_input]
    return packed.data_ptr(), lb.fcnn_header.data_ptr()


def _window(lb: LocateBlock, ring, sample_count):
    """The refinement's live window and its first sample (the JAX
    engine's ``ring_read_last`` after the block's write)."""
    if ring is None:
        raise ValueError("cc_refine needs the engine's audio ring")
    return (ring_read_last(ring, lb.window_len),
            sample_count + lb.block_size - lb.window_len)


def locate_block_reference(lb: LocateBlock, lstate: LocatorState,
                           queue: EventQueue, on: torch.Tensor,
                           deltas: torch.Tensor, sample_count: torch.Tensor,
                           ring: RingBuffer | None = None, out=None):
    """Plain version: the JAX engine's locate loop and queue push
    (engine.py:249-304 there), every slot's state selected by the
    channel's validity, never branched on.  With ``cc_refine`` the
    refinement reads the live window from ``ring`` (the audio ring after
    the block's write).  Returns ``(locator state, event queue, BlockHits,
    sample_count + block size)``.  ``out``: a ``(locator state, event
    queue, counter)`` to copy the new ones into and return (it may be the
    inputs)."""
    _cuda.LOCATE_BLOCK.plain_calls += 1
    dev = on.device
    c = lb.n_channels
    onsets_abs = sample_count + deltas
    extra = _window(lb, ring, sample_count) if lb.cc_refine else ()
    # the fired channels in onset order (a stable sort, as jnp.argsort:
    # ties keep channel order)
    order = torch.sort(torch.where(on, deltas, _BIG), stable=True).indices
    chans = torch.arange(c, device=dev)
    points = torch.zeros((c, 2), dtype=torch.float32, device=dev)
    emits = torch.zeros((c,), dtype=torch.bool, device=dev)
    for i in range(c):  # unrolled over the static channel count
        ch = order[i]
        valid = _at(on, ch)
        new_l, point, emit = lb.update(lstate, ch, _at(onsets_abs, ch),
                                       *extra)
        lstate = LocatorState(*(torch.where(valid, n, o)
                                for n, o in zip(new_l, lstate)))
        row = chans == ch
        points = torch.where(row[:, None],
                             torch.where(valid & emit, point, 0.0), points)
        emits = torch.where(row, valid & emit, emits)
    # completed hits go to the event queue, in channel order
    e = queue.points.shape[0]
    slots = torch.arange(e, device=dev)
    qp, qo, qe, qc = queue
    for i in range(c):
        put = emits[i] & (slots == torch.remainder(qc, e))
        qp = torch.where(put[:, None], points[i], qp)
        qo = torch.where(put, onsets_abs[i], qo)
        qe = torch.where(put, sample_count, qe)
        qc = qc + emits[i].to(torch.int32)
    new = (lstate, EventQueue(qp, qo, qe, qc), sample_count + lb.block_size)
    if out is not None:
        new = write_into(out, new)
    return new[0], new[1], BlockHits(onsets_abs, points, emits), new[2]


def _check_ring(lb: LocateBlock, ring: RingBuffer | None,
                block: torch.Tensor | None, device) -> None:
    """Raise on a ring (and block) the step cannot take: the ring
    contiguous float32 ``[N, C]`` with a 0-d int32 counter, the block
    contiguous float32 ``[B, C]`` (B the step's block size, at most N), all
    on the events' device."""
    c = lb.n_channels
    if ring is None:
        if block is not None:
            raise ValueError("the block is written to a ring: give ring=")
        return
    data, counter = ring.data, ring.counter
    if (data.dtype != torch.float32 or data.dim() != 2
            or tuple(data.shape[1:]) != (c,) or not data.is_contiguous()):
        raise ValueError(f"the ring must be contiguous float32 [N, {c}]")
    if counter.dtype != torch.int32 or counter.dim() != 0:
        raise ValueError("the ring's counter must be a 0-d int32 tensor")
    if block is not None:
        if (block.dtype != torch.float32 or not block.is_contiguous()
                or tuple(block.shape) != (lb.block_size, c)):
            raise ValueError(f"the block must be contiguous float32 "
                             f"[{lb.block_size}, {c}]")
        if block.shape[0] > ring.capacity:
            raise ValueError(f"a block of {block.shape[0]} frames does not "
                             f"fit a ring of {ring.capacity} once")
    if any(v is not None and v.device != device
           for v in (data, counter, block)):
        raise ValueError("ring, counter and block must be on the events' "
                         "device")


def locate_block(lb: LocateBlock, lstate: LocatorState, queue: EventQueue,
                 on: torch.Tensor, deltas: torch.Tensor,
                 sample_count: torch.Tensor, ring: RingBuffer | None = None,
                 log: torch.Tensor | None = None, out=None,
                 block: torch.Tensor | None = None):
    """The block's step: :func:`locate_block_reference` for CPU tensors,
    ``csrc/locate_block.cu`` for CUDA tensors.  ``ring``: the engine's
    audio ring; ``block``: the block ``[B, C]`` to write to ``ring`` first,
    in place, data and counter (without it the ring is only read, by
    ``cc_refine``, as it stands); ``log``: a zeroed int32 ``[C, LOG_W]``
    the kernel writes each update's refinement into (the plain version
    writes none).  Returns ``(locator state, event queue, BlockHits,
    sample_count + block size)``; ``out`` as for the plain version."""
    _check_ring(lb, ring, block, on.device)
    if on.device.type == "cpu":
        if block is not None:
            _cuda.LOCATE_BLOCK.plain_variants["ring_write"] += 1
            ring.counter.copy_(ring_write(ring, block).counter)
        return locate_block_reference(lb, lstate, queue, on, deltas,
                                      sample_count, ring, out)
    lb.check_kernel_shape()
    c, g = lb.n_channels, lb.capacity
    e = queue.points.shape[0]
    maps = lb.tables.maps
    if on.shape != (c,) or deltas.shape != (c,) or on.dtype != torch.bool \
            or deltas.dtype != torch.int32:
        raise ValueError(f"on must be bool [{c}] and deltas int32 [{c}]")
    state = (lstate, queue, sample_count)
    i32 = [lstate.sensors, lstate.onsets, lstate.count, lstate.age,
           lstate.next_age, queue.onsets, queue.emits, queue.count,
           sample_count]
    if any(v.dtype != torch.int32 or not v.is_contiguous() for v in i32) \
            or queue.points.dtype != torch.float32 \
            or not queue.points.is_contiguous():
        raise ValueError("the locator state and queue must be contiguous "
                         "int32 (points float32)")
    tensors = i32 + [on, deltas, queue.points, *lb.tables]
    if any(v.device != on.device for v in tensors):
        raise ValueError("state, queue, tables and events must be on one "
                         "device")
    if out is None:
        out = (LocatorState(*(v.clone() for v in lstate)),
               EventQueue(*(v.clone() for v in queue)), sample_count.clone())
    else:
        if any(o.shape != v.shape or o.dtype != v.dtype
               or o.device != v.device or not o.is_contiguous()
               for o, v in zip(leaves(out), leaves(state), strict=True)):
            raise ValueError("out must be a contiguous (locator state, "
                             "queue, counter) like the inputs")
        write_into(out, state)
    d = _LocDesc(C=c, G=g, S=maps.shape[0], H=maps.shape[2],
                 W=maps.shape[3], E=e, T=len(lb.tols), B=lb.block_size,
                 radius=lb.radius, c_over_sr=lb.c_over_sr)
    for i, t in enumerate(lb.tols):
        d.tols[i] = t
    fcnn_ptrs = _fcnn_args(lb, d, on.device)
    ring_ptrs = (None, None, None)
    if lb.cc_refine:
        if ring is None:
            raise ValueError("cc_refine needs the engine's audio ring")
        if lb.window_len > ring.capacity:
            raise ValueError(f"the refinement window ({lb.window_len}) "
                             f"exceeds the ring ({ring.capacity})")
        d.cc, d.win_len = 1, lb.window_len
    if ring is not None:
        d.ring_cap = ring.capacity
        ring_ptrs = (None if block is None else block.data_ptr(),
                     ring.data.data_ptr(), ring.counter.data_ptr())
    if log is not None and (log.shape != (c, LOG_W)
                            or log.dtype != torch.int32
                            or log.device != on.device
                            or not log.is_contiguous()):
        raise ValueError(f"log must be a contiguous int32 [{c}, {LOG_W}]")
    new_l, new_q, count = out
    hits = BlockHits(torch.empty_like(deltas),
                     torch.empty((c, 2), dtype=torch.float32,
                                 device=on.device),
                     torch.empty_like(on))
    ptrs = [v.data_ptr() for v in (
        on, deltas, count, *new_l, *lb.tables, *new_q, *hits)]
    # the variant: "ring" with the ring write, "fcnn" with the learned
    # locator, "cc_refine" with the refinement, joined by "+" in that order
    variant = "+".join(name for name, on in (
        ("ring", block is not None), ("fcnn", lb.model is not None),
        ("cc_refine", lb.cc_refine)) if on)
    _cuda.LOCATE_BLOCK.launch(
        "ofpt_locate_block", ctypes.addressof(d), *ptrs, *fcnn_ptrs,
        *ring_ptrs, None if log is None else log.data_ptr(), _cuda.stream(),
        variant=variant)
    return new_l, new_q, hits, count


def refine_reference(ring: RingBuffer, win_len: int, ch0: int, ch1: int,
                     pos0: int, pos1: int) -> dict:
    """One update's CC refinement in the plain version, with what a tie
    check needs: the pair's window read from ``ring`` as the step reads it
    (``ring_read_last``), then :func:`refine_pair_reference`."""
    window = ring_read_last(ring, win_len)
    return refine_pair_reference(
        torch.stack([window[:, ch0], window[:, ch1]], dim=1), pos0, pos1)


def refine_pair_reference(pair: torch.Tensor, pos0: int, pos1: int) -> dict:
    """The plain refinement of one pair's window ``[W, 2]``:
    ``cc_refine_terms``' masked normalised CC ``cc`` (rFFT), its first
    argmax ``arg`` (an index of the full CC), the heuristic's energies
    ``da``, ``db``; ``c_seed``, ``c_new`` and ``ok`` as
    ``cc_refine_adjust_jax`` gives them; and ``tie_tol(a, b)``: how far
    apart the CC at two indices may round (16 float32 ulps of ``|x| |y|
    log2-length``, over the smaller contribution count)."""
    p0 = torch.tensor(pos0, dtype=torch.int32, device=pair.device)
    p1 = torch.tensor(pos1, dtype=torch.int32, device=pair.device)
    args = dict(lookaround=LOOKAROUND, onset_tolerance=ONSET_TOL,
                normalization_cutoff=NORM_CUTOFF)
    t = cc_refine_terms(pair, p0, p1, **args)
    c_seed, c_new, _ = cc_refine_adjust_jax(pair, p0, p1, **args)
    norm = t.norm.cpu().numpy()
    scale = float(torch.linalg.vector_norm(t.x)
                  * torch.linalg.vector_norm(t.y))
    eps = float(np.finfo(np.float32).eps)
    log_len = float(np.log2(2 * t.x.shape[0]))

    def tie_tol(a: int, b: int) -> float:
        return 16 * eps * log_len * scale / min(norm[a], norm[b])

    return dict(arg=int(t.arg), c_seed=int(c_seed), c_new=int(c_new),
                ok=bool(t.valid), cc=t.cc.cpu().numpy(), tie_tol=tie_tol,
                da=float(t.da), db=float(t.db))


def _sum_tree(v: np.ndarray, offsets) -> np.ndarray:
    """``__shfl_down_sync`` sums over the last axis, as lane 0 ends them:
    for each offset o, lanes ``[0, o)`` add lanes ``[o, 2o)``."""
    v = v.copy()
    for o in offsets:
        v[..., :o] = v[..., :o] + v[..., o: 2 * o]
    return v[..., 0]


def cc_schedule_reference(x: np.ndarray, y: np.ndarray, pos0: int,
                          pos1: int) -> dict:
    """The kernel's refinement of one pair (``csrc/locate_block.cu::
    cc_refine``) on the CPU, from the sections ``x``, ``y`` (``[n]``
    float32, the plain version's ``cc_refine_terms`` ``x`` and ``y``) and
    the window positions: its CC at the tolerance window's ``2 *
    ONSET_TOL`` indices in its order of sums (each window index's terms in
    order of m within each of ``CC_SEGS`` segments of ``ceil(n /
    CC_SEGS)`` made odd, in float64, each product exact; the segment sums as
    ``((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))``; then float32 over
    the contribution count), its first argmax (the lowest index of the
    largest value above -inf; none: index 0 of the full CC), and the
    energy heuristic (float32 weights, their products' sums in float64 by
    lane: k = lane, lane + 32, then a shuffle tree).  Returns ``arg`` (an
    index of the full CC), ``cc`` (the window's values, -inf outside the
    CC), ``c_seed``, ``c_new`` and ``ok``."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    n = x.shape[0]
    cur = pos1 - pos0
    center = n - cur
    lo = center - ONSET_TOL
    idx = lo + np.arange(2 * ONSET_TOL)
    lag = idx - (n - 1)
    seg_len = -(-n // CC_SEGS) | 1
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    part = np.zeros((2 * ONSET_TOL, CC_SEGS))
    for t in range(seg_len):
        m = np.arange(CC_SEGS) * seg_len + t  # [segs]
        xi = m[None, :] + lag[:, None]        # [lags, segs]
        ok = (m[None, :] < n) & (xi >= 0) & (xi < n)
        term = xd[np.clip(xi, 0, n - 1)] * yd[np.minimum(m, n - 1)][None, :]
        part = np.where(ok, part + term, part)
    tot = _sum_tree(part, [CC_SEGS >> k
                           for k in range(1, CC_SEGS.bit_length())])
    ni = np.where(idx < n, idx, 2 * n - 2 - idx)
    cnt = np.maximum(ni + 1, NORM_CUTOFF).astype(np.float32)
    inside = (idx >= 0) & (idx < 2 * n - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cc = np.where(inside, tot.astype(np.float32) / cnt,
                      np.float32(-np.inf)).astype(np.float32)
    above = np.where(cc > -np.inf)[0]
    argf = 0 if above.size == 0 else lo + int(
        above[np.argmax(cc[above])])
    lagv = -(argf - (center - ONSET_TOL) - (cur + ONSET_TOL))
    valid = (center - ONSET_TOL >= 0 and center + ONSET_TOL <= 2 * n - 1
             and pos0 >= LOOKAROUND and pos1 > pos0 and pos1 < n)
    ld = cur - lagv
    nn = abs(ld)
    denom = np.float32(max(nn - 1, 1))
    ne = np.float32(-2.7182817459106445)
    sx, sy = min(pos0, pos0 + ld), min(pos1, pos1 - ld)
    terms = np.zeros((2, 64))
    for k in range(min(nn, ONSET_TOL + 1)):
        wd = np.exp((ne * np.float32(k)) / denom, dtype=np.float32)
        wa = np.exp((ne * np.float32(nn - 1 - k)) / denom, dtype=np.float32)
        lane, rnd = k % 32, k // 32
        terms[0, lane + 32 * rnd] = np.float64(
            x[min(max(sx + k, 0), n - 1)] * wd)
        terms[1, lane + 32 * rnd] = np.float64(
            y[min(max(sy + k, 0), n - 1)] * wa)
    lanes = terms[:, :32] + terms[:, 32:]  # each lane: k, then k + 32
    da, db = _sum_tree(lanes, (16, 8, 4, 2, 1))
    fa = np.float32(da) / max(np.float32(x.max()), np.float32(1e-20))
    fb = np.float32(db) / max(np.float32(y.max()), np.float32(1e-20))
    move_seed = bool(fa > fb) and pos0 + ld >= 0
    return dict(arg=argf, cc=cc, ok=bool(valid),
                c_seed=ld if move_seed else 0,
                c_new=0 if move_seed else -ld)


def check_refinements(lb: LocateBlock, log: torch.Tensor, ring: RingBuffer
                      ) -> tuple[int, list]:
    """Each refinement a launch logged (``locate_block(log=)``) against the
    plain version on the same window (:func:`refine_reference`): the same
    ``ok``; the same argmax, or one whose plain CC is within the rounding
    of the plain argmax's (a tie); the same corrections where the argmax
    agrees, or energies ``da``, ``db`` within 1e-5 of each other.  Returns
    ``(refinements checked, ties)``, a dict per tie; raises
    ``AssertionError`` on a difference that is not a tie."""
    n, ties = 0, []
    for row in log.cpu().numpy():
        r = dict(zip(LOG_FIELDS, (int(v) for v in row)))
        if not (r["done"] and r["go"]):
            continue
        ref = refine_reference(ring, lb.window_len, r["ch0"], r["ch1"],
                               r["pos0"], r["pos1"])
        n += 1
        assert bool(r["ok"]) == ref["ok"], (r, "ok differs")
        if not ref["ok"]:
            continue
        if r["arg"] != ref["arg"]:
            gap = float(ref["cc"][ref["arg"]] - ref["cc"][r["arg"]])
            tol = ref["tie_tol"](ref["arg"], r["arg"])
            assert 0.0 <= gap <= tol, (r, ref["arg"], gap, tol)
            ties.append(dict(r, plain_arg=ref["arg"], gap=gap, tol=tol))
        elif (r["c_seed"], r["c_new"]) != (ref["c_seed"], ref["c_new"]):
            gap = abs(ref["da"] - ref["db"])
            tol = 1e-5 * max(abs(ref["da"]), abs(ref["db"]))
            assert gap <= tol, (r, ref["c_seed"], ref["c_new"], gap, tol)
            ties.append(dict(r, plain=(ref["c_seed"], ref["c_new"]),
                             gap=gap, tol=tol))
    return n, ties


def locate_streams_reference(lb: LocateBlock, ev_on: torch.Tensor,
                             ev_ch: torch.Tensor):
    """Plain version of :func:`locate_streams`: the JAX function's
    ``lax.scan`` (sharding.py:655-673 there) per stream, from an empty
    slot table, each event's update kept where the event is real
    (``onset < EV_BIG``).  Returns ``(points [S, E, 2], emits [S, E]
    bool)``, points zero where not emitted."""
    _cuda.LOCATE_BLOCK.plain_calls += 1
    n, e = ev_on.shape
    dev = ev_on.device
    points = torch.zeros((n, e, 2), dtype=torch.float32, device=dev)
    emits = torch.zeros((n, e), dtype=torch.bool, device=dev)
    real = (ev_on < EV_BIG).cpu()
    for s in range(n):
        st = locator_init(lb.capacity, dev)
        for i in range(e):
            if not real[s, i]:  # the step leaves the state as it is
                continue
            new, point, emit = lb.update(st, ev_ch[s, i], ev_on[s, i])
            st = new
            points[s, i] = torch.where(emit, point, 0.0)
            emits[s, i] = emit
    return points, emits


def locate_streams(lb: LocateBlock, ev_on: torch.Tensor,
                   ev_ch: torch.Tensor):
    """A batch of streams' events ``ev_on [S, E]`` (onset samples in
    order, ``EV_BIG`` after the last real one) and ``ev_ch [S, E]``
    (channels) through the fixed-capacity locator (Newton, or the learned
    locator in the same code as the step's) from empty slot tables:
    :func:`locate_streams_reference` for CPU tensors, one launch of
    ``csrc/locate_block.cu``'s stream-batched entry for CUDA tensors.
    Returns ``(points [S, E, 2] cm, zero where not emitted; emits [S, E]
    bool)``."""
    if ev_on.device.type == "cpu":
        return locate_streams_reference(lb, ev_on, ev_ch)
    lb.check_kernel_shape()
    if lb.cc_refine:
        raise ValueError("the stream-batched locate entry runs without CC "
                         "refinement")
    if ev_on.dim() != 2 or ev_ch.shape != ev_on.shape \
            or ev_on.dtype != torch.int32 or ev_ch.dtype != torch.int32 \
            or not ev_on.is_contiguous() or not ev_ch.is_contiguous():
        raise ValueError("ev_on and ev_ch must be contiguous int32 [S, E]")
    if any(v.device != ev_on.device for v in lb.tables):
        raise ValueError("the lag tables must be on the events' device")
    n, e = ev_on.shape
    maps = lb.tables.maps
    d = _LocDesc(C=lb.n_channels, G=lb.capacity, S=maps.shape[0],
                 H=maps.shape[2], W=maps.shape[3], E=1, T=len(lb.tols),
                 B=lb.block_size, radius=lb.radius, c_over_sr=lb.c_over_sr)
    for i, t in enumerate(lb.tols):
        d.tols[i] = t
    fcnn_ptrs = _fcnn_args(lb, d, ev_on.device)
    points = torch.empty((n, e, 2), dtype=torch.float32, device=ev_on.device)
    emits = torch.empty((n, e), dtype=torch.bool, device=ev_on.device)
    if n:
        _cuda.LOCATE_BLOCK.launch(
            "ofpt_locate_streams", ctypes.addressof(d), n, e,
            ev_on.data_ptr(), ev_ch.data_ptr(),
            *(v.data_ptr() for v in lb.tables), *fcnn_ptrs,
            points.data_ptr(), emits.data_ptr(), _cuda.stream(),
            variant="streams" if lb.model is None else "streams+fcnn")
    return points, emits
