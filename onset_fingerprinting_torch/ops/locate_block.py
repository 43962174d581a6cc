"""The realtime engine's per-block locate step: every channel that fired in
a block goes through the fixed-capacity locator in onset order, the
completed hits go to the device event queue, and the sample counter
advances by the block.

This is the locate half of the JAX engine's step (``realtime/engine.py:
232-320`` of the JAX package), which XLA fuses into the block's program.
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
(``model=FCNNBundle``, JAX multilaterate.py:789-815) without CC
refinement; ``cc_refine=True`` runs only on the CPU.

The learned locator in the kernel: at construction the FCNN's eval-mode
BatchNorm is folded into each Dense (:func:`fold_fcnn`) and the layers are
packed into one float32 buffer (:func:`pack_fcnn`), which the kernel's
first warp evaluates one hidden unit per lane on a completion, in place of
the Newton solve.  :func:`fcnn_plan` states what the kernel takes (at most
``FCNN_MAX_WIDTH`` units per layer, ``FCNN_MAX_HIDDEN`` hidden layers, two
lag features in, a point out); an FCNN outside it raises when the
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

from onset_fingerprinting_torch.core.tree import leaves, write_into
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate.multilaterate import (
    LocatorState,
    Multilaterate3D,
    _at,
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
#: the kernel's FCNN plan (csrc/locate_block.cu): a unit per lane of warp 0,
#: in passes of 32
FCNN_MAX_WIDTH = 64
FCNN_MAX_HIDDEN = 8
#: activation codes of csrc/locate_block.cu::act
ACT_CODES = {"relu": 0, "silu": 1, "leakyrelu": 2, "elu": 3, "tanh": 4,
             "sigmoid": 5}
MODEL_INPUTS = {"arrival": 0, "by_channel": 1}


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
            "has_model", "n_layers", "act", "model_input")] + [
        ("widths", ctypes.c_int * (FCNN_MAX_HIDDEN + 2))]


class FCNNPlan(NamedTuple):
    """An FCNN as the kernel runs it: the widths from the input through
    each hidden layer to the output, and the activation's code."""

    widths: tuple
    act: int


def fcnn_plan(net: FCNN) -> FCNNPlan:
    """The kernel's plan for ``net``; raises ``ValueError`` for an FCNN the
    kernel does not take (there is no plain fallback on the card)."""
    if not isinstance(net, FCNN):
        raise ValueError(f"the locate kernel takes an FCNN, not "
                         f"{type(net).__name__}")
    lins = [*net.layers, net.out]
    widths = (lins[0].in_features, *(lin.out_features for lin in lins))
    if widths[0] != 2 or widths[-1] != 2:
        raise ValueError(f"the locate kernel's FCNN maps 2 lag features to "
                         f"a point, not {widths[0]} -> {widths[-1]}")
    if len(net.layers) > FCNN_MAX_HIDDEN or max(widths) > FCNN_MAX_WIDTH:
        raise ValueError(
            f"the locate kernel's FCNN plan is at most {FCNN_MAX_HIDDEN} "
            f"hidden layers of at most {FCNN_MAX_WIDTH} units; got "
            f"hidden layers {list(widths[1:-1])}")
    if net.activation not in ACT_CODES:
        raise ValueError(f"no kernel activation {net.activation!r}")
    return FCNNPlan(widths, ACT_CODES[net.activation])


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

    def check_kernel_shape(self) -> None:
        """Raise on what ``csrc/locate_block.cu`` does not take."""
        if self.cc_refine:
            raise NotImplementedError(
                "the locate kernel runs the Newton locator without CC "
                "refinement; cc_refine=True runs on the CPU only")
        if self.n_channels > MAX_CHANNELS or self.capacity > MAX_SLOTS \
                or len(self.tols) > MAX_TIERS:
            raise ValueError(
                f"the locate kernel takes at most {MAX_CHANNELS} channels, "
                f"{MAX_SLOTS} slots and {MAX_TIERS} feasibility tiers")
        if self.model is not None:
            fcnn_plan(self.model.model)


def locate_block_reference(lb: LocateBlock, lstate: LocatorState,
                           queue: EventQueue, on: torch.Tensor,
                           deltas: torch.Tensor, sample_count: torch.Tensor,
                           window=None, win_start=None, out=None):
    """Plain version: the JAX engine's locate loop and queue push
    (engine.py:249-304 there), every slot's state selected by the
    channel's validity, never branched on.  Returns ``(locator state,
    event queue, BlockHits, sample_count + block size)``.  ``out``: a
    ``(locator state, event queue, counter)`` to copy the new ones into
    and return (it may be the inputs)."""
    _cuda.LOCATE_BLOCK.plain_calls += 1
    dev = on.device
    c = lb.n_channels
    onsets_abs = sample_count + deltas
    extra = () if window is None else (window, win_start)
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


def locate_block(lb: LocateBlock, lstate: LocatorState, queue: EventQueue,
                 on: torch.Tensor, deltas: torch.Tensor,
                 sample_count: torch.Tensor, window=None, win_start=None,
                 out=None):
    """The block's locate step: :func:`locate_block_reference` for CPU
    tensors, ``csrc/locate_block.cu`` for CUDA tensors.  Returns
    ``(locator state, event queue, BlockHits, sample_count + block
    size)``; ``out`` as for the plain version."""
    if on.device.type == "cpu":
        return locate_block_reference(lb, lstate, queue, on, deltas,
                                      sample_count, window, win_start, out)
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
    fcnn_ptr = None
    if lb.model is not None:
        plan, packed = lb.fcnn
        if packed.device != on.device:
            raise ValueError("the packed FCNN must be on the events' device")
        d.has_model = 1
        d.n_layers = len(plan.widths) - 1
        d.act = plan.act
        d.model_input = MODEL_INPUTS[lb.model_input]
        for i, w in enumerate(plan.widths):
            d.widths[i] = w
        fcnn_ptr = packed.data_ptr()
    new_l, new_q, count = out
    hits = BlockHits(torch.empty_like(deltas),
                     torch.empty((c, 2), dtype=torch.float32,
                                 device=on.device),
                     torch.empty_like(on))
    ptrs = [v.data_ptr() for v in (
        on, deltas, count, *new_l, *lb.tables, *new_q, *hits)]
    # a launch with the learned locator counts under variant "fcnn"
    _cuda.LOCATE_BLOCK.launch("ofpt_locate_block", ctypes.addressof(d),
                              *ptrs, fcnn_ptr, _cuda.stream(),
                              variant="fcnn" if fcnn_ptr else "")
    return new_l, new_q, hits, count
