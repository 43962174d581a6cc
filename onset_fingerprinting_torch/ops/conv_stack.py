"""Fused few-feature Conv1d stack: the wrapper of kernel K3.

Port of ``onset_fingerprinting_tpu.ops.pallas_conv.conv_stack_fused``: a
chain of stride-1 ``Conv1d`` layers with the same zero ``padding`` on every
layer and bias + activation after every layer (the last included),
``x [B, L] → [B, T_out, O_last]`` float32.  On the card the whole stack is
one kernel with every layer's activations in shared memory; on the CPU it
is :func:`conv_stack_reference`, an ``F.conv1d`` chain with the kernel's
rounding points (inputs and weights in ``compute_dtype``, float32
accumulation, bias and activation in float32, activations stored in
``compute_dtype`` between layers).

Which kernel runs (:func:`kernel_for`, a shape test, no fallback):

- ``compute_dtype=bfloat16`` with ``padding <= 16`` and a plan
  (:func:`mma_plan`) whose shared memory fits one CTA of 16 signals
  (232448 bytes), for a batch that would leave the card mostly idle
  (at most ``CLUSTER_MAX_CTAS`` CTAs of 16 signals) and a cluster plan
  (:func:`cluster_plan`): ``csrc/conv_stack_mma_cluster.cu``, the same
  products with each group of 16 signals split along the time axis over
  a thread-block cluster of ``CLUSTER_CTAS`` CTAs (counter
  ``_cuda.CONV_STACK_MMA_CLUSTER``).  The realtime classifier's 48
  signals take it.  Crossover (``tools/conv_stack_split.py --cluster``,
  the flagship at L = 256 and 512, both kernels in turns, per call in a
  graph of 16 on an H100 80GB HBM3 at 700 W): the cluster kernel takes
  0.030-0.031 ms up to B = 112 (7 clusters of 16 CTAs, the most the card
  keeps resident at one CTA per SM) and twice that from B = 128 on (a
  second wave), against the tensor-core kernel's 0.047 (L = 256) and
  0.083-0.085 ms (L = 512) up to B = 2112; so up to 7 groups of 16
  signals go to the cluster kernel.
- the same stacks at a larger batch, or without ``batch``:
  ``csrc/conv_stack_mma.cu``, the tensor-core kernel (counter
  ``_cuda.CONV_STACK_MMA``), a CTA per 16 signals.  The fleet's flagship
  stack takes it.
- every other stack, and every ``float32`` stack (one bf16 or TF32
  tensor-core pass would break its 5e-4/1e-4 bound):
  ``csrc/conv_stack.cu``, the CUDA-core kernel (``_cuda.CONV_STACK``),
  one warp per signal on the schedule :func:`simt_plan` gives.  A stack
  whose two weight buffers and one signal's two activation buffers do
  not fit a CTA's shared memory (e.g. 64 features at L=4096 in float32)
  raises.

The plain version counts its calls on the kernel it stands in for (the
route of its batch);
:func:`far_signals` lists where a bf16 run parts from it by more than about
one ulp (``tools/conv_stack_gate.py`` holds those to one rounding flip).  The
packed weights are cached per weight and bias tensor (``data_ptr`` and
``_version``), so an in-place update repacks.

Weights are PyTorch ``Conv1d`` layout ``[O, I, K]``, biases ``[O]``.

Under autograd (grad enabled and an input that requires it) the stack is
an ``autograd.Function``, as ``conv_stack_fused`` is a ``jax.custom_vjp``
(pallas_conv.py:457-555 there): the forward is the routed kernel (its
plain version on the CPU) and the backward differentiates the plain chain,
recomputed from the saved inputs.  The recompute counts on the kernel's
``backward_recomputes``, not its ``plain_calls``, and runs its cuDNN
convolutions without TF32 whatever the process flags say.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from onset_fingerprinting_torch.models.fcnn import ACTIVATIONS
from onset_fingerprinting_torch.ops import _cuda

_ACTIVATIONS = dict(ACTIVATIONS, linear=lambda x: x)
#: activation codes of the kernels' ``activate``
_ACT_CODES = {"linear": 0, "relu": 1, "silu": 2, "leakyrelu": 3, "elu": 4,
              "tanh": 5, "sigmoid": 6}
MAX_LAYERS = 16
#: the largest thread-block cluster the H100 takes (non-portable)
MAX_CLUSTER = 16
#: shared memory one CTA may take on the H100 (bytes)
SMEM_LIMIT = 232448
#: tensor-core kernel: leading zero rows of every activation buffer (the
#: largest padding it takes), output positions per block (one m16 tile),
#: signals per CTA (two n8 tiles), bytes of one buffer row
ZR = 16
TB = 16
MMA_SIGNALS = 16
_ROW_BYTES = 2 * MMA_SIGNALS


#: the cluster kernel: CTAs of one thread-block cluster (8 is the portable
#: largest; 16 takes the non-portable attribute, and measured faster at the
#: classifier's shape), warps per CTA, and the most groups of 16 signals
#: (the tensor-core kernel's CTAs) it takes: one wave of its clusters, 7
#: resident on the H100 (measured crossover, module docstring)
CLUSTER_CTAS = 16
CLUSTER_WARPS = 8
CLUSTER_MAX_CTAS = 7
#: output features of one warp unit (csrc/conv_stack_mma.cu's OG_MAX)
OG_MAX = 5


#: CUDA-core kernel: output positions per lane task that a layer may take
#: (the kernel instantiates these), the most warps an SM keeps resident at
#: its 128 registers a thread, an SM's shared memory and what the card
#: reserves of it per CTA (bytes)
SIMT_TT = (5, 6, 8)
SIMT_MAX_WARPS = 16
SM_SMEM = 233472
CTA_RESERVED = 1024


class _StackDesc(ctypes.Structure):
    # must match csrc/conv_stack.cu::StackDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_layers", "B", "L", "pad", "act", "bf16", "ns", "pitch",
        "max_feat", "w_max",
    )] + [(n, ctypes.c_int * MAX_LAYERS) for n in (
        "K", "I", "O", "T_out", "TT", "OW", "n_og", "w_off", "w_len",
    )]


class _ClusterDesc(ctypes.Structure):
    # must match csrc/conv_stack_mma_cluster.cu::ClusterDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_layers", "B", "L", "act", "ctas", "in_rows", "max_feat", "win0",
        "taps_words", "bias_words",
    )] + [(n, ctypes.c_int * MAX_LAYERS) for n in (
        "I", "O", "T_out", "S", "n_pair", "fg", "tap_off", "b_off",
    )] + [("range", ctypes.c_int * (MAX_CLUSTER + 1))]


class _MmaDesc(ctypes.Structure):
    # must match csrc/conv_stack_mma.cu::MmaDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_layers", "B", "L", "act", "buf_rows", "max_feat", "in_zero_end",
        "max_taps", "win0",
    )] + [(n, ctypes.c_int * MAX_LAYERS) for n in (
        "I", "O", "T_out", "S", "n_blk", "zero_end", "tap_off", "b_off",
    )]


def stack_lengths(length: int, weights, padding: int) -> list[int]:
    """Validate that the layers chain and return each layer's output
    length."""
    if weights[0].shape[1] != 1:
        raise ValueError("first layer must take a single input feature")
    outs = []
    t = length
    prev_o = 1
    for w in weights:
        o, i, k = w.shape
        if i != prev_o:
            raise ValueError("layer feature widths do not chain")
        t = t + 2 * padding - k + 1
        if t <= 0:
            raise ValueError(f"kernel {k} longer than the padded input")
        outs.append(t)
        prev_o = o
    return outs


@dataclass(frozen=True)
class MmaLayer:
    """One layer of the tensor-core kernel's schedule."""

    in_feat: int
    out_feat: int
    t_out: int
    #: window rows per input feature: the band's width per feature
    s: int
    #: blocks of ``TB`` output positions, even: a warp task is two blocks
    #: (positions past ``t_out`` are written as zeros)
    n_blk: int
    #: the next layer's windows end here: this layer's output rows
    #: ``[ZR + n_blk * TB, zero_end)`` are zeroed after it runs
    zero_end: int


@dataclass(frozen=True)
class MmaPlan:
    """Static schedule of the tensor-core kernel.  Block ``b`` of a layer
    reads rows ``[win0 + TB * b, win0 + TB * b + s)`` of every input
    feature's buffer and writes rows ``[ZR + TB * b, ZR + TB * (b + 1))`` of
    every output feature's."""

    layers: tuple
    win0: int
    buf_rows: int
    #: the input's rows ``[ZR + L, in_zero_end)`` are zeroed
    in_zero_end: int
    #: shared memory of one CTA of ``MMA_SIGNALS`` signals (bytes)
    smem: int


def mma_plan(length: int, shapes, padding: int) -> MmaPlan | None:
    """The tensor-core kernel's schedule for ``shapes`` ``[(O, I, K), ...]``,
    or None when it cannot take the stack (``padding > ZR`` or more shared
    memory than one CTA may have).

    Every window starts at the first row it needs, ``t0 - padding``, so
    ``s = rnd(TB + K - 1, 16)`` and the band is
    ``band[o * TB + tau, i * s + j] = w[o, i, j - tau]``."""
    if padding > ZR or len(shapes) > MAX_LAYERS:
        return None
    win0 = ZR - padding
    t_in = length
    layers = []
    for o, i, k in shapes:
        t_out = t_in + 2 * padding - k + 1
        n_blk = -(-t_out // (2 * TB)) * 2
        s = -(-(TB + k - 1) // 16) * 16
        layers.append([i, o, t_out, s, n_blk, 0])
        t_in = t_out
    read_end = [win0 + TB * (lp[4] - 1) + lp[3] for lp in layers]
    for li, lp in enumerate(layers):
        lp[5] = read_end[li + 1] if li + 1 < len(layers) else 0
    layers = tuple(MmaLayer(*lp) for lp in layers)
    buf_rows = max([ZR + length] + read_end
                   + [ZR + TB * lp.n_blk for lp in layers])
    smem = (2 * max([1] + [lp.out_feat for lp in layers]) * buf_rows
            * _ROW_BYTES + 4 * max_taps(layers))
    if smem > SMEM_LIMIT:
        return None
    return MmaPlan(layers, win0, buf_rows, read_end[0], smem)


@dataclass(frozen=True)
class ClusterLayer:
    """One layer of the cluster kernel's schedule: the tensor-core kernel's
    pair tasks (two blocks of ``TB`` positions each) in contiguous runs,
    one per CTA of the cluster (each CTA's fixed range of tasks, clipped
    to the layer's), and the features a warp unit takes."""

    in_feat: int
    out_feat: int
    t_out: int
    #: window rows per input feature (:class:`MmaLayer`)
    s: int
    #: pair tasks: positions ``[32 p, 32 p + 32)`` are task ``p``
    n_pair: int
    #: CTA ``c`` runs tasks ``[runs[c][0], runs[c][1])``
    runs: tuple
    #: output features per warp unit: a unit is one task's ``fg`` features
    #: (the last unit of a task may take fewer)
    fg: int

    def reads(self, c: int, win0: int) -> tuple[int, int]:
        """Rows ``[r0, r1)`` of the input buffer (the tensor-core kernel's
        row numbers: input position ``t`` at row ``ZR + t``) that CTA
        ``c``'s tasks read; ``(r0, r0)`` where it has none."""
        p0, p1 = self.runs[c]
        r0 = win0 + 2 * TB * p0
        return (r0, r0) if p1 == p0 else (r0, r0 + 2 * TB * (p1 - p0)
                                          - TB + self.s)

    def writes(self, c: int) -> tuple[int, int]:
        """Rows ``[w0, w1)`` of the output buffer CTA ``c``'s tasks write
        (positions past ``t_out`` as zeros)."""
        p0, p1 = self.runs[c]
        return ZR + 2 * TB * p0, ZR + 2 * TB * p1

    def units(self, c: int) -> list[tuple[int, int, int]]:
        """CTA ``c``'s warp units in the order the kernel deals them to its
        warps (unit ``u`` to warp ``u % CLUSTER_WARPS``): ``(task, first
        feature, features)``."""
        return _units(self.runs[c][1] - self.runs[c][0], self.out_feat,
                      self.fg, self.runs[c][0])


@dataclass(frozen=True)
class ClusterPlan:
    """Static schedule of the cluster kernel: each group of ``MMA_SIGNALS``
    signals is one cluster of ``ctas`` CTAs.  CTA ``c`` owns the tasks
    ``ranges[c]`` of every layer (those the layer has) and keeps, per
    feature, two input buffers of ``in_rows`` rows, alternating by layer,
    whose row ``i`` is row ``base(c) + i`` of the tensor-core kernel's
    buffer: its tasks' windows (its own rows, which its epilogues write
    there, and the halo, copied from the CTAs that own it), and every
    layer's pair tables and biases, all in shared memory."""

    layers: tuple
    ctas: int
    #: CTA ``c``'s tasks in every layer: ``[ranges[c][0], ranges[c][1])``
    ranges: tuple
    win0: int
    in_rows: int
    max_feat: int
    taps_words: int
    bias_words: int
    #: clusters of the batch the plan was made for
    groups: int
    #: shared memory of one CTA (bytes), the layer table included
    smem: int

    def base(self, c: int) -> int:
        """The row of the tensor-core kernel's buffer at row 0 of CTA
        ``c``'s buffers: ``ZR - 16`` before its first position, a multiple
        of 8, so every window start (``ZR - padding`` on) lies in it."""
        return ZR - 16 + 2 * TB * self.ranges[c][0]

    def owner(self, li: int, row: int) -> int | None:
        """The CTA whose layer-``li`` tasks write output row ``row``, None
        for a row no task writes (a zero row: before ``ZR`` or past the
        last task)."""
        p = (row - ZR) // (2 * TB)
        if row < ZR or p >= self.layers[li].n_pair:
            return None
        return next(c for c, (p0, p1) in enumerate(self.ranges)
                    if p0 <= p < p1)

    def halo(self, li: int, c: int) -> list[int]:
        """The rows CTA ``c`` copies from other CTAs after layer ``li``:
        the rows its layer-``li + 1`` windows read that another CTA
        wrote."""
        r0, r1 = self.layers[li + 1].reads(c, self.win0)
        return [r for r in range(r0, r1)
                if self.owner(li, r) not in (None, c)]


def split_runs(n: int, parts: int) -> tuple:
    """``n`` tasks in ``parts`` contiguous runs, the last ``n % parts``
    one longer (so a layer with fewer tasks than the longest, clipped to
    its own, loses them from the end)."""
    base, extra = divmod(n, parts)
    bounds = [c * base + max(0, c - (parts - extra))
              for c in range(parts + 1)]
    return tuple(zip(bounds[:-1], bounds[1:]))


def _units(run: int, out_feat: int, fg: int, p0: int = 0) -> list:
    """The warp units of ``run`` tasks from task ``p0``, in the kernel's
    order: ``(task, first feature, features)``."""
    return [(p, f, min(fg, out_feat - f))
            for p in range(p0, p0 + run) for f in range(0, out_feat, fg)]


def warp_load(units) -> list[int]:
    """Products a k step issues on each warp of the CTA (unit ``u`` runs on
    warp ``u % CLUSTER_WARPS``, its units one after another): 4 per
    feature (two blocks, two n8 tiles)."""
    load = [0] * CLUSTER_WARPS
    for u, (_, _, nf) in enumerate(units):
        load[u % CLUSTER_WARPS] += 4 * nf
    return load


def _features_per_unit(out_feat: int, run: int) -> int:
    """Features per warp unit for a CTA of ``run`` tasks: the units whose
    busiest warp issues the fewest products a step (a warp issues its
    mma.sync ~35-40 SM cycles apart on the H100), then the fewer units."""
    return min(range(1, min(OG_MAX, out_feat) + 1), key=lambda fg: (
        max(warp_load(_units(run, out_feat, fg))),
        len(_units(run, out_feat, fg))))


#: ints of the cluster kernel's per-layer table (csrc/
#: conv_stack_mma_cluster.cu::Layers): I, O, T_out, S, n_pair, fg,
#: tap_off, b_off by layer, then the ranges' bounds
LAYER_TABLE = 8 * MAX_LAYERS + MAX_CLUSTER + 1


def cluster_plan(length: int, shapes, padding: int, batch: int = 1,
                 ctas: int = CLUSTER_CTAS) -> ClusterPlan | None:
    """The cluster kernel's schedule for ``shapes`` ``[(O, I, K), ...]`` over
    ``batch`` signals, or None where the tensor-core kernel has no plan
    (:func:`mma_plan`) or one CTA's buffers pass its shared memory.  The
    product of every block is the tensor-core kernel's (same window start,
    ``s``, k steps, pair table and epilogue), so the two agree bit for
    bit; only which CTA runs a task, and where its rows lie, differs.  Each
    CTA owns the same tasks in every layer (:func:`split_runs` of the
    longest layer's), so its outputs are its next windows' own rows."""
    mma = mma_plan(length, shapes, padding)
    if mma is None or not 1 <= ctas <= MAX_CLUSTER:
        return None
    ranges = split_runs(max(lp.n_blk // 2 for lp in mma.layers), ctas)
    layers = []
    for lp in mma.layers:
        n_pair = lp.n_blk // 2
        runs = tuple((min(p0, n_pair), min(p1, n_pair)) for p0, p1 in ranges)
        run = max(p1 - p0 for p0, p1 in runs)
        layers.append(ClusterLayer(lp.in_feat, lp.out_feat, lp.t_out, lp.s,
                                   n_pair, runs,
                                   _features_per_unit(lp.out_feat, run)))
    in_rows = 0
    for c, (p0, p1) in enumerate(ranges):
        base = ZR - 16 + 2 * TB * p0
        in_rows = max([in_rows, 16 + 2 * TB * (p1 - p0)]
                      + [lp.reads(c, mma.win0)[1] - base for lp in layers])
    in_rows = -(-in_rows // 8) * 8
    max_feat = max([1] + [lp.out_feat for lp in layers])
    taps_words = sum(lp.out_feat * lp.in_feat * (lp.s + 16) for lp in layers)
    bias_words = sum(lp.out_feat for lp in layers)
    smem = (max_feat * 2 * in_rows * _ROW_BYTES + 4 * taps_words
            + 16 * -(-bias_words // 4) + 4 * LAYER_TABLE)
    if smem > SMEM_LIMIT:
        return None
    return ClusterPlan(tuple(layers), ctas, ranges, mma.win0, in_rows,
                       max_feat, taps_words, bias_words,
                       -(-batch // MMA_SIGNALS), smem)


def max_taps(layers) -> int:
    """32-bit words of the largest layer's pair table (``pack_taps``)."""
    return max(lp.out_feat * lp.in_feat * (lp.s + 16) for lp in layers)


def issued_flops(plan: MmaPlan, batch: int) -> int:
    """FLOPs the tensor-core kernel issues for ``batch`` signals: every
    block is the full ``[O * TB, I * s]`` band times its window."""
    return batch * sum(2 * lp.out_feat * TB * lp.in_feat * lp.s * lp.n_blk
                       for lp in plan.layers)


@dataclass(frozen=True)
class SimtLayer:
    """One layer of the CUDA-core kernel's schedule.  A lane task is
    ``tt`` consecutive output positions of one group of ``ow`` output
    features; the layer's ``n_chunks * n_og`` tasks go round the 32 lanes
    of the signal's warp (:func:`simt_tasks`)."""

    in_feat: int
    out_feat: int
    k: int
    t_out: int
    tt: int
    #: features per group (``out_feat`` split into ``n_og`` equal groups;
    #: the last may hold padded features, whose weights are zeros)
    ow: int
    n_og: int
    #: floats per packed weight row: 4 or 8, so a tap's weights are one or
    #: two 16-byte broadcast loads
    owp: int
    #: offset and length (floats) of the layer's packed block: weights
    #: ``[n_og, I, K, owp]`` then biases ``[n_og, owp]``
    w_off: int
    w_len: int

    @property
    def n_chunks(self) -> int:
        return -(-self.t_out // self.tt)

    @property
    def rows_read(self) -> int:
        """Buffer rows the layer's tasks read: the last chunk's window
        runs one row past its last tap (the kernel loads a tap block's
        ``tt`` rows ahead)."""
        return self.n_chunks * self.tt + self.k


@dataclass(frozen=True)
class SimtPlan:
    """Static schedule of the CUDA-core kernel: one warp per signal, ``ns``
    signals (warps) per CTA, every layer's activations in two per-signal
    buffers of ``max_feat`` features of ``pitch`` elements (row ``r`` of a
    feature at :func:`skew` ``(r)``), the layers' packed weights staged into
    two alternating buffers of ``w_max`` floats."""

    layers: tuple
    ns: int
    buf_rows: int
    pitch: int
    max_feat: int
    w_max: int
    #: shared memory of one CTA (bytes)
    smem: int
    ctas_per_sm: int

    @property
    def threads(self) -> int:
        return 32 * self.ns

    @property
    def resident_warps(self) -> int:
        return self.ctas_per_sm * self.ns


def skew(r: int) -> int:
    """Where buffer row ``r`` lies: one spare word after every 32 rows, so
    the lanes of a warp, ``tt`` rows apart, meet at most two to a bank."""
    return r + (r >> 5)


def _task_cost(i: int, k: int, ow: int, tt: int, tasks: int) -> int:
    """Issue slots of one lane for a layer (the plan's model): per input
    feature and tap ``tt * ow`` FMAs, one activation load and the weight
    loads, a register move per tap and ``tt - 1`` more per tail tap; ten
    per output for bias, activation and store; rounds of 32 tasks."""
    per = (i * (k * (tt * ow + 2 + -(-ow // 4)) + (k % tt) * (tt - 1))
           + 10 * tt * ow)
    return -(-tasks // 32) * per


def simt_plan(length: int, shapes, padding: int,
              elem_bytes: int = 4) -> SimtPlan:
    """The CUDA-core kernel's schedule for ``shapes`` ``[(O, I, K), ...]``
    with activations of ``elem_bytes`` (4 float32, 2 bfloat16).  Raises
    ValueError when one signal's buffers and the weight buffers do not fit
    a CTA's shared memory.

    Each layer takes the ``tt`` of :data:`SIMT_TT` that costs its lanes
    the fewest issue slots (:func:`_task_cost`).  ``ns`` is the number of
    signals per CTA, among 8, 4, 16, 2, 1 (in that order of preference),
    that keeps the most warps resident per SM: CTAs per SM are bounded by
    the SM's shared memory and by :data:`SIMT_MAX_WARPS`."""
    if len(shapes) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers")
    layers, off = [], 0
    rows = length + 2 * padding
    t_in = length
    for o, i, k in shapes:
        t_out = t_in + 2 * padding - k + 1
        n_og = -(-o // 8)
        ow = -(-o // n_og)
        owp = 4 if ow <= 4 else 8
        tt = min(SIMT_TT, key=lambda tt: _task_cost(
            i, k, ow, tt, -(-t_out // tt) * n_og))
        w_len = n_og * (i * k + 1) * owp
        lp = SimtLayer(i, o, k, t_out, tt, ow, n_og, owp, off, w_len)
        layers.append(lp)
        off += w_len
        rows = max(rows, t_out + 2 * padding, lp.rows_read)
        t_in = t_out
    pitch = -(-(skew(rows - 1) + 1) // 8) * 8
    max_feat = max([1] + [o for o, _, _ in shapes])
    w_max = max(lp.w_len for lp in layers)
    fixed = 2 * w_max * 4
    per_signal = 2 * max_feat * pitch * elem_bytes
    best = None
    for ns in (8, 4, 16, 2, 1):
        smem = fixed + ns * per_signal
        if smem > SMEM_LIMIT:
            continue
        ctas = min(SM_SMEM // (smem + CTA_RESERVED), SIMT_MAX_WARPS // ns)
        if ctas and (best is None or ctas * ns > best[2] * best[0]):
            best = (ns, smem, ctas)
    if best is None:
        raise ValueError(
            f"conv stack too large for the CUDA-core kernel: one signal "
            f"needs {fixed + per_signal} bytes of shared memory "
            f"(limit {SMEM_LIMIT})")
    ns, smem, ctas = best
    return SimtPlan(tuple(layers), ns, rows, pitch, max_feat, w_max, smem,
                    ctas)


def simt_tasks(lp: SimtLayer) -> list[list[tuple[int, int]]]:
    """Each lane's tasks in a layer, as the kernel walks them: lane ``l``
    takes tasks ``l, l + 32, ...``; task ``u`` is feature group
    ``u // n_chunks`` at positions from ``(u % n_chunks) * tt``."""
    n = lp.n_chunks * lp.n_og
    return [[(u // lp.n_chunks, u % lp.n_chunks * lp.tt)
             for u in range(lane, n, 32)] for lane in range(32)]


def kernel_for(length: int, weights, padding: int,
               compute_dtype: torch.dtype,
               batch: int | None = None) -> _cuda.Kernel:
    """The kernel that runs this stack over ``batch`` signals on the card:
    for a bfloat16 stack with a tensor-core plan, the cluster kernel where
    ``batch`` is given and its tensor-core CTAs would leave the card mostly
    idle (at most ``CLUSTER_MAX_CTAS``), else the tensor-core kernel; the
    CUDA-core kernel for every other stack."""
    shapes = [tuple(w.shape) for w in weights]
    if compute_dtype != torch.bfloat16 or mma_plan(
            length, shapes, padding) is None:
        return _cuda.CONV_STACK
    if batch is not None and -(-batch // MMA_SIGNALS) <= CLUSTER_MAX_CTAS \
            and cluster_plan(length, shapes, padding, batch) is not None:
        return _cuda.CONV_STACK_MMA_CLUSTER
    return _cuda.CONV_STACK_MMA


def conv_stack_reference(x, weights, biases, padding=1, activation="silu",
                         compute_dtype=torch.bfloat16):
    """Plain version of K3: an ``F.conv1d`` + activation chain with the
    kernel's rounding points.  ``[B, L] → [B, T_out, O_last]`` float32."""
    kernel_for(x.shape[1], weights, padding, compute_dtype,
               x.shape[0]).plain_calls += 1
    return _chain(x, weights, biases, padding, activation, compute_dtype)


def _chain(x, weights, biases, padding, activation, compute_dtype):
    """:func:`conv_stack_reference` without its count."""
    act = _ACTIVATIONS[activation]
    y = x.to(compute_dtype).to(torch.float32)[:, None, :]
    for w, b in zip(weights, biases):
        y = F.conv1d(y, w.to(compute_dtype).to(torch.float32),
                     padding=padding)
        y = act(y + b.to(torch.float32)[None, :, None])
        y = y.to(compute_dtype).to(torch.float32)
    return y.transpose(1, 2).contiguous()


def far_values(out: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """The values of ``out`` more than about one bf16 ulp
    (``1e-3 + 4e-3 * |plain|``) from the plain version's."""
    return (out - plain).abs() > 1e-3 + 4e-3 * plain.abs()


def far_signals(out: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """Indices of the signals (rows of ``[B, T, O]``) with any
    :func:`far_values`.

    A bf16 stack and its plain version share every rounding point, so they
    part only where an f32 sum taken in another order falls on the other
    side of a bf16 rounding boundary; the flipped activation then moves the
    later layers of that one signal, often by several ulps."""
    return far_values(out, plain).flatten(1).any(1).nonzero().flatten()


def _pack(weights, biases, compute_dtype, plan: SimtPlan):
    """CUDA-core kernel: each layer's weights rounded to ``compute_dtype``
    as ``[n_og, I, K, owp]`` float32 (output features padded to ``n_og *
    ow`` and each group to ``owp`` with zeros), then its biases as
    ``[n_og, owp]`` float32, all layers flat."""
    parts = []
    for w, b, lp in zip(weights, biases, plan.layers):
        o, i, k = w.shape
        wr = w.detach().to(compute_dtype).to(torch.float32)
        wr = F.pad(wr, (0, 0, 0, 0, 0, lp.n_og * lp.ow - o))
        wr = wr.reshape(lp.n_og, lp.ow, i, k).permute(0, 2, 3, 1)
        wr = F.pad(wr, (0, lp.owp - lp.ow))
        br = F.pad(b.detach().to(torch.float32), (0, lp.n_og * lp.ow - o))
        br = F.pad(br.reshape(lp.n_og, lp.ow), (0, lp.owp - lp.ow))
        parts += [wr.reshape(-1), br.reshape(-1)]
    return torch.cat(parts).contiguous()


def pack_taps(w: torch.Tensor, s: int) -> torch.Tensor:
    """Tensor-core kernel: the pair table of one layer's band, ``[O, I,
    s + 16]`` int32.  Word ``j`` holds the bfloat16 pair ``(w[j - 15],
    w[j - 14])`` (zero outside ``[0, K)``), the first in the low half: the
    band is Toeplitz, ``band[tau, j'] = w[j' - tau]``, so register ``r`` of
    an m16n8k16 A fragment is the pair at ``j = kc + 2 * (lane % 4) -
    lane // 4 + 15`` plus ``(0, -8, +8, 0)[r]`` (``csrc/conv_stack_mma.cu``
    ``mma_task``)."""
    o, i, k = w.shape
    tw = s + 16
    wz = torch.zeros((o, i, tw + 1), dtype=torch.bfloat16, device=w.device)
    wz[:, :, 15:15 + k] = w.detach().to(torch.bfloat16)
    pairs = torch.stack([wz[:, :, :tw], wz[:, :, 1:]], dim=-1)
    return pairs.view(torch.int32)[..., 0]


def _pack_mma(weights, biases, plan: MmaPlan):
    """Tensor-core kernel: every layer's pair table and bias, flat, with
    their offsets."""
    taps = [pack_taps(w, lp.s).reshape(-1)
            for w, lp in zip(weights, plan.layers)]
    bs = [b.detach().to(torch.float32).reshape(-1) for b in biases]
    return (torch.cat(taps).contiguous(), torch.cat(bs).contiguous(),
            _offsets(taps), _offsets(bs))


def _offsets(parts) -> list[int]:
    return [0, *itertools.accumulate(p.numel() for p in parts)][:-1]


#: packed weights by (kernel, dtype, each tensor's device, pointer, version,
#: shape and dtype);
#: an entry keeps its tensors alive, so no other tensor takes their memory
_PACKED: dict = {}
_PACKED_MAX = 8


def packed_weights(kernel, weights, biases, compute_dtype, pack):
    """``pack()`` for these weights, from the cache unless a tensor changed
    (an in-place update bumps its ``_version``).  Inference tensors keep no
    version counter and are packed on every call."""
    tensors = (*weights, *biases)
    if any(t.is_inference() for t in tensors):
        return pack()
    key = (kernel.name, compute_dtype) + tuple(
        (t.device, t.data_ptr(), t._version, tuple(t.shape), t.dtype)
        for t in tensors)
    hit = _PACKED.get(key)
    if hit is None:
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.clear()
        hit = _PACKED[key] = (tensors, pack())
    return hit[1]


def conv_stack(x: torch.Tensor, weights, biases, padding: int = 1,
               activation: str = "silu",
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the whole stride-1 conv stack ``x [B, L] → [B, T_out, O_last]``
    float32: the kernel :func:`kernel_for` names for a CUDA tensor,
    :func:`conv_stack_reference` for a CPU tensor.  Differentiable
    (module docstring)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if x.dim() != 2:
        raise ValueError("x must be [B, L]")
    t_outs = stack_lengths(x.shape[1], weights, padding)
    if x.device.type != "cpu":
        if len(weights) > MAX_LAYERS:
            raise ValueError(f"at most {MAX_LAYERS} layers")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("x must be a contiguous float32 [B, L] tensor")
        if any(v.device != x.device for v in (*weights, *biases)):
            raise ValueError("weights, biases and x must be on one device")
    if torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, *weights, *biases)
    ):
        return _ConvStack.apply(x, padding, activation, compute_dtype,
                                len(weights), *weights, *biases)
    return _forward(x, weights, biases, padding, activation, compute_dtype,
                    t_outs[-1])


class _ConvStack(torch.autograd.Function):
    """K3 forward, backward by autograd of the plain chain (pallas_conv.py
    ``_fused_fwd``/``_fused_bwd`` in the JAX package)."""

    @staticmethod
    def forward(ctx, x, padding, activation, compute_dtype, n, *params):
        weights, biases = params[:n], params[n:]
        ctx.save_for_backward(x, *params)
        ctx.config = (padding, activation, compute_dtype, n)
        t_out = stack_lengths(x.shape[1], weights, padding)[-1]
        return _forward(x, weights, biases, padding, activation,
                        compute_dtype, t_out)

    @staticmethod
    def backward(ctx, g):
        padding, activation, compute_dtype, n = ctx.config
        saved = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], *ctx.needs_input_grad[5:])
        inputs = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
        x, params = inputs[0], inputs[1:]
        kernel_for(x.shape[1], params[:n], padding, compute_dtype,
                   x.shape[0]).backward_recomputes += 1
        with torch.enable_grad(), exact_f32():
            out = _chain(x, params[:n], params[n:], padding, activation,
                         compute_dtype)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        got = [next(grads) if t.requires_grad else None for t in inputs]
        return (got[0], None, None, None, None, *got[1:])


def exact_f32():
    """cuDNN without TF32 for the block it guards, the other cuDNN flags as
    they are (a context manager)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@contextlib.contextmanager
def exact_f32_matmul():
    """float32 matrix products in full float32 for the block it guards,
    whatever the process set (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32`` or the per-backend
    ``fp32_precision``): the float32 matmul precision ``"highest"`` and
    cuBLAS without TF32 (a context manager).  The settings it found are
    back on exit; where they already hold it changes nothing."""
    mm = torch.backends.cuda.matmul
    try:
        prec = torch.get_float32_matmul_precision()
    except RuntimeError:  # the process set the backends apart
        prec = None
    if prec == "highest":
        yield
        return
    if prec is not None:
        # the process-wide setter also sets the CPU's matmul backend, whose
        # own setting is put back after it
        cpu_mm = getattr(torch.backends.mkldnn, "matmul", None)
        cpu = cpu_mm.fp32_precision if cpu_mm is not None else None
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prec)
            if cpu is not None:
                cpu_mm.fp32_precision = cpu
        return
    try:
        allow = mm.allow_tf32
    except RuntimeError:  # cuBLAS's old and new settings disagree
        allow = None
    if allow is False:
        yield
    elif allow:
        mm.allow_tf32 = False
        try:
            yield
        finally:
            mm.allow_tf32 = True
    else:
        was = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = was


def _forward(x, weights, biases, padding, activation, compute_dtype, t_out):
    """The stack's forward with no autograd: the plain version on the CPU,
    else the routed kernel."""
    if x.device.type == "cpu":
        return conv_stack_reference(x, weights, biases, padding, activation,
                                    compute_dtype)
    bsz, length = x.shape
    out = torch.empty((bsz, t_out, weights[-1].shape[0]),
                      dtype=torch.float32, device=x.device)
    kernel = kernel_for(length, weights, padding, compute_dtype, bsz)
    if kernel is _cuda.CONV_STACK_MMA:
        return _launch_mma(kernel, x, weights, biases, padding, activation,
                           out)
    if kernel is _cuda.CONV_STACK_MMA_CLUSTER:
        return _launch_cluster(kernel, x, weights, biases, padding,
                               activation, out)
    plan = simt_plan(length, [tuple(w.shape) for w in weights], padding,
                     compute_dtype.itemsize)
    w_flat = packed_weights(kernel, weights, biases, compute_dtype,
                            lambda: _pack(weights, biases, compute_dtype,
                                          plan))
    d = _simt_desc(plan, bsz, length, padding, activation, compute_dtype)
    kernel.launch(
        "ofpt_conv_stack", ctypes.addressof(d), x.data_ptr(),
        w_flat.data_ptr(), out.data_ptr(), _cuda.stream(),
    )
    return out


def _simt_desc(plan: SimtPlan, bsz: int, length: int, padding: int,
               activation: str, compute_dtype: torch.dtype) -> _StackDesc:
    d = _StackDesc(
        n_layers=len(plan.layers), B=bsz, L=length, pad=padding,
        act=_ACT_CODES[activation], bf16=int(compute_dtype == torch.bfloat16),
        ns=plan.ns, pitch=plan.pitch, max_feat=plan.max_feat,
        w_max=plan.w_max,
    )
    for li, lp in enumerate(plan.layers):
        d.O[li], d.I[li], d.K[li] = lp.out_feat, lp.in_feat, lp.k
        d.T_out[li], d.TT[li], d.OW[li], d.n_og[li] = (lp.t_out, lp.tt,
                                                      lp.ow, lp.n_og)
        d.w_off[li], d.w_len[li] = lp.w_off, lp.w_len
    return d


def simt_occupancy(length: int, shapes, padding: int,
                   compute_dtype: torch.dtype) -> int:
    """CTAs of :func:`simt_plan`'s schedule that the card keeps resident
    per SM (the CUDA occupancy query; no launch), to hold the plan's
    ``ctas_per_sm`` to."""
    plan = simt_plan(length, shapes, padding, compute_dtype.itemsize)
    d = _simt_desc(plan, 1, length, padding, "silu", compute_dtype)
    kernel = _cuda.CONV_STACK
    if kernel._lib is None:
        _cuda.build([kernel])
    ctas = ctypes.c_int(0)
    rc = kernel._lib.ofpt_conv_stack_occupancy(ctypes.addressof(d),
                                               ctypes.addressof(ctas))
    if rc != 0:
        raise RuntimeError(f"conv_stack occupancy query: CUDA error {rc}")
    return ctas.value


def _launch_mma(kernel, x, weights, biases, padding, activation, out):
    """Launch a build of ``csrc/conv_stack_mma.cu`` (``kernel``) on ``x`` into
    ``out``; the caller has checked the stack and its plan."""
    length = x.shape[1]
    plan = mma_plan(length, [tuple(w.shape) for w in weights], padding)
    d = _mma_desc(plan, x.shape[0], length, activation)
    taps, b_flat, tap_off, b_off = packed_weights(
        kernel, weights, biases, torch.bfloat16,
        lambda: _pack_mma(weights, biases, plan))
    for li in range(len(weights)):
        d.tap_off[li] = tap_off[li]
        d.b_off[li] = b_off[li]
    kernel.launch(
        "ofpt_conv_stack_mma", ctypes.addressof(d), x.data_ptr(),
        taps.data_ptr(), b_flat.data_ptr(), out.data_ptr(), _cuda.stream(),
    )
    return out


def _mma_desc(plan: MmaPlan, bsz: int, length: int,
              activation: str) -> _MmaDesc:
    lay = plan.layers
    d = _MmaDesc(
        n_layers=len(lay), B=bsz, L=length, act=_ACT_CODES[activation],
        buf_rows=plan.buf_rows,
        max_feat=max([1] + [lp.out_feat for lp in lay]),
        in_zero_end=plan.in_zero_end, max_taps=max_taps(lay), win0=plan.win0,
    )
    for li, lp in enumerate(lay):
        d.I[li], d.O[li], d.T_out[li] = lp.in_feat, lp.out_feat, lp.t_out
        d.S[li], d.n_blk[li], d.zero_end[li] = lp.s, lp.n_blk, lp.zero_end
    return d


def _launch_cluster(kernel, x, weights, biases, padding, activation, out,
                    ctas: int = CLUSTER_CTAS):
    """Launch a build of ``csrc/conv_stack_mma_cluster.cu`` (``kernel``) on
    ``x`` into ``out``; the caller has checked the stack and its plan.  The
    pair tables and biases are the tensor-core kernel's (one cache entry
    for both)."""
    bsz, length = x.shape
    shapes = [tuple(w.shape) for w in weights]
    plan = cluster_plan(length, shapes, padding, bsz, ctas)
    if plan is None:
        raise ValueError(f"no cluster plan of {ctas} CTAs for this stack")
    d = cluster_desc(plan, bsz, length, activation)
    taps, b_flat, tap_off, b_off = packed_weights(
        _cuda.CONV_STACK_MMA, weights, biases, torch.bfloat16,
        lambda: _pack_mma(weights, biases, mma_plan(length, shapes,
                                                    padding)))
    for li in range(len(weights)):
        d.tap_off[li] = tap_off[li]
        d.b_off[li] = b_off[li]
    kernel.launch(
        "ofpt_conv_stack_mma_cluster", ctypes.addressof(d), x.data_ptr(),
        taps.data_ptr(), b_flat.data_ptr(), out.data_ptr(), _cuda.stream(),
    )
    return out


def cluster_desc(plan: ClusterPlan, bsz: int, length: int,
                 activation: str) -> _ClusterDesc:
    """The cluster kernel's descriptor of ``plan`` (the weights' offsets
    are the caller's to set)."""
    lay = plan.layers
    d = _ClusterDesc(
        n_layers=len(lay), B=bsz, L=length, act=_ACT_CODES[activation],
        ctas=plan.ctas, in_rows=plan.in_rows, max_feat=plan.max_feat,
        win0=plan.win0, taps_words=plan.taps_words,
        bias_words=plan.bias_words,
    )
    for li, lp in enumerate(lay):
        d.I[li], d.O[li], d.T_out[li] = lp.in_feat, lp.out_feat, lp.t_out
        d.S[li], d.n_pair[li], d.fg[li] = lp.s, lp.n_pair, lp.fg
    for c, (p0, _) in enumerate(plan.ranges):
        d.range[c] = p0
    d.range[plan.ctas] = plan.ranges[-1][1]
    return d
