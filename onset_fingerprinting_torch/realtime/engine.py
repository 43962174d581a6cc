"""The realtime engine: detect → locate → event queue per 128-sample block
on the card, and an on-card classifier reading the device audio ring (port
of ``onset_fingerprinting_tpu.realtime.engine``).

The JAX engine runs one jitted program per block.  Here the step is a
fixed-capacity, branch-free PyTorch function

    step(EngineState, block [B, C], params) -> (EngineState, BlockEvents)

with static shapes, no host read and no Python branch on a device value,
so that it can be captured once in a ``torch.cuda.CUDAGraph`` and replayed
per block: the replay is the counterpart of the single program.  Two
kernels carry it on the card: the detector K1 (``ops/fused_detector``; the
engine's config couples the channels' off-gate at 3 channels, so
``csrc/detector_warp.cu``) and the ring write with the locate step
(``ops/locate_block``, ``csrc/locate_block.cu``: the block to the audio
ring, the locator's masked slot table, the event-queue push and the sample
counter in one launch, as the JAX step writes its ring and locates in one
program).  The step runs in place (``out=`` the state it was given), so
the captured graph is those two kernels and no copies.

:class:`RealtimeEngine` is the host shim: the per-block call, the device
event queue drained by :meth:`~RealtimeEngine.harvest` with one packed
read, the pipelined dispatcher and harvester threads, and the classifier.
On the card it replays the captured step; with ``device="cpu"`` it runs
the step eagerly and every kernel runs its plain version.

The learned locator (``model=FCNNBundle``) and the CC refinement
(``cc_refine=True``) run inside the locate kernel (``ops/locate_block``),
which reads the refinement's live window straight from the audio ring.  The analysis side channel (:meth:`~RealtimeEngine.
attach_analysis`, ``realtime/analysis.OnlineAnalysis``) and the recording
commands read the host audio ring the engine writes; :meth:`~
RealtimeEngine.stream` opens a PortAudio stream where sounddevice exists.

The captured step is replayed on the stream that was current when the
engine was built (``_GraphedStep.stream``), whichever thread calls it (the
native executor's callback, the pipelined dispatcher), and every host read
of the engine's state goes through that stream too.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.ring_buffer import (
    CircularArray,
    RingBuffer,
    ring_init,
)
from onset_fingerprinting_torch.core.tree import write_into
from onset_fingerprinting_torch.detect.amplitude import (
    DetectorParams,
    DetectorState,
    detector_init,
)
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate.multilaterate import (
    LocatorState,
    Multilaterate3D,
    locator_init,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.fused_detector import (
    detector_static,
    fused_detect_offline,
    fused_warmup_minmax,
)
from onset_fingerprinting_torch.ops.locate_block import (
    EventQueue,
    LocateBlock,
    locate_block,
)
from onset_fingerprinting_torch.realtime.actions import Actions, Location


def _pack_events(ev_count, ev_points, ev_onsets, ev_emits) -> torch.Tensor:
    """(count, points, onsets, emit stamps) as one int32 vector, so that a
    harvest is a single device → host read.  The float32 points are
    bitcast into it: a float cast would lose integer exactness past 2^24
    hits (and int32 onsets past ~175 s at 96 kHz)."""
    return torch.cat([
        ev_count.reshape(1),
        ev_points.reshape(-1).contiguous().view(torch.int32),
        ev_onsets,
        ev_emits,
    ])


class EngineState(NamedTuple):
    detector: DetectorState
    locator: LocatorState
    ring: RingBuffer
    sample_count: torch.Tensor  # 0-d int32 absolute sample counter
    # the device queue of located hits, harvested every N blocks with one
    # read instead of a read per block
    ev_points: torch.Tensor  # [E, 2] float32
    ev_onsets: torch.Tensor  # [E] int32 absolute onset sample
    # block-start sample of the block whose step emitted the hit: the
    # per-hit latency anchor (audio.py:81-120 of the reference)
    ev_emits: torch.Tensor   # [E] int32
    ev_count: torch.Tensor   # 0-d int32 cumulative hit counter


class BlockEvents(NamedTuple):
    """A block's fixed-capacity outputs (at most one onset and one
    completed hit per channel per block)."""

    on: torch.Tensor      # [C] bool: the channel fired this block
    onsets: torch.Tensor  # [C] int32 absolute onset sample (valid where on)
    points: torch.Tensor  # [C, 2] float32 located hits (valid where emits)
    emits: torch.Tensor   # [C] bool: a hit completed at this event


def make_classify_fn(model: torch.nn.Module, window: int = 256,
                     pre: int = 64, capacity: int = 16, device=None):
    """The on-device hit classifier over the engine's audio ring: for up
    to ``capacity`` located hits, the onset windows are gathered from the
    ring on the card and go through ``model`` (moved to ``device``, None =
    the card) in one call.

    Returns ``classify(ring, onsets [capacity] int32, valid [capacity]
    bool) -> (preds [capacity, out], fresh [capacity] bool)``.  ``preds``
    is zero where not valid or not fresh; ``fresh`` is False where the
    window's start was already overwritten in the ring (the classifier
    fell behind by more than the ring holds): such a hit is never
    classified from the wrong audio.  An onset within ``window - pre``
    samples of the write head has its window shifted back to end at the
    head.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    steps = torch.arange(window, dtype=torch.int32, device=dev)

    def classify(ring: RingBuffer, onsets: torch.Tensor,
                 valid: torch.Tensor):
        cap = ring.capacity
        if window > cap:
            raise ValueError(f"classify window ({window}) exceeds ring "
                             f"capacity ({cap}); allocate a longer ring")
        start = onsets - pre
        # clamp into the ring's live history; stale is judged against the
        # unclamped retention bound (an early onset, start < 0, is fresh)
        lo = torch.clamp(ring.counter - cap, min=0)
        hi = torch.clamp(ring.counter - window, min=0)
        fresh = valid & (start >= ring.counter - cap)
        start = torch.minimum(torch.maximum(start, lo), hi)
        idx = torch.remainder(start[:, None] + steps[None, :], cap).long()
        wins = ring.data[idx].transpose(1, 2)  # [K, C, W]
        with torch.inference_mode():
            preds = model(wins.contiguous())
        return torch.where(fresh[:, None], preds, 0.0), fresh

    return classify


def make_engine_step(cfg: DetectorConfig, locator: Multilaterate3D,
                     ring_seconds: float = 2.0, capacity: int = 8,
                     event_queue: int = 64, cc_refine: bool = False,
                     model=None, model_input: str = "arrival", device=None):
    """``(initial EngineState, params, step)`` on ``device`` (None = the
    card).  The locator's lag maps and geometry are tensors there.
    ``model`` (an ``FCNNBundle``) replaces the Newton solve with the FCNN
    inside the locate kernel (JAX engine.py:168-215); ``model_input`` as
    ``locate.make_locate_update``.  ``cc_refine=True`` refines each fired
    onset by cross-correlation over the live window of the audio ring
    (multilateration.py:457-501), inside the locate kernel on the card.
    ``step`` works in place: it writes the new state into the one it is
    given and returns that state's tensors."""
    dev = resolve_device(device)
    static, params, dstate = detector_init(cfg, dev)
    fstatic = detector_static(static, params)
    lb = LocateBlock(locator, cfg.n_channels, cfg.block_size,
                     capacity=capacity, cc_refine=cc_refine, model=model,
                     model_input=model_input, device=dev)
    if dev.type == "cuda":
        lb.check_kernel_shape()
    i32 = dict(dtype=torch.int32, device=dev)
    state0 = EngineState(
        detector=dstate,
        locator=locator_init(capacity, dev),
        ring=ring_init(int(ring_seconds * cfg.sr), (cfg.n_channels,),
                       device=dev),
        sample_count=torch.zeros((), **i32),
        ev_points=torch.zeros((event_queue, 2), dtype=torch.float32,
                              device=dev),
        ev_onsets=torch.zeros((event_queue,), **i32),
        ev_emits=torch.zeros((event_queue,), **i32),
        ev_count=torch.zeros((), **i32),
    )

    def step(state: EngineState, block: torch.Tensor,
             params_: DetectorParams) -> tuple[EngineState, BlockEvents]:
        queue = EventQueue(state.ev_points, state.ev_onsets, state.ev_emits,
                           state.ev_count)
        dstate, (on, deltas, _) = fused_detect_offline(
            fstatic, params_, state.detector, block, emit_rel=False,
            out=state.detector)
        on, deltas = on[0], deltas[0]
        # the block goes to the audio ring first, in the same launch; the
        # refinement reads its window of live audio ending now from the
        # ring itself (multilateration.py:457-501)
        lstate, queue, hits, count = locate_block(
            lb, state.locator, queue, on, deltas, state.sample_count,
            state.ring, out=(state.locator, queue, state.sample_count),
            block=block)
        new_state = EngineState(
            detector=dstate, locator=lstate, ring=state.ring,
            sample_count=count,
            ev_points=queue.points, ev_onsets=queue.onsets,
            ev_emits=queue.emits, ev_count=queue.count)
        return new_state, BlockEvents(on, hits.onsets, hits.points,
                                      hits.emits)

    return state0, params, step


class _GraphedStep:
    """The engine step captured once in a CUDA graph over static state
    tensors: each replay runs the step and copies each new state tensor
    that is not the static one into it (none, for the in-place step).
    Launches of the kernels the capture recorded are added to their
    counters on every replay (capturing launches nothing).  The graph is
    kept (``keep_graph``) so that a measurement can read its nodes
    (``tools/step_bench.graph_nodes``).  ``stream`` is the stream current
    at construction: every replay runs on it, from whatever thread."""

    def __init__(self, step, state: EngineState, params: DetectorParams,
                 block_shape):
        self.state = state
        self.stream = torch.cuda.current_stream()
        self.block = torch.zeros(block_shape, dtype=torch.float32,
                                 device=state.sample_count.device)
        # first call outside the capture, on a copy: builds the kernels
        # and the libraries' lazy state without touching the real state
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scratch = EngineState(*_clone(state))
            step(scratch, self.block, params)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        del scratch
        before = {k: k.launches for k in _cuda.KERNELS}
        variants = {k: collections.Counter(k.variants) for k in _cuda.KERNELS}
        plain = {k: k.plain_calls for k in _cuda.KERNELS}
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            new, self.events = step(state, self.block, params)
            write_into(state, new)
        self.graph.instantiate()
        self.launches = {k: k.launches - before[k] for k in _cuda.KERNELS
                         if k.launches != before[k]}
        self.variants = {k: k.variants - variants[k] for k in _cuda.KERNELS}
        for k in _cuda.KERNELS:
            if k.plain_calls != plain[k]:
                raise RuntimeError(f"the captured step ran plain {k.name}")
            k.launches = before[k]
            k.variants = variants[k]

    def replay(self, block) -> None:
        with torch.cuda.stream(self.stream):
            self.block.copy_(block, non_blocking=True)
            self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n
            k.variants.update(self.variants[k])


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(sub) for sub in tree))


class RealtimeEngine:
    """Host shim around the per-block device step.

    Pull model, like the PortAudio callback::

        eng = RealtimeEngine(cfg, locator, actions=Actions(), fx=[...])
        out, locs = eng.process(block)   # every block_size samples

    or, without a host read per block, :meth:`process_nosync` (or the
    pipelined dispatcher) and :meth:`harvest` every N blocks.  Located
    hits are :class:`Location` objects (cm, drum-centric), dispatched to
    the actions scheduler and FX chain as the reference's callback does
    (audio.py:81-121).

    On the card (``device=None``) the step is replayed from a CUDA graph;
    ``device="cpu"`` runs it eagerly with the kernels' plain versions.
    ``cc_refine`` as :func:`make_engine_step`.  ``metrics`` is any object
    with the
    ``observe``, ``observe_deadline`` and ``count`` methods of the JAX
    package's ``utils.metrics.Metrics``.
    """

    def __init__(self, cfg: DetectorConfig, locator: Multilaterate3D,
                 actions: Optional[Actions] = None, fx: list = (),
                 ring_seconds: float = 2.0, monitor_channels: int = 2,
                 host_ring: Optional[CircularArray] = None, metrics=None,
                 model=None, model_input: str = "arrival",
                 event_queue: int = 64, cc_refine: bool = False,
                 device=None):
        self.cfg = cfg
        self.locator = locator
        self.actions = actions or Actions()
        self.fx = list(fx)
        self.monitor_channels = monitor_channels
        self.device = resolve_device(device)
        state, self.params, self._step = make_engine_step(
            cfg, locator, ring_seconds, model=model, model_input=model_input,
            event_queue=event_queue, cc_refine=cc_refine, device=self.device)
        self._graph = None
        self._state = state
        if self.device.type == "cuda":
            self._graph = _GraphedStep(self._step, state, self.params,
                                       (cfg.block_size, cfg.n_channels))
        self._events = None
        self.host_ring = host_ring
        self.current_index = 0
        self.callback_time: Optional[tuple[float, int]] = None
        self.metrics = metrics
        self._harvested = 0  # events already drained from the device queue
        #: events overwritten in the device queue before a harvest saw them
        self.harvest_drops = 0
        #: hits whose ring audio was overwritten before classify_hits ran
        self.classify_stale = 0
        #: the fresh mask of the last classify_hits call
        self.last_classify_fresh = np.zeros((0,), bool)
        # per-block enqueue stamps for the onset → host latency histogram:
        # slot (block_start // block_size) % N holds (block_start, enqueue
        # time), written by process_pipelined, read at harvest (~11 s of
        # blocks at 96 kHz / 128)
        self._stamp_n = 8192
        self._stamp_t = np.zeros(self._stamp_n, np.float64)
        self._stamp_idx = np.full(self._stamp_n, -1, np.int64)
        self._enq_index = 0
        #: per-hit onset → host latencies (ms), one per harvested event
        self.hit_latencies_ms: list[float] = []
        self._pipe_q = None
        self._harvester = None
        #: analysis side channel (attach_analysis); None until attached
        self.analysis = None
        self.recording_active = False
        #: completed recordings: (start, end, bpm) tuples
        self.recordings: list[tuple[int, int, Optional[float]]] = []

    def _on_stream(self):
        """The context of every device call and read: the captured step's
        stream on the card (see the module docstring)."""
        if self._graph is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._graph.stream)

    @property
    def state(self) -> EngineState:
        return self._state

    @state.setter
    def state(self, new: EngineState) -> None:
        """With a captured step the state tensors are the graph's inputs:
        a new state is copied into them, never rebound."""
        if self._graph is None:
            self._state = new
            return
        with self._on_stream():
            write_into(self._state, new)

    def attach_analysis(self, rt_cfg=None):
        """Create the online analysis side channel over the host audio ring
        (the reference's RecAnalysis/AnalysisOnDemand processes,
        recording.py:121-604; JAX engine.py:391-415): a local object fed by
        the blocks :meth:`process` and :meth:`process_nosync` write into
        ``host_ring`` (created here if absent).  Its per-hop math runs on
        the engine's device.  Pace it with ``engine.analysis.poll()`` or
        ``realtime.analysis.AnalysisWorker``."""
        from onset_fingerprinting_torch.core.config import RealtimeConfig
        from onset_fingerprinting_torch.realtime.analysis import (
            OnlineAnalysis,
        )

        if rt_cfg is None:
            rt_cfg = RealtimeConfig(sr=self.cfg.sr,
                                    blocksize=self.cfg.block_size,
                                    hop_length=self.cfg.block_size)
        if self.host_ring is None:
            self.host_ring = CircularArray(
                np.zeros((rt_cfg.rec_n, self.cfg.n_channels), np.float32))
        self.analysis = OnlineAnalysis(rt_cfg, self.host_ring,
                                       device=self.device)
        return self.analysis

    # -- recording commands (the reference's analysis_action protocol,
    #    recording.py:379-395: 1 = quantize_start, 2 = quantize_end) -----

    def start_recording(self) -> int:
        """Mark a recording start at now and snap it to a nearby strong
        onset (recording.py:495-529).  Returns the quantized start
        sample."""
        if self.analysis is None:
            raise RuntimeError("attach_analysis() first")
        self.analysis.poll()
        self.analysis.recording_start = self.current_index
        self.analysis.quantize_start()
        self.recording_active = True
        return self.analysis.recording_start

    def stop_recording(self) -> tuple[int, int, Optional[float]]:
        """Mark the recording end at now, extrapolate it to a whole number
        of beats from the BPM estimate (recording.py:531-569) and return
        ``(start, end, bpm)``."""
        if self.analysis is None:
            raise RuntimeError("attach_analysis() first")
        self.analysis.poll()
        self.analysis.recording_end = self.current_index
        end = self.analysis.quantize_end()
        self.recording_active = False
        rec = (self.analysis.recording_start, end, self.analysis.last_bpm)
        self.recordings.append(rec)
        return rec

    def bpm(self, seconds: float = 4.0) -> float:
        """The BPM estimate over the last ``seconds`` of audio."""
        if self.analysis is None:
            raise RuntimeError("attach_analysis() first")
        self.analysis.poll()
        frames = int(seconds * self.cfg.sr / self.analysis.cfg.hop_length)
        return self.analysis.bpm(-frames)

    def stream(self, device=None, latency: float = 0.001):
        """A PortAudio stream (sounddevice) whose callback runs
        :meth:`process` per block; raises ``RuntimeError`` where
        sounddevice is absent (JAX engine.py:895-914)."""
        try:
            import sounddevice as sd
        except ImportError as e:
            raise RuntimeError(
                "sounddevice/PortAudio not available in this environment"
            ) from e

        def callback(indata, outdata, frames, tinfo, status):
            out, _ = self.process(indata.copy())
            outdata[:] = out[:, : outdata.shape[1]]

        return sd.Stream(samplerate=self.cfg.sr, device=device,
                         channels=(self.cfg.n_channels,
                                   self.monitor_channels),
                         callback=callback, latency=latency,
                         blocksize=self.cfg.block_size)

    def attach_classifier(self, model: torch.nn.Module, window: int = 256,
                          pre: int = 64, capacity: int = 16) -> None:
        """Attach an on-device classifier: harvested hits can then be
        classified from the device audio ring in one batched call by
        :meth:`classify_hits` (the windows never leave the card)."""
        self._classify = make_classify_fn(model, window=window, pre=pre,
                                          capacity=capacity,
                                          device=self.device)
        self._classify_capacity = capacity

    def classify_hits(self, events) -> np.ndarray:
        """Classify harvested hits ``[(onset, Location), ...]`` from the
        device ring: ``[len(events), out]`` predictions.  Hits whose audio
        was already overwritten are zeroed, counted in
        :attr:`classify_stale`, flagged in :attr:`last_classify_fresh` and
        warned about."""
        if not hasattr(self, "_classify"):
            raise RuntimeError("attach_classifier() first")
        if not events:
            self.last_classify_fresh = np.zeros((0,), bool)
            return np.zeros((0, 0), np.float32)
        cap = self._classify_capacity
        out, fresh_out = [], []
        for base in range(0, len(events), cap):
            chunk = events[base: base + cap]
            onsets = np.zeros((cap,), np.int32)
            valid = np.zeros((cap,), bool)
            for i, (onset, _) in enumerate(chunk):
                onsets[i] = onset
                valid[i] = True
            with self._on_stream():
                preds, fresh = self._classify(
                    self.state.ring,
                    torch.as_tensor(onsets, device=self.device),
                    torch.as_tensor(valid, device=self.device))
                out.append(preds.float().cpu().numpy()[: len(chunk)])
                fresh_out.append(fresh.cpu().numpy()[: len(chunk)])
        fresh = np.concatenate(fresh_out, axis=0)
        self.last_classify_fresh = fresh
        n_stale = int((~fresh).sum())
        if n_stale:
            self.classify_stale += n_stale
            if self.metrics is not None:
                self.metrics.count("engine.classify.stale", float(n_stale))
            warnings.warn(
                f"classify_hits: {n_stale} hit(s) fell out of the audio ring "
                "before classification (predictions zeroed, counted in "
                "classify_stale); raise ring_seconds to cover the "
                "harvest → classify stall horizon", UserWarning, stacklevel=2)
        return np.concatenate(out, axis=0)

    def warmup(self, audio: np.ndarray) -> None:
        """Prime the detector's envelopes and thresholds on calibration
        audio (whole blocks; K1's warmup mode on the card: the pipe's
        coupled instantiation over more than one block, the step's kernel
        over one)."""
        t = (len(audio) // self.cfg.block_size) * self.cfg.block_size
        if t:
            static, _, _ = detector_init(self.cfg, self.device)
            det = self.state.detector
            with self._on_stream():
                fused_warmup_minmax(
                    detector_static(static, self.params), self.params, det,
                    torch.as_tensor(np.ascontiguousarray(audio[:t]),
                                    dtype=torch.float32, device=self.device),
                    out=det)

    def _run(self, block: np.ndarray) -> None:
        x = torch.from_numpy(np.ascontiguousarray(block, dtype=np.float32))
        if self._graph is not None:
            self._graph.replay(x)
            self._events = self._graph.events
        else:
            self._state, self._events = self._step(
                self._state, x.to(self.device), self.params)

    def process(self, block: np.ndarray) -> tuple[np.ndarray, list[Location]]:
        """Process one ``[B, C]`` block: (output audio, located hits)."""
        self.callback_time = (time.monotonic(), self.current_index)
        if self.host_ring is not None:
            self.host_ring.write(block)
        t0 = time.perf_counter()
        self._run(block)
        with self._on_stream():
            emits = self._events.emits.cpu().numpy()
        if self.metrics is not None:
            self.metrics.observe("engine.step",
                                 (time.perf_counter() - t0) * 1e3)
            self.metrics.count("engine.blocks")
            self.metrics.count("engine.hits", float(emits.sum()))
        locations: list[Location] = []
        if emits.any():
            with self._on_stream():
                pts = self._events.points.cpu().numpy()
            for ch in np.nonzero(emits)[0]:
                locations.append(Location(x=float(pts[ch, 0]),
                                          y=float(pts[ch, 1]),
                                          radius=self.locator.radius))
        out = np.asarray(block[:, : self.monitor_channels], dtype=np.float32)
        out = out * 2.0  # passthrough monitor mix (audio.py:109)
        for loc in locations:
            self.actions.run(out, loc)
        for fx in self.fx:
            out = fx(out, self.cfg.sr, len(out), reset=False)
        self.current_index += len(block)
        return out, locations

    def process_nosync(self, block: np.ndarray) -> None:
        """Run the per-block step with no host read: located hits collect
        in the device event queue for :meth:`harvest`."""
        self.callback_time = (time.monotonic(), self.current_index)
        if self.host_ring is not None:
            self.host_ring.write(block)
        t0 = time.perf_counter()
        self._run(block)
        if self.metrics is not None:
            self.metrics.observe_deadline(
                "engine.step", (time.perf_counter() - t0) * 1e3,
                self.budget_ms)
            self.metrics.count("engine.blocks")
        self.current_index += len(block)

    @property
    def budget_ms(self) -> float:
        """The hard per-block realtime budget (config.py:33-36 of the
        reference): one block's duration."""
        return self.cfg.block_size / self.cfg.sr * 1e3

    # -- pipelined dispatch: the audio thread only enqueues ---------------

    def start_pipeline(self, depth: int = 16) -> None:
        """Start the dispatcher thread of :meth:`process_pipelined`: the
        audio thread copies each block into a bounded queue and returns;
        the dispatcher runs the step.  A full queue drops the block and
        counts it (:attr:`pipeline_drops`)."""
        if self._pipe_q is not None:
            if self._pipe_thread.is_alive():
                warnings.warn(
                    "start_pipeline: the previous dispatcher is still "
                    "running (stop_pipeline timed out); not starting a "
                    "second one", UserWarning, stacklevel=2)
                return
            self._pipe_q = None
        self._pipe_q = q = queue.Queue(maxsize=depth)
        self.pipeline_drops = 0
        self._drops_lock = threading.Lock()
        # enqueue stamps key on the block starts the device records
        self._enq_index = self.current_index

        def loop():
            while True:
                item = q.get()
                if item is None:
                    # blocks queued behind the stop sentinel are never run:
                    # count them as drops
                    leftover = 0
                    while True:
                        try:
                            if q.get_nowait() is not None:
                                leftover += 1
                        except queue.Empty:
                            break
                    if leftover:
                        with self._drops_lock:
                            self.pipeline_drops += leftover
                        if self.metrics is not None:
                            self.metrics.count("engine.pipeline.drops",
                                               float(leftover))
                    return
                t0 = time.perf_counter()
                self.process_nosync(item)
                if self.metrics is not None:
                    self.metrics.observe("engine.dispatch",
                                         (time.perf_counter() - t0) * 1e3)

        self._pipe_thread = threading.Thread(target=loop, daemon=True)
        self._pipe_thread.start()

    def process_pipelined(self, block: np.ndarray) -> None:
        """Audio-thread side of the pipelined dispatch: enqueue a copy of
        the block and return; a full queue drops it (counted)."""
        t0 = time.perf_counter()
        slot = (self._enq_index // self.cfg.block_size) % self._stamp_n
        self._stamp_t[slot] = time.monotonic()
        self._stamp_idx[slot] = self._enq_index
        self._enq_index += len(block)
        try:
            self._pipe_q.put_nowait(np.array(block, np.float32, copy=True))
        except queue.Full:
            with self._drops_lock:
                self.pipeline_drops += 1
            if self.metrics is not None:
                self.metrics.count("engine.pipeline.drops")
        if self.metrics is not None:
            self.metrics.observe_deadline(
                "engine.enqueue", (time.perf_counter() - t0) * 1e3,
                self.budget_ms)

    def stop_pipeline(self, timeout: float = 30.0) -> None:
        """Drain the queue and join the dispatcher.  If it does not end
        within ``timeout`` the queue stays bound and start_pipeline will
        not start a second dispatcher (two would race on the state)."""
        if self._pipe_q is None:
            return
        self._pipe_q.put(None)
        self._pipe_thread.join(timeout=timeout)
        if self._pipe_thread.is_alive():
            warnings.warn(
                f"stop_pipeline: dispatcher still alive after {timeout}s",
                UserWarning, stacklevel=2)
            return
        self._pipe_q = None

    @property
    def pipeline_backlog(self) -> int:
        return self._pipe_q.qsize() if self._pipe_q is not None else 0

    def harvest(self) -> list[tuple[int, Location]]:
        """Drain newly located hits from the device event queue:
        ``[(absolute onset sample, Location), ...]``, with one packed read.
        Events overwritten before a harvest saw them are counted in
        :attr:`harvest_drops` and warned about."""
        st = self.state
        with self._on_stream():
            packed = _pack_events(st.ev_count, st.ev_points, st.ev_onsets,
                                  st.ev_emits).cpu().numpy()
        t_host = time.monotonic()  # the events are on the host as of now
        count = int(packed[0])
        new = count - self._harvested
        if new <= 0:
            return []
        eq = st.ev_points.shape[0]
        if new > eq:  # the oldest events were overwritten
            lost = new - eq
            self.harvest_drops += lost
            if self.metrics is not None:
                self.metrics.count("engine.harvest.drops", float(lost))
            warnings.warn(
                f"harvest: device event queue overflowed: {lost} event(s) "
                f"overwritten since the last harvest (capacity {eq}); "
                "harvest more often or raise event_queue", UserWarning,
                stacklevel=2)
            self._harvested = count - eq
            new = eq
        points = packed[1: 1 + 2 * eq].view(np.float32).reshape(eq, 2)
        onsets = packed[1 + 2 * eq: 1 + 3 * eq]
        emit_idx = packed[1 + 3 * eq:]
        out = []
        for k in range(self._harvested, count):
            slot = k % eq
            out.append((int(onsets[slot]), Location(
                x=float(points[slot, 0]), y=float(points[slot, 1]),
                radius=self.locator.radius)))
            # latency from the emitting block's enqueue stamp; NaN keeps
            # the latencies aligned with the events where there is none
            sslot = (int(emit_idx[slot]) // self.cfg.block_size) \
                % self._stamp_n
            if self._stamp_idx[sslot] == int(emit_idx[slot]):
                lat_ms = (t_host - self._stamp_t[sslot]) * 1e3
                self.hit_latencies_ms.append(lat_ms)
                if self.metrics is not None:
                    self.metrics.observe("engine.hit_latency", lat_ms)
            else:
                self.hit_latencies_ms.append(float("nan"))
        self._harvested = count
        if self.metrics is not None:
            self.metrics.count("engine.hits", float(new))
        return out

    # -- continuous harvester ----------------------------------------------

    def start_harvester(self, sink, period: float = 0.0) -> None:
        """Poll :meth:`harvest` on a thread of its own and hand each
        ``(onset, Location)`` to ``sink``; ``period`` seconds between
        polls (0: back to back)."""
        if self._harvester is not None:
            raise RuntimeError("harvester already running")
        self._harvest_stop = threading.Event()

        def loop():
            while not self._harvest_stop.is_set():
                for ev in self.harvest():
                    sink(ev)
                if period > 0:
                    self._harvest_stop.wait(period)

        self._harvester = threading.Thread(target=loop, daemon=True)
        self._harvester.start()

    def stop_harvester(self, timeout: float = 10.0) -> None:
        if self._harvester is None:
            return
        self._harvest_stop.set()
        self._harvester.join(timeout=timeout)
        self._harvester = None

    def event_counter(self) -> tuple[int, int]:
        """(absolute sample counter, samples since the block start) for
        now: the wall-time → buffer-index mapping (audio.py:135-146);
        ``(0, 0)`` before the first block."""
        if self.callback_time is None:
            return 0, 0
        t0, idx = self.callback_time
        since = round((time.monotonic() - t0) * self.cfg.sr)
        return idx + since, since
