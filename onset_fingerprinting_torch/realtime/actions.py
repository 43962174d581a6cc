"""Location-triggered actions: map hit locations to FX/parameter changes
(a numpy copy of ``onset_fingerprinting_tpu.realtime.actions`` on the
port's ``core.coords``).

Host-side control plane, re-designed from the reference's actions system
(reference: realtime/actions.py:26-410): :class:`Location` (auto cartesian↔
polar), :class:`Bounds` regions with circular-phi wraparound,
:class:`Action` lifecycle (countdown/loop/priority/spawn),
:class:`ParameterChange` mapping a hit coordinate onto external FX parameters
via :class:`ParameterMapper`, :class:`Sample` one-shot playback, and the
:class:`Actions` scheduler run once per audio callback.

External FX hosts (the reference hard-wires pedalboard VST plugins) are
abstracted behind a tiny duck-typed protocol: any object with a
``parameters`` mapping whose values expose ``raw_value`` works — pedalboard
plugins satisfy it when present, and :class:`FxParams` provides a native
stand-in.
"""

from __future__ import annotations

import queue
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from onset_fingerprinting_torch.core.coords import (
    cartesian_to_polar,
    polar_to_cartesian,
)


@dataclass(order=True)
class Trigger:
    """Plan-queue message (rebuild of loopmate's trigger classes the
    reference imports, realtime/main.py:10): producers put these into
    ``Actions.plans``; the app's plan drain consumes them
    (reference realtime/main.py:20-41).

    ``at_sample`` optionally defers handling until the engine's absolute
    sample counter reaches it (lets tests/sequencers schedule triggers
    deterministically); ``None`` = handle immediately.
    """

    priority: int = 5
    at_sample: Optional[int] = field(default=None, compare=False)


@dataclass(order=True)
class RecordTrigger(Trigger):
    """Toggle recording (reference main.py:28-35: starts when idle, stops
    when active)."""


@dataclass(order=True)
class BackCaptureTrigger(Trigger):
    """Capture the recent audio ring to disk (reference main.py:36-37's
    ``pr.backcapture(n_loops)``)."""

    n_loops: int = field(default=1, compare=False)


class _Param:
    __slots__ = ("raw_value",)

    def __init__(self, value: float = 0.0):
        self.raw_value = value


class FxParams:
    """Minimal native FX-parameter host (pedalboard-compatible duck type)."""

    def __init__(self, names: list[str]):
        self.parameters = {n: _Param() for n in names}

    def __call__(self, audio: np.ndarray, sr: int, frames: int, reset=False):
        return audio


@dataclass
class Location:
    """A hit location; fills in whichever of (x, y) / (r, phi°) is missing
    (actions.py:161-177).

    Deviation: the reference normalizes r by |xy| itself (actions.py:172-174),
    so its r is always 1.0 and its ``radius`` field is dead.  Here r is the
    drum-radius fraction when ``radius`` is given (the engine passes the
    locator's), else the raw distance — so r-Bounds actually discriminate.
    """

    x: Optional[float] = None
    y: Optional[float] = None
    r: Optional[float] = None
    phi: Optional[float] = None
    radius: Optional[float] = None

    def __post_init__(self):
        if self.x is None:
            x, y = polar_to_cartesian(self.r, self.phi)
            self.x, self.y = float(x), float(y)
        else:
            r, phi = cartesian_to_polar(self.x, self.y, r=self.radius)
            self.r, self.phi = float(r), float(phi)

    def __repr__(self):
        return (
            f"Location(x={self.x:.3f}, y={self.y:.3f}, "
            f"r={self.r:.3f}, phi={self.phi:.1f})"
        )


class Bounds:
    """Region over (x, y, r, phi); phi may wrap (min > max)
    (actions.py:181-225)."""

    def __init__(self, x=None, y=None, r=None, phi=None):
        x = sorted(x) if x is not None else (-np.inf, np.inf)
        y = sorted(y) if y is not None else (-np.inf, np.inf)
        r = sorted(r) if r is not None else (-np.inf, np.inf)
        phi = phi if phi is not None else (-np.inf, np.inf)
        self.x_min, self.x_max = x
        self.y_min, self.y_max = y
        self.r_min, self.r_max = r
        self.phi_min, self.phi_max = phi
        self.wraps = self.phi_min > self.phi_max

    def __contains__(self, loc: Location) -> bool:
        cart = (
            self.x_min <= loc.x <= self.x_max
            and self.y_min <= loc.y <= self.y_max
        )
        if self.wraps:
            polar = self.r_min <= loc.r <= self.r_max and (
                loc.phi >= self.phi_min or loc.phi <= self.phi_max
            )
        else:
            polar = (
                self.r_min <= loc.r <= self.r_max
                and self.phi_min <= loc.phi <= self.phi_max
            )
        return cart and polar


class ParameterMapper:
    """Map a location coordinate into one or more target parameter ranges
    with an optional nonlinearity (actions.py:51-151)."""

    def __init__(
        self,
        coordinate: str,
        target_names: list[str],
        original_range: tuple[float, float],
        target_ranges: list[tuple[float, float]],
        transformation: Optional[Callable[[float], float]] = None,
    ):
        assert coordinate in {"x", "y", "r", "phi"}
        self.coordinate = coordinate
        self.target_names = target_names
        self.original_min, self.original_max = original_range
        self.target_ranges = target_ranges
        self.transformation = transformation

    def __call__(self, value: float) -> list[float]:
        t = (value - self.original_min) / (
            self.original_max - self.original_min
        )
        if self.transformation:
            t = self.transformation(t)
        return [
            t * (hi - lo) + lo for lo, hi in self.target_ranges
        ]

    @classmethod
    def from_bounds_fx(
        cls,
        bounds: Bounds,
        effect,
        coordinate: str,
        parameters: list[str],
        transformation: Optional[Callable[[float], float]] = None,
    ) -> "ParameterMapper":
        assert all(p in effect.parameters for p in parameters), (
            "FX parameters and given parameter names don't align"
        )
        original = (
            getattr(bounds, f"{coordinate}_min"),
            getattr(bounds, f"{coordinate}_max"),
        )
        return cls(
            coordinate,
            parameters,
            original,
            [(0.0, 1.0) for _ in parameters],
            transformation,
        )


@dataclass
class Action:
    """A location-triggered effect with a lifecycle (actions.py:229-303)."""

    bounds: list[Bounds]
    countdown: int = 0
    loop: bool = False
    n: int = 0
    priority: int = 3
    spawn: Optional["Action"] = None

    def __post_init__(self):
        self.current_sample = 0
        self.consumed = False

    def trigger(self, location: Location) -> bool:
        return any(location in b for b in self.bounds)

    def run(self, data: np.ndarray, location: Location) -> None:
        self.do(data, location)
        self.current_sample += len(data)
        if self.current_sample >= self.n:
            if self.loop:
                self.current_sample = 0
            elif self.countdown > 0:
                self.current_sample = 0
                self.countdown -= 1
            else:
                self.consumed = True

    def do(self, data: np.ndarray, location: Location) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        self.current_sample = self.n
        self.loop = False
        self.countdown = 0
        self.consumed = True

    def reset(self) -> None:
        self.current_sample = 0
        self.consumed = False

    def __lt__(self, other) -> bool:
        return self.priority < other.priority


class ParameterChange(Action):
    """Set FX parameters from the hit coordinate (actions.py:306-341)."""

    def __init__(self, bounds, effect, parameter_mappers):
        super().__init__(bounds, loop=True)
        self.effect = effect
        self.pms = parameter_mappers
        for pm in self.pms:
            assert all(
                name in self.effect.parameters for name in pm.target_names
            ), "FX parameters and ParameterMapper names don't align"

    def do(self, data, location: Location) -> None:
        for pm in self.pms:
            values = pm(getattr(location, pm.coordinate))
            for name, value in zip(pm.target_names, values):
                self.effect.parameters[name].raw_value = value

    def cancel(self) -> None:
        self.current_sample = self.n
        self.loop = False


class Sample(Action):
    """Additively play a one-shot sample on trigger (actions.py:343-355)."""

    def __init__(self, bounds, sample: np.ndarray, gain: float = 1.0):
        super().__init__(bounds, n=len(sample), priority=1)
        self.sample = sample
        self.gain = gain

    def do(self, data, location: Location) -> None:
        chunk = self.sample[
            self.current_sample : self.current_sample + len(data)
        ]
        data[: len(chunk)] += self.gain * chunk


@dataclass
class Actions:
    """Per-callback action scheduler (actions.py:359-410): armed actions in a
    deque, triggered ones in a priority queue, re-queued until consumed.

    Unlike the reference — whose serve loop calls ``run`` but never
    ``trigger`` (audio.py:112; nothing arms the active queue, so armed
    actions can never fire) — ``run`` here triggers matching actions first.
    """

    max: int = 20
    actions: deque = field(default_factory=deque)
    active: "queue.PriorityQueue[Action]" = field(
        default_factory=queue.PriorityQueue
    )
    plans: "queue.PriorityQueue" = field(default_factory=queue.PriorityQueue)

    def append(self, action: Action) -> None:
        self.actions.append(action)

    def prepend(self, action: Action) -> None:
        self.actions.insert(0, action)

    def trigger(self, location: Location) -> None:
        for action in self.actions:
            if action.trigger(location):
                self.active.put_nowait(action)

    def run(self, outdata: np.ndarray, location: Location) -> None:
        self.trigger(location)
        readd = []
        while not self.active.empty():
            action = self.active.get_nowait()
            action.run(outdata, location)
            if action.consumed:
                action.reset()
                if action.spawn is not None:
                    self.actions.append(action.spawn)
            else:
                readd.append(action)
        for action in readd:
            self.active.put_nowait(action)
