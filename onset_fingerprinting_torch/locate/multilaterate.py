"""Online multilateration: streaming onset events → strike locations (port
of the Newton path of ``onset_fingerprinting_tpu.locate.multilaterate``;
reference: multilateration.py:319-575).

Two layers, as in the JAX package:

- the host locator :class:`Multilaterate3D`, event at a time: candidate
  groups, the negative-lag seed swap, optional CC refinement of an onset
  against live audio, legality by lag maps, Newton trilateration;
- a fixed-capacity locator for the realtime engine (:class:`LocatorState`,
  :func:`locator_init`, :func:`make_locate_update`): the candidate groups
  live in padded tensors and every update is a masked select over all
  slots, with no host read and no Python branch on a device value, so the
  engine's whole per-block step can be captured in one CUDA graph.

Both take the learned locator (``model=FCNNBundle``, JAX
multilaterate.py:273-282 and 789-815): the FCNN maps the completed group's
lag features to meters in place of the Newton solve.  Two more host
locators: :class:`Multilaterate`, the 2D-sensor variant returning polar
coordinates, and :class:`MultilateratePaired`, which trilaterates from
neighbour-pair lags or votes on lag maps with CC lags.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.ndimage import median_filter

from onset_fingerprinting_torch.core.coords import (
    DIAMETER,
    cartesian_to_polar,
    polar_to_cartesian,
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.detect.refine import (
    adjust_onset,
    cc_refine_adjust_jax,
)
from onset_fingerprinting_torch.locate.geometry import lag_map_2d, lag_map_3d
from onset_fingerprinting_torch.locate.trilateration import (
    solve_tdoa,
    solve_trilateration,
)
from onset_fingerprinting_torch.ops.xcorr import (
    cross_correlation_lag,
    find_lag,
)

ONSET_TOL = 50
NORM_CUTOFF = 10
LOOKAROUND = ONSET_TOL + NORM_CUTOFF


def remove_seed(groups, group):
    """Drop competing candidate groups sharing the completed group's seed
    (multilateration.py:160-167)."""
    seed_sensor, seed_onset = group[0][0], group[1][0]
    return [g for g in groups
            if not (g[0][0] == seed_sensor and g[1][0] == seed_onset)]


def _check_model_input(model_input: str, n_sensors: int) -> None:
    if model_input not in ("arrival", "by_channel"):
        raise ValueError(f"unknown model_input {model_input!r}")
    if model_input == "by_channel" and n_sensors != 3:
        raise ValueError(
            "model_input='by_channel' needs exactly 3 sensors (groups "
            "complete on the 3rd arrival, so with more sensors some "
            "channels would be absent from the feature vector)")


class _LagMapsMixin:
    """Lag-map precompute and the legality checks."""

    def _build_maps(self, map_fn, drum_diameter, sr, c=None):
        n = len(self.sensor_locs)
        self.lag_maps = [dict() for _ in range(n)]
        self.max_lags = [dict() for _ in range(n)]
        self.min_lags = [dict() for _ in range(n)]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                lm = map_fn(self.sensor_locs[j], self.sensor_locs[i],
                            d=drum_diameter, sr=sr, scale=1,
                            medium=self.medium, tol=2, c=c).numpy()
                # slack for slightly negative lags near the centre with
                # circularly placed sensors (multilateration.py:386-387)
                lm[lm < -self.samples_per_cm * 1] = np.nan
                self.lag_maps[i][j] = lm
                self.max_lags[i][j] = np.nanmax(lm)
                self.min_lags[i][j] = np.nanmin(lm)
        self.max_max_lags = [np.nanmax(list(d.values()))
                             for d in self.max_lags]

    def is_legal(self, first_sensor: int, later_sensor: int,
                 lag: float) -> bool:
        """Pairwise lag feasibility (multilateration.py:397-411)."""
        return (self.min_lags[first_sensor][later_sensor] < lag
                < self.max_lags[first_sensor][later_sensor])

    def is_legal_3d(self, group, tolerance: float = 1):
        """Joint 2-lag feasibility: the column-major grid argmax where both
        lags fit, (0, 0) when none does (multilateration.py:413-426)."""
        tolerance *= self.samples_per_cm
        sensors, onsets = group[0], group[1]
        lag1 = onsets[1] - onsets[0]
        lag2 = onsets[2] - onsets[0]
        lm1 = self.lag_maps[sensors[0]][sensors[1]]
        lm2 = self.lag_maps[sensors[0]][sensors[2]]
        with np.errstate(invalid="ignore"):
            legal = (lm1 < lag1 + tolerance) & (lm1 > lag1 - tolerance)
            legal &= (lm2 < lag2 + tolerance) & (lm2 > lag2 - tolerance)
        return tuple(np.unravel_index(np.argmax(legal > 0), legal.shape,
                                      "F"))

    def _feasible_cell(self, group):
        """Joint feasibility through the ``feasibility_tols`` cascade: the
        first tier with a feasible cell wins, ``(0, 0)`` when every tier is
        empty.  ``(1.0,)`` is the reference's single 1 cm tier; a 2 cm
        second tier recovers strikes near a sensor whose two 1 cm bands
        cross without sharing a grid cell (the JAX package's
        ``_LagMapsMixin._feasible_cell``)."""
        res = (0, 0)
        for t in getattr(self, "feasibility_tols", (1.0,)):
            res = self.is_legal_3d(group, tolerance=t)
            if res != (0, 0):
                break
        return res


class Multilaterate3D(_LagMapsMixin):
    """Streaming 3D-sensor locator (multilateration.py:319-575): feed onset
    events one at a time to :meth:`locate`; when three mutually feasible
    onsets have come, it returns the trilaterated (x, y) in cm."""

    def __init__(self, sensor_locations, drum_diameter: float = DIAMETER,
                 medium: str = "drumhead", sr: int = 44100,
                 c: Optional[float] = None, model=None,
                 model_input: str = "arrival",
                 feasibility_tols: tuple = (1.0,)):
        self.c = speed_of_sound(100, medium=medium) if c is None else c * 100
        self.model = model
        self.feasibility_tols = tuple(feasibility_tols)
        _check_model_input(model_input, len(sensor_locations))
        self.model_input = model_input
        self.radius = drum_diameter / 2
        self.sensor_locs = [
            tuple(float(v) for v in spherical_to_cartesian(
                x[0] * self.radius, x[1], x[2]))
            for x in sensor_locations
        ]
        self.medium = medium
        self.sr = sr
        self.samples_per_cm = sr / self.c
        self._build_maps(lag_map_3d, drum_diameter, sr, c=self.c)
        self.ongoing: list = []

    def locate(self, sensor_index: int, onset_index: int, rec_audio=None):
        """Process one onset event: (x, y) when a hit completes, else None.
        ``rec_audio`` (a host ring) turns on CC onset refinement against
        live audio (multilateration.py:457-501)."""
        new_groups = []
        for group in self.ongoing:
            lag = onset_index - group[1][0]
            if lag > self.max_max_lags[group[0][0]]:
                continue
            if lag < 0:
                # an adjustment moved an onset before the seed: swap them
                inter = (group[0][0], group[1][0])
                group[0][0] = sensor_index
                group[1][0] = onset_index
                sensor_index, onset_index = inter
                lag = -lag
            if sensor_index not in group[0]:
                if rec_audio is not None:
                    lag, onset_index = self._refine(
                        group, sensor_index, onset_index, rec_audio, lag)
                if self.is_legal(group[0][0], sensor_index, lag):
                    group = (group[0] + [sensor_index],
                             group[1] + [onset_index])
                    if len(group[0]) == 3:
                        if group[0][0] == group[0][1]:
                            break
                        res = self._feasible_cell(group)
                        if res != (0, 0):
                            guess = np.array(res) - self.radius
                            res = self.trilaterate(group, initial_guess=guess)
                            if res is not None:
                                new_groups = remove_seed(new_groups, group)
                            self.ongoing = new_groups
                            return res
                    new_groups.append(group)
            if lag <= self.max_max_lags[group[0][0]]:
                new_groups.append(group)
        new_groups.append(([sensor_index], [onset_index]))
        self.ongoing = new_groups
        return None

    def _refine(self, group, sensor_index, onset_index, rec_audio, lag):
        """CC-refine the new onset against the group's seed on live audio
        (multilateration.py:457-501)."""
        last_onset = group[1][0]
        i = rec_audio.counter - last_onset + LOOKAROUND
        section = np.asarray(rec_audio[-i - 1:])[:, [group[0][0],
                                                     sensor_index]]
        section = np.diff(median_filter(section, 5, axes=0), axis=0)
        section[section >= 0] = 0
        section = np.abs(section)
        section_og = np.array([last_onset, onset_index]) - (
            last_onset - LOOKAROUND)
        new_lag = cross_correlation_lag(
            section[:, 0], section[:, 1], onsets=(group[1][0], onset_index),
            d=0, onset_tolerance=ONSET_TOL,
            normalization_cutoff=NORM_CUTOFF)
        if new_lag is not None:
            lag = new_lag
            co, cn = adjust_onset(section_og, section[:, 0], section[:, 1],
                                  lag)
            group[1][0] += co
            onset_index += cn
        return lag, onset_index

    def trilaterate(self, group, initial_guess):
        """Newton trilateration of a completed group in its natural (seed,
        a, b) order (the JAX package's choice; the reference's reorder at
        multilateration.py:542-544 assumes one sensor layout), or, with a
        model, the FCNN's prediction (meters, returned in cm)."""
        sensors, onsets = group[0], group[1]
        d_a1 = onsets[1] - onsets[0]
        d_b1 = onsets[2] - onsets[0]
        if self.model is not None:
            if self.model_input == "by_channel":
                # adjacent channel-order diffs = np.diff (calibration.py:347
                # of the reference)
                by_ch = np.zeros(3, dtype=np.float64)
                by_ch[list(sensors)] = onsets
                feats = tuple(np.diff(by_ch))
            else:
                feats = (d_a1, d_b1)
            return self.model.call_np(feats) * 100
        triple = torch.tensor([self.sensor_locs[s] for s in sensors[:3]],
                              dtype=torch.float32)
        deltas = torch.tensor([d_a1 / self.sr * self.c,
                               d_b1 / self.sr * self.c], dtype=torch.float32)
        p, ok = solve_tdoa(triple, deltas,
                           torch.as_tensor(initial_guess,
                                           dtype=torch.float32))
        return tuple(map(float, p)) if bool(ok) else None


class Multilaterate(_LagMapsMixin):
    """2D-sensor streaming locator returning polar ``(r, phi°)``, ``r`` a
    fraction of the radius (multilateration.py:578-733)."""

    def __init__(self, sensor_locations, drum_diameter: float = DIAMETER,
                 medium: str = "drumhead", sr: int = 44100,
                 feasibility_tols: tuple = (1.0,)):
        self.radius = drum_diameter / 2
        self.sensor_locs = [
            tuple(float(v) for v in polar_to_cartesian(x[0] * self.radius,
                                                       x[1]))
            for x in sensor_locations
        ]
        self.medium = medium
        self.sr = sr
        self.samples_per_cm = sr / speed_of_sound(100, medium=medium)
        self.feasibility_tols = tuple(feasibility_tols)
        self._build_maps(lag_map_2d, drum_diameter, sr)
        self.ongoing: list = []

    def locate(self, sensor_index: int, onset_index: int):
        """Process one onset event: ``(r, phi)`` when a hit completes, else
        None."""
        new_groups = []
        for group in self.ongoing:
            lag = onset_index - group[1][0]
            if sensor_index not in group[0]:
                if self.is_legal(group[0][0], sensor_index, lag):
                    group = (group[0] + [sensor_index],
                             group[1] + [onset_index])
                    if len(group[0]) == 3:
                        res = self._feasible_cell(group)
                        if res != (0, 0):
                            res = self.trilaterate(
                                group, np.array(res) - self.radius)
                            self.ongoing = new_groups
                            return res
                    new_groups.append(group)
            if lag <= self.max_max_lags[group[0][0]]:
                new_groups.append(group)
        new_groups.append(([sensor_index], [onset_index]))
        self.ongoing = new_groups
        return None

    def trilaterate(self, group, initial_guess):
        sensors, onsets = group[0], group[1]
        c = speed_of_sound(100, medium=self.medium)
        d_a1 = (onsets[1] - onsets[0]) * c / self.sr
        d_b1 = (onsets[2] - onsets[0]) * c / self.sr
        res = solve_trilateration(
            self.sensor_locs[sensors[1]], self.sensor_locs[sensors[2]],
            self.sensor_locs[sensors[0]], d_a1, d_b1, initial_guess)
        if res is None:
            return None
        r, phi = cartesian_to_polar(res[0], res[1], self.radius)
        return float(r), float(phi)


class MultilateratePaired:
    """Neighbour-pair lag-map voting locator (multilateration.py:736-875):
    lag maps between adjacent sensors; CC lags of adjacent pairs vote on
    map cells and the argmax cell wins."""

    def __init__(self, sensor_locations, drum_diameter: float = DIAMETER,
                 scale: float = 10, medium: str = "drumhead",
                 sr: int = 44100):
        self.radius = int(np.round(drum_diameter * scale / 2, 1))
        self.sensor_locs = [
            tuple(float(v) for v in polar_to_cartesian(x[0] * self.radius,
                                                       x[1]))
            for x in sensor_locations
        ]
        self.scale = scale
        self.medium = medium
        self.sr = sr
        n = len(self.sensor_locs)
        self.lag_maps = [dict() for _ in range(n)]
        for i in range(n):
            for k in (-1, 1):
                j = (i + k) % n
                self.lag_maps[i][j] = lag_map_2d(
                    self.sensor_locs[i], self.sensor_locs[j],
                    d=drum_diameter, sr=sr, scale=scale,
                    medium="drumhead").numpy()
        self.res = np.zeros_like(self.lag_maps[0][1])

    def locate(self, lags: list[int], i: int):
        """Direct trilateration from neighbour-pair lags with an
        intensity-weighted initial guess (multilateration.py:802-832)."""
        n = len(self.sensor_locs)
        sensor_a = self.sensor_locs[(i - 1) % n]
        sensor_b = self.sensor_locs[(i + 1) % n]
        sensor_origin = self.sensor_locs[i]
        c = speed_of_sound(100 * self.scale, medium=self.medium)
        d_a1 = lags[0] * c / self.sr
        d_b1 = lags[1] * c / self.sr
        wa = abs(d_a1) / self.radius
        wb = abs(d_b1) / self.radius
        wo = abs(d_a1 + d_b1) / (2 * self.radius)
        guess = np.array([
            sensor_a[0] * wa + sensor_b[0] * wb + sensor_origin[0] * wo,
            sensor_a[1] * wa + sensor_b[1] * wb + sensor_origin[1] * wo,
        ])
        res = solve_trilateration(sensor_a, sensor_b, sensor_origin, d_a1,
                                  d_b1, guess)
        if res is None:
            return None
        r, phi = cartesian_to_polar(res[0], res[1], self.radius)
        return float(r), float(phi)

    def locate_cc(self, x: np.ndarray, onset_idx: int, i: int, tol: int = 2,
                  left: int = 0, right: int = 256):
        """Lag-map voting from the CC lags of each adjacent pair
        (multilateration.py:834-875)."""
        self.res[:] = 0
        for j in self.lag_maps[i]:
            lag = find_lag(x[onset_idx - left:onset_idx + right, i],
                           x[onset_idx - left:onset_idx + right, j])
            with np.errstate(invalid="ignore"):
                self.res += ((self.lag_maps[i][j] < lag + tol)
                             & (self.lag_maps[i][j] > lag - tol))
        coord = np.unravel_index(np.argmax(self.res), self.res.shape)
        px = coord[1] - (self.res.shape[1] - 1) / 2
        py = (self.res.shape[0] - 1) / 2 - coord[0]
        r, phi = cartesian_to_polar(px, py, self.radius)
        return float(r), float(phi)


# ---------------------------------------------------------------------------
# The fixed-capacity locator of the realtime engine
# ---------------------------------------------------------------------------

#: "infinity" for masked int32 age comparisons; ages rebase once
#: ``next_age`` passes ``_AGE_REBASE``, so real ages never reach it
_AGE_INF = 2 ** 31 - 1
_AGE_REBASE = 2 ** 30


class LocatorState(NamedTuple):
    """Padded candidate-group table: slot g holds up to 3 (sensor, onset)
    members; ``count == 0`` marks a free slot."""

    sensors: torch.Tensor   # [G, 3] int32, -1 padded
    onsets: torch.Tensor    # [G, 3] int32
    count: torch.Tensor     # [G] int32
    age: torch.Tensor       # [G] int32 insertion order (for eviction)
    next_age: torch.Tensor  # 0-d int32


@dataclass(frozen=True)
class LocatorConfig:
    """Static data of the fixed-capacity locator."""

    n_sensors: int
    capacity: int = 8
    tolerance_cm: float = 1.0


def locator_init(capacity: int = 8, device=None) -> LocatorState:
    """An empty slot table on ``device`` (None = the card)."""
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    return LocatorState(
        sensors=torch.full((capacity, 3), -1, **i32),
        onsets=torch.zeros((capacity, 3), **i32),
        count=torch.zeros((capacity,), **i32),
        age=torch.zeros((capacity,), **i32),
        next_age=torch.zeros((), **i32),
    )


class LocatorTables(NamedTuple):
    """A host locator's lag maps and geometry as dense tensors."""

    maps: torch.Tensor     # [S, S, H, W] float32, NaN-padded (the diagonal)
    min_lags: torch.Tensor  # [S, S] float32, +inf on the diagonal
    max_lags: torch.Tensor  # [S, S] float32, -inf on the diagonal
    max_max_lags: torch.Tensor  # [S] float32
    xyz: torch.Tensor      # [S, 3] float32 sensor positions (cm)


def build_locator_tables(m: Multilaterate3D, device=None) -> LocatorTables:
    """Pack a host locator's lag maps into dense tensors on ``device``
    (None = the card)."""
    device = resolve_device(device)
    s = len(m.sensor_locs)
    h, w = next(iter(m.lag_maps[0].values())).shape
    maps = np.full((s, s, h, w), np.nan, dtype=np.float32)
    min_l = np.full((s, s), np.inf, dtype=np.float32)
    max_l = np.full((s, s), -np.inf, dtype=np.float32)
    for i in range(s):
        for j, lm in m.lag_maps[i].items():
            maps[i, j] = lm
            min_l[i, j] = m.min_lags[i][j]
            max_l[i, j] = m.max_lags[i][j]
    return LocatorTables(*(
        torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
        for a in (maps, min_l, max_l, m.max_max_lags, m.sensor_locs)))


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-d index tensor, as a gather (no host read)."""
    return v.index_select(0, i.reshape(1)).squeeze(0)


def _set_row_col(m: torch.Tensor, row: torch.Tensor, col: int, value
                 ) -> torch.Tensor:
    """``m`` with ``m[row, col] = value`` (``row`` a 0-d index tensor), as
    a masked select."""
    hit = ((torch.arange(m.shape[0], device=m.device) == row)[:, None]
           & (torch.arange(m.shape[1], device=m.device) == col)[None, :])
    return torch.where(hit, value, m)


def make_locate_update(m: Multilaterate3D, capacity: int = 8,
                       cc_refine: bool = False, model=None,
                       model_input: str = "arrival", device=None):
    """The fixed-capacity locate step (the JAX package's
    ``make_locate_update``, masks ported literally).

    ``model`` (an :class:`~onset_fingerprinting_torch.models.fcnn.
    FCNNBundle`) takes the Newton solve's place: the FCNN in eval mode
    maps the completed group's features to meters (points in cm), and a
    point is emitted only where the prediction is finite.
    ``model_input="arrival"`` feeds ``(lag1, lag2)``, the sample lags after
    the seed swap; ``"by_channel"`` (3 sensors) scatters the group's three
    onsets into channel order and takes adjacent differences in int32
    before the float cast (the onsets grow without bound).

    ``update(state, sensor, onset) -> (state, xy, emit)`` with 0-d int
    tensors; with ``cc_refine=True`` it also takes ``(window [W, C],
    win_start)``, a fixed-length slice of live audio ending now
    (``update.window_len`` long), and refines the incoming onset against
    the oldest candidate group's seed (multilateration.py:457-501; the
    JAX package documents this single-candidate deviation).

    Semantics follow :meth:`Multilaterate3D.locate`: the negative-lag seed
    swap against the oldest such group, joins on pairwise legality, 3-way
    completion through the lag-map feasibility cascade (argmax cell as
    the Newton guess), trilateration, seed dedup, eviction of the oldest
    group.  The lag maps and the geometry are tensors on ``device`` (None
    = the card).
    """
    _check_model_input(model_input, len(m.sensor_locs))
    tables = build_locator_tables(m, device)
    maps, min_l, max_l, mml, xyz = tables
    net = None
    if model is not None:
        net = copy.deepcopy(model.model).to(maps.device).eval()
    g = capacity
    radius = float(m.radius)
    samples_per_cm = float(m.samples_per_cm)
    feas_tols = tuple(samples_per_cm * float(t)
                      for t in getattr(m, "feasibility_tols", (1.0,)))
    c_over_sr = float(m.c / m.sr)
    h = maps.shape[2]
    window_len = int(-(-(LOOKAROUND + float(np.nanmax(m.max_max_lags))
                         + 256) // 128) * 128)
    slots = torch.arange(g, device=device)
    ar3 = torch.arange(3, device=device)

    def update(state: LocatorState, sensor: torch.Tensor,
               onset: torch.Tensor, window: torch.Tensor | None = None,
               win_start: torch.Tensor | None = None):
        sensor = sensor.to(torch.int32)
        onset = onset.to(torch.int32)

        # negative-lag seed swap (multilateration.py:443-449) against the
        # oldest group whose seed came after this onset
        lag_pre = onset - state.onsets[:, 0]
        swap_c = (state.count > 0) & (lag_pre < 0)
        any_swap = torch.any(swap_c)
        gswap = torch.argmin(torch.where(swap_c, state.age, _AGE_INF))
        old_seed_s = _at(state.sensors[:, 0], gswap)
        old_seed_o = _at(state.onsets[:, 0], gswap)
        state = state._replace(
            sensors=_set_row_col(state.sensors, gswap, 0, torch.where(
                any_swap, sensor, old_seed_s)),
            onsets=_set_row_col(state.onsets, gswap, 0, torch.where(
                any_swap, onset, old_seed_o)))
        sensor = torch.where(any_swap, old_seed_s, sensor)
        onset = torch.where(any_swap, old_seed_o, onset)

        if cc_refine:
            if window is None or win_start is None:
                raise ValueError("cc_refine needs window and win_start")
            seed0 = torch.clamp(state.sensors[:, 0], min=0)
            lag0 = (onset - state.onsets[:, 0]).to(torch.float32)
            cand = (
                (state.count > 0) & (lag0 >= 0)
                & (lag0 <= mml[seed0.long()])
                & ~torch.any((state.sensors == sensor)
                             & (ar3 < state.count[:, None]), dim=1))
            gj = torch.argmin(torch.where(cand, state.age, _AGE_INF))
            o0 = _at(state.onsets[:, 0], gj)
            s0 = _at(seed0, gj)
            pos0 = o0 - win_start
            pos1 = onset - win_start
            pair = torch.stack([_at(window.T, s0), _at(window.T, sensor)],
                               dim=1)
            c_seed, c_new, ok = cc_refine_adjust_jax(
                pair, pos0, pos1, lookaround=LOOKAROUND,
                onset_tolerance=ONSET_TOL, normalization_cutoff=NORM_CUTOFF)
            # the energy heuristic moves the seed or the new onset
            do = torch.any(cand) & ok
            onset = onset + torch.where(do, c_new, 0)
            seed_onset = o0 + torch.where(do, c_seed, 0)
            # a refined onset before the seed becomes the seed
            neg = do & (onset < seed_onset)
            new_seed_s = torch.where(neg, sensor, _at(state.sensors[:, 0],
                                                      gj))
            new_seed_o = torch.where(neg, onset, seed_onset)
            sensor = torch.where(neg, s0, sensor)
            onset = torch.where(neg, seed_onset, onset)
            state = state._replace(
                sensors=_set_row_col(state.sensors, gj, 0, new_seed_s),
                onsets=_set_row_col(state.onsets, gj, 0, new_seed_o))

        sensor_g = sensor.reshape(1).expand(g).long()
        lag = (onset - state.onsets[:, 0]).to(torch.float32)  # [G]
        seed_safe = torch.clamp(state.sensors[:, 0], min=0).long()
        alive = (state.count > 0) & (lag <= mml[seed_safe])
        member = torch.any((state.sensors == sensor)
                           & (ar3 < state.count[:, None]), dim=1)
        legal_pair = (min_l[seed_safe, sensor_g] < lag) & (
            lag < max_l[seed_safe, sensor_g])
        joinable = alive & ~member & legal_pair & (state.count < 3)
        completes = joinable & (state.count == 2)

        # lag-map feasibility of every completing candidate: the reference
        # returns at the FIRST completer in insertion order whose cell is
        # feasible (multilateration.py:507-527); an infeasible one lives on
        s1_all = torch.clamp(state.sensors[:, 1], min=0).long()
        lag1_all = (state.onsets[:, 1] - state.onsets[:, 0]).to(
            torch.float32)
        lag2_all = lag
        lm1_all = maps[seed_safe, s1_all]  # [G, h, w]
        lm2_all = maps[seed_safe, sensor_g]
        cells, oks = [], []
        for tol in feas_tols:
            l1 = lag1_all[:, None, None]
            l2 = lag2_all[:, None, None]
            legal_t = ((lm1_all < l1 + tol) & (lm1_all > l1 - tol)
                       & (lm2_all < l2 + tol) & (lm2_all > l2 - tol))
            # column-major per group: the reference's C-order argmax and
            # F-order unravel give (col, row) = (x + r, y + r)
            flat_t = legal_t.transpose(1, 2).reshape(g, -1)
            idx_t = torch.argmax(flat_t.to(torch.uint8), dim=1)
            cell_t = torch.stack([idx_t // h, idx_t % h], dim=1).to(
                torch.float32)  # [G, 2] (col, row)
            cells.append(cell_t)
            oks.append(torch.any(flat_t, dim=1)
                       & torch.any(cell_t != 0, dim=1))
        ok_t = torch.stack(oks)  # [T, G]
        tier = torch.argmax(ok_t.to(torch.uint8), dim=0)  # first feasible
        grid_ok_all = torch.any(ok_t, dim=0)
        cell_all = torch.gather(torch.stack(cells), 0,
                                tier[None, :, None].expand(1, g, 2))[0]
        feasible = completes & grid_ok_all
        returned = torch.any(feasible)
        # the oldest feasible completer (insertion order = ascending age)
        gidx = torch.argmin(torch.where(feasible, state.age, _AGE_INF))

        # the completion path, computed always and masked by validity
        s0 = _at(seed_safe, gidx)
        s1 = _at(s1_all, gidx)
        lag1 = _at(lag1_all, gidx)
        lag2 = _at(lag2_all, gidx)
        guess = _at(cell_all, gidx) - radius
        if model is not None:
            if model_input == "by_channel":
                ids = torch.stack([s0, s1, sensor.long()])
                ons = torch.stack([_at(state.onsets[:, 0], gidx),
                                   _at(state.onsets[:, 1], gidx), onset])
                by_ch = torch.zeros(3, dtype=torch.int32,
                                    device=ons.device).index_put(
                    (ids,), ons.to(torch.int32))
                feats = (by_ch[1:] - by_ch[:-1]).to(torch.float32)
            else:
                feats = torch.stack([lag1, lag2])
            with torch.no_grad():
                point = net(feats[None, :])[0] * 100.0
            solved = torch.all(torch.isfinite(point))
        else:
            triple = xyz[torch.stack([s0, s1, sensor.long()])]
            deltas = torch.stack([lag1, lag2]) * c_over_sr
            point, solved = solve_tdoa(triple, deltas, guess, unroll=True)
        emit = returned & solved

        # joins apply to completing groups too: an infeasible completer
        # keeps its third member and lives on inert until its lag ages out
        slot_pos = torch.clamp(state.count, 0, 2)
        put = joinable[:, None] & (ar3[None] == slot_pos[:, None])
        new_sensors = torch.where(put, sensor, state.sensors)
        new_onsets = torch.where(put, onset, state.onsets)
        new_count = state.count + joinable.to(torch.int32)

        # on a feasible completion the reference returns mid-loop: every
        # group after the completed one (in insertion order) goes, and
        # remove_seed prunes earlier seed-sharers only when the solve
        # succeeded (multilateration.py:160-167, 512-531)
        same_seed = ((state.sensors[:, 0] == _at(state.sensors[:, 0], gidx))
                     & (state.onsets[:, 0] == _at(state.onsets[:, 0], gidx)))
        later_or_self = state.age >= _at(state.age, gidx)
        keep = alive & ~(returned & later_or_self) & ~(emit & same_seed)
        new_count = torch.where(keep, new_count, 0)

        # the fresh single-member group goes to a free slot, else evicts
        # the oldest group; not on the completion path (the reference
        # returns before its singleton append)
        free = new_count == 0
        ins = torch.argmin(torch.where(free, state.age - _AGE_REBASE,
                                       state.age))
        row_i = slots == ins
        seed_col = ar3[None] == 0
        ins_sensors = torch.where(row_i[:, None],
                                  torch.where(seed_col, sensor, -1),
                                  new_sensors)
        new_sensors = torch.where(returned, new_sensors, ins_sensors)
        new_onsets = torch.where(
            returned, new_onsets,
            torch.where(row_i[:, None] & seed_col, onset, new_onsets))
        new_count = torch.where(returned, new_count,
                                torch.where(row_i, 1, new_count))
        new_age = torch.where(returned, state.age,
                              torch.where(row_i, state.next_age, state.age))
        new_next = state.next_age + 1

        # age rebase: next_age grows by one per update; once it passes
        # _AGE_REBASE, shift every age down by the smallest live one (free
        # slots zeroed so repeated rebases cannot compound)
        base = torch.min(torch.where(new_count > 0, new_age, new_next))
        shift = torch.where(new_next > _AGE_REBASE, base, 0)
        rebased_age = torch.where(new_count > 0, new_age - shift,
                                  torch.where(shift > 0, 0, new_age))
        new_state = LocatorState(
            sensors=new_sensors, onsets=new_onsets, count=new_count,
            age=rebased_age, next_age=new_next - shift)
        return new_state, point, emit

    update.window_len = window_len
    update.tables = tables
    return update
