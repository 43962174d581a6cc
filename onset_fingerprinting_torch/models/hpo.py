"""A copy of ``onset_fingerprinting_tpu.models.hpo`` (no jax in it), with
only its imports changed.

Native hyperparameter search (the reference's optuna stand-in).

The reference drives HPO through an optuna study with trial.suggest_* calls,
optuna's default TPESampler, and a MedianPruner (reference: train.py:46-145).
This module provides the same working surface — ``Trial.suggest_int/float/
categorical``, a ``Study`` with ``optimize(objective, n_trials, catch=...)``,
and median pruning via ``trial.report`` / ``trial.should_prune`` — with a
dependency-free Tree-structured Parzen Estimator sampler (independent
per-parameter Parzen mixtures, hyperopt-style defaults: gamma=0.25 split
capped at 25, neighbor-distance kernel bandwidths plus a uniform-range prior
component, 24 EI candidates scored by l(x)/g(x)).  ``Study(sampler="random")``
keeps the plain random search.  Objectives and trainers run jitted on TPU;
the search loop is host Python.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

#: sampler abstention sentinel: distinguishes "TPE has no opinion, draw
#: uniformly" from a deliberate TPE selection of the value ``None`` (a
#: legitimate categorical arm, e.g. cc_pairs=None in the pair-CC search —
#: returning None itself silently re-randomized that arm and biased the
#: study against it)
_ABSTAIN = object()


class TrialPruned(Exception):
    """Raised by objectives that honor pruning."""


def _norm_cdf(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


class _ParzenMixture:
    """1-D truncated-Gaussian mixture over [low, high] built from
    observations, plus one wide prior component spanning the range (keeps
    g(x) > 0 everywhere and regularizes tiny groups)."""

    def __init__(self, points: np.ndarray, low: float, high: float):
        width = max(high - low, 1e-12)
        mus = np.append(points.astype(float), 0.5 * (low + high))
        order = np.argsort(mus)
        sorted_mus = mus[order]
        # Neighbor-distance bandwidths (hyperopt heuristic), range-clipped.
        padded = np.concatenate(([low], sorted_mus, [high]))
        sig_sorted = np.maximum(
            padded[1:-1] - padded[:-2], padded[2:] - padded[1:-1]
        )
        sigmas = np.empty_like(mus)
        sigmas[order] = sig_sorted
        sigmas = np.clip(sigmas, width / min(100.0, 1.0 + len(mus)), width)
        sigmas[-1] = width  # the prior component stays wide
        self.mus, self.sigmas = mus, sigmas
        self.low, self.high = low, high
        self.log_w = -math.log(len(mus))
        # Truncation normalizers per component.
        self.log_norm = np.array([
            math.log(max(_norm_cdf((high - m) / s) - _norm_cdf((low - m) / s),
                         1e-300))
            for m, s in zip(mus, sigmas)
        ])

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(len(self.mus), size=n)
        draws = rng.normal(self.mus[idx], self.sigmas[idx])
        return np.clip(draws, self.low, self.high)

    def log_pdf(self, xs: np.ndarray) -> np.ndarray:
        z = (xs[:, None] - self.mus[None, :]) / self.sigmas[None, :]
        comp = (
            -0.5 * z * z
            - np.log(self.sigmas)[None, :]
            - 0.5 * math.log(2.0 * math.pi)
            - self.log_norm[None, :]
            + self.log_w
        )
        m = comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True)))[:, 0]


_TPE_N_CANDIDATES = 24
_TPE_GAMMA = 0.25
_TPE_MAX_GOOD = 25


@dataclass
class Trial:
    number: int
    rng: np.random.Generator
    study: "Study"
    params: dict = field(default_factory=dict)
    intermediate: dict = field(default_factory=dict)
    user_attrs: dict = field(default_factory=dict)

    def set_user_attr(self, name: str, value) -> None:
        """Attach a side metric to the trial (optuna's set_user_attr) —
        e.g. the TEST metric of a trial whose objective is the VAL metric,
        so hyperparameter selection never sees the test set."""
        self.user_attrs[name] = value

    def suggest_int(self, name: str, low: int, high: int, log: bool = False) -> int:
        v = self.study._suggest_numeric(self.rng, name, low, high, log)
        if v is _ABSTAIN:
            if log:
                v = math.exp(self.rng.uniform(math.log(low), math.log(high)))
            else:
                v = self.rng.integers(low, high + 1)
        v = min(max(int(round(float(v))), low), high)
        self.params[name] = v
        return v

    def suggest_float(
        self, name: str, low: float, high: float, log: bool = False
    ) -> float:
        v = self.study._suggest_numeric(self.rng, name, low, high, log)
        if v is _ABSTAIN:
            if log:
                v = np.exp(self.rng.uniform(np.log(low), np.log(high)))
            else:
                v = self.rng.uniform(low, high)
        self.params[name] = float(v)
        return self.params[name]

    def suggest_categorical(self, name: str, choices: list):
        v = self.study._suggest_categorical(self.rng, name, choices)
        if v is _ABSTAIN:
            v = choices[int(self.rng.integers(len(choices)))]
        self.params[name] = v
        return v

    # -- median pruning ------------------------------------------------------

    def report(self, value: float, step: int) -> None:
        self.intermediate[step] = value

    def should_prune(self) -> bool:
        if not self.intermediate:
            return False
        step = max(self.intermediate)
        peers = [
            t.intermediate[step]
            for t in self.study.trials
            if t is not self and step in t.intermediate
        ]
        if len(peers) < self.study.n_startup_trials:
            return False
        return self.intermediate[step] > float(np.median(peers))


@dataclass
class FrozenTrial:
    number: int
    value: Optional[float]
    params: dict
    state: str  # "complete" | "pruned" | "failed"
    intermediate: dict
    user_attrs: dict = field(default_factory=dict)


class Study:
    """HPO study with median pruning (minimize).

    ``sampler="tpe"`` (default, matching the reference's optuna default
    TPESampler, train.py:130-145) models each parameter with two Parzen
    mixtures — l(x) over the best ``gamma`` fraction of finished trials and
    g(x) over the rest — and picks the candidate maximizing l(x)/g(x).
    Falls back to uniform-random while fewer than ``n_startup_trials``
    finished trials have sampled the parameter.  ``sampler="random"`` is the
    plain random search.
    """

    def __init__(
        self, seed: int = 0, n_startup_trials: int = 2, sampler: str = "tpe"
    ):
        if sampler not in ("tpe", "random"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.rng = np.random.default_rng(seed)
        self.trials: list[Trial] = []
        self.results: list[FrozenTrial] = []
        self.n_startup_trials = n_startup_trials
        self.sampler = sampler

    # -- TPE -----------------------------------------------------------------

    def _observations(self, name: str) -> list[tuple]:
        """(param value, trial value) for finished trials that sampled
        ``name`` — pruned trials count at their last reported value, as in
        optuna's TPESampler."""
        obs = []
        for ft in self.results:
            if name not in ft.params:
                continue
            if ft.state == "complete":
                obs.append((ft.params[name], ft.value))
            elif ft.state == "pruned" and ft.intermediate:
                obs.append(
                    (ft.params[name], ft.intermediate[max(ft.intermediate)])
                )
        return obs

    def _split(self, obs: list[tuple]) -> tuple[np.ndarray, np.ndarray]:
        vals = np.array([v for v, _ in obs], dtype=object)
        ys = np.array([y for _, y in obs], dtype=float)
        order = np.argsort(ys, kind="stable")
        n_good = max(1, min(int(math.ceil(_TPE_GAMMA * len(obs))),
                            _TPE_MAX_GOOD))
        return vals[order[:n_good]], vals[order[n_good:]]

    def _suggest_numeric(
        self, rng: np.random.Generator, name: str,
        low: float, high: float, log: bool,
    ) -> object:
        """TPE proposal in the (possibly log-) transformed domain, or
        ``_ABSTAIN`` to fall back to random sampling."""
        if self.sampler != "tpe":
            return _ABSTAIN
        obs = self._observations(name)
        if len(obs) < self.n_startup_trials:
            return _ABSTAIN
        good, bad = self._split(obs)
        if len(bad) == 0:
            return _ABSTAIN
        tf = math.log if log else float
        lo, hi = tf(low), tf(high)
        l_est = _ParzenMixture(np.array([tf(v) for v in good]), lo, hi)
        g_est = _ParzenMixture(np.array([tf(v) for v in bad]), lo, hi)
        cands = l_est.sample(rng, _TPE_N_CANDIDATES)
        best = cands[np.argmax(l_est.log_pdf(cands) - g_est.log_pdf(cands))]
        return math.exp(best) if log else float(best)

    def _suggest_categorical(
        self, rng: np.random.Generator, name: str, choices: list
    ) -> object:
        if self.sampler != "tpe":
            return _ABSTAIN
        obs = self._observations(name)
        if len(obs) < self.n_startup_trials:
            return _ABSTAIN
        good, bad = self._split(obs)
        if len(bad) == 0:
            return _ABSTAIN

        def weights(group):
            # Dirichlet-smoothed counts (prior weight 1 per choice).
            c = np.ones(len(choices))
            for v in group:
                c[choices.index(v)] += 1.0
            return c / c.sum()

        wl, wg = weights(good), weights(bad)
        cands = rng.choice(len(choices), size=_TPE_N_CANDIDATES, p=wl)
        best = cands[np.argmax(np.log(wl[cands]) - np.log(wg[cands]))]
        return choices[int(best)]

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        catch: tuple = (),
    ) -> None:
        for i in range(n_trials):
            trial = Trial(
                number=len(self.trials),
                rng=np.random.default_rng(self.rng.integers(2**32)),
                study=self,
            )
            self.trials.append(trial)
            try:
                value = float(objective(trial))
                state = "complete"
            except TrialPruned:
                value, state = None, "pruned"
            except catch:
                value, state = None, "failed"
            self.results.append(
                FrozenTrial(
                    trial.number, value, dict(trial.params), state,
                    dict(trial.intermediate), dict(trial.user_attrs),
                )
            )

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.results if t.state == "complete"]
        if not done:
            raise ValueError("no completed trials")
        return min(done, key=lambda t: t.value)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> dict:
        return self.best_trial.params
