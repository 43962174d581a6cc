"""Location-model hyperparameter search end to end over a synthetic MCPOSD
session (port of examples/hpo_demo.py).

``models.experiment.run_location_hpo`` drives ``models.hpo.Study`` (TPE
sampler and median pruning) over ``build_cccnn`` configurations, each
trial trained full batch on ``device``.  ``build_cccnn``'s stack has a
GroupNorm after every layer, so its convolutions are the ``F.conv1d``
chain (cuDNN on the card), as the JAX package runs them through XLA's conv
and not through its Pallas kernel.

Two fixtures (``--fixture``):

- ``modal`` (default): the modal-drum synthesizer (``data.synth``), whose
  per-sensor waveforms vary with the hit position, so raw onset windows
  carry learnable regression signal;
- ``airlag``: an identical burst per channel shifted by air-speed delays,
  kept as a negative control: the CCCNN's self-correlation features are
  shift-invariant, so the search plateaus at the predict-the-mean floor.

Gate (the demo's): a complete trial and a finite best validation L1.

Run: python -m onset_fingerprinting_torch.tools.location_hpo [--cpu]
[--trials 2] [--epochs 300] [--fixture modal]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core import posd
from onset_fingerprinting_torch.core.coords import (
    DIAMETER,
    polar_to_cartesian,
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.data.synth import synth_location_session
from onset_fingerprinting_torch.models.experiment import run_location_hpo

SR = 96000


def synth_airlag(folder: Path, n_hits: int = 48, seed: int = 0) -> None:
    """The ``airlag`` fixture (the demo's ``synth_session``): one burst per
    channel at its air-speed delay, written as POSD session
    ``combined0``."""
    radius = DIAMETER / 2
    polar = [(0.9, 0.0, 0.0), (0.9, 90.0, 0.0), (0.9, 180.0, 0.0),
             (0.9, 270.0, 0.0)]
    xyz = [
        tuple(float(v) for v in spherical_to_cartesian(r * radius, phi, th))
        for (r, phi, th) in polar
    ]
    # the full inter-sensor lag spread (~84 samples across the drum) fits
    # inside the 256-sample extraction frame
    c = speed_of_sound(100, medium="air")  # cm/s
    rng = np.random.default_rng(seed)
    n = 4000 * n_hits + 8000
    audio = rng.normal(0, 1e-4, (n, 4)).astype(np.float32)
    t = np.arange(500)
    burst = (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 130)
             * 0.6).astype(np.float32)
    onsets, locs = [], []
    for i in range(n_hits):
        base = 4000 + i * 4000
        r = rng.uniform(0.1, 0.9)
        phi = rng.uniform(0, 360)
        x, y = polar_to_cartesian(r * radius, phi)
        delays = []
        for ch, (sx, sy, _) in enumerate(xyz):
            d = np.hypot(float(x) - sx, float(y) - sy)
            delay = int(round(d / c * SR))
            delays.append(delay)
            audio[base + delay: base + delay + 500, ch] += burst
        onsets.append(base + min(delays))
        # cartesian cm targets (continuous: no phi wraparound seam)
        locs.append([float(x), float(y)])
    posd.save_session(
        folder, "combined0", audio, SR,
        posd.make_hits(np.asarray(onsets),
                       locations=np.asarray(locs, np.float32)),
    )


def write_fixture(folder: Path, fixture: str = "modal", hits: int = 48
                  ) -> None:
    if fixture == "modal":
        synth_location_session(folder, n_hits=hits, sr=SR, seed=0)
    else:
        synth_airlag(folder, n_hits=hits)


def run(trials: int = 2, epochs: int = 300, hits: int = 48,
        fixture: str = "modal", min_epochs: int = 0, patience: int = 0,
        subsample: int = 1, sampler: str = "tpe",
        search_pairs: bool = False, device=None, log=print) -> dict:
    """The demo's study on ``device`` (None = the card) → the study, its
    trials and the seconds of the search (host clock)."""
    with tempfile.TemporaryDirectory() as td:
        folder = Path(td)
        write_fixture(folder, fixture, hits)
        t0 = time.perf_counter()
        study = run_location_hpo(
            folder, "combined0", w=256, channels=4, pre_samples=8,
            n_trials=trials, num_epochs=epochs, min_epochs=min_epochs,
            patience=patience or epochs, subsample=subsample,
            sampler=sampler, search_pairs=search_pairs, device=device,
        )
        seconds = time.perf_counter() - t0
    log(f"{trials} trials x {epochs} epochs in {seconds:.1f}s")
    # selection on VAL; the test number reported belongs to the selected
    # trial (never min-over-trials of the test metric)
    for t in study.results:
        v = "-" if t.value is None else f"{t.value:.3f}"
        tl = t.user_attrs.get("test_l1")
        tl = "-" if tl is None else f"{tl:.3f}"
        log(f"  trial {t.number}: {t.state:<9} val {v:>7} test {tl:>7} "
            f"params {t.params}")
    return dict(study=study, states=[t.state for t in study.results],
                seconds=seconds)


def gate(res: dict) -> bool:
    """A complete trial and a finite best validation L1."""
    return (any(s == "complete" for s in res["states"])
            and bool(np.isfinite(res["study"].best_value)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--min-epochs", type=int, default=0)
    ap.add_argument("--patience", type=int, default=0,
                    help="early-stop patience; 0 = no early stop")
    ap.add_argument("--hits", type=int, default=48)
    ap.add_argument("--fixture", choices=("modal", "airlag"),
                    default="modal")
    ap.add_argument("--sampler", choices=("tpe", "random"), default="tpe")
    ap.add_argument("--search-pairs", action="store_true",
                    help="search the pair-CC head (cc_pairs in {None, "
                    "adjacent, all}) too")
    ap.add_argument("--subsample", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)
    res = run(args.trials, args.epochs, args.hits, args.fixture,
              args.min_epochs, args.patience, args.subsample, args.sampler,
              args.search_pairs, "cpu" if args.cpu else None)
    study = res["study"]
    test_l1 = study.best_trial.user_attrs.get("test_l1", float("nan"))
    print(f"best val L1: {study.best_value:.3f} cm")
    print(f"test L1 of the selected trial: {test_l1:.3f} cm")
    print(f"best params: {study.best_params}")
    print(f"trial states: {res['states']}")
    ok = gate(res)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
