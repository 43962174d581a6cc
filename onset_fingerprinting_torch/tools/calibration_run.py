"""End-to-end calibration pipeline (port of examples/calibration_demo.py).

Simulates the reference's calibration workflow: hits around the drum's lugs
with known TDOA → stage 1, TNC sensor-position calibration → stage 2,
gradient joint refinement (positions + sound xy + C) → stage 3, an FCNN
location model on the lag pairs → stage 4, the setup persisted with
``save_setup`` and reloaded with ``load_setup``, the reloaded model's
prediction equal to the trained one's.

None of it runs a hand-written kernel: the TNC fit is float64 autograd,
the refinement and the FCNN float32 PyTorch on ``device``.

Gate (the demo's): a mean TDOA residual below 2 samples, the FCNN's mean
train-set location error below 10 mm, and the reload within 1e-6.  The
FCNN's bar depends on the platform: adam turns the rounding residue of the
biases in front of BatchNorm into steps of its own, so where patience
stops the run, and the error there, differ by device and CPU (an H100
3.45 mm; one CPU 2.02 mm, another 17.43 mm, which fails the bar).

Run: python -m onset_fingerprinting_torch.tools.calibration_run [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core.coords import spherical_to_cartesian
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate.calibration import (
    calibrate,
    calibration_locations,
    optimize_positions,
    train_location_model,
)
from onset_fingerprinting_torch.realtime.setup_io import load_setup, save_setup

SR = 96000
C_SOUND = 343.0
RADIUS = 14 * 2.54 / 2 / 100  # meters
#: the sensors' spherical positions (radius fraction, phi, theta), as
#: save_setup records them, and the stage-3 model's arguments
SENSORS = [[0.8, 135, 80], [0.8, 15, 60], [0.5, 100, 20]]
MODEL_ARGS = {"output_size": 2, "hidden_layers": [32, 32],
              "batch_norm": True, "input_size": 2}


@dataclass
class Fixture:
    """The demo's geometry: true sensors ``[3, 3]``, the sounds ``[H, 3]``
    (4 centre hits, then 4 at each of 10 lugs), their distances over C
    (seconds), the TDOA and the onset-like matrix ``[H, 3]``."""

    sensors: np.ndarray
    sounds: np.ndarray
    dists: np.ndarray
    tdoa: np.ndarray
    onsets: np.ndarray


def make_fixture() -> Fixture:
    true_sensors = np.array([
        tuple(map(float, spherical_to_cartesian(*p)))
        for p in [(0.8 * RADIUS, 135, 80), (0.8 * RADIUS, 15, 60),
                  (0.15, 100, 20)]
    ])
    sounds = np.asarray(
        [(0.0, 0.0, 0.0)] * 4
        + [tuple(map(float, spherical_to_cartesian(*p)))
           for p in calibration_locations(10, 4, RADIUS * 0.9, 0)]
    )
    dists = np.linalg.norm(
        sounds[:, None, :] - true_sensors[None, :, :], axis=-1) / C_SOUND
    tdoa = np.diff(dists, axis=1)
    onsets = np.cumsum(np.concatenate(
        [np.zeros((len(tdoa), 1)), tdoa * SR], axis=1), axis=1)
    return Fixture(true_sensors, sounds, dists, tdoa, onsets)


def stages_1_2(fix: Fixture, device=None) -> dict:
    """Stage 1 (``calibrate``) and stage 2 (``optimize_positions`` from
    stage 1's positions plus the demo's noise) on ``device`` → the
    positions, the mean TDOA residual (samples), the refined C and the
    seconds of each stage (host clock)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    est = calibrate(fix.onsets, sr=SR, C=C_SOUND, n_lugs=10, n_each=4,
                    hits_at=0.9, center_hits=4, norm=2, device=dev)
    t1 = time.perf_counter()
    d_est = np.linalg.norm(fix.sounds[:, None, :] - est[None, :, :],
                           axis=-1) / C_SOUND
    resid = np.abs(np.diff(d_est, axis=1) - fix.tdoa)
    rng = np.random.default_rng(0)
    lags01 = (fix.dists[:, :2] - fix.dists[:, 2:]) * SR
    sens2, sounds2, c2 = optimize_positions(
        lags01, est + rng.normal(0, 0.002, est.shape), fix.sounds,
        lr=0.05, num_epochs=800, C=C_SOUND, sr=SR, patience=50, device=dev)
    t2 = time.perf_counter()
    return dict(est=est, resid_s=float(resid.mean()),
                resid=float(resid.mean() * SR), sensors=sens2,
                sounds=sounds2, c=c2, seconds=(t1 - t0, t2 - t1))


def lag_features(fix: Fixture) -> np.ndarray:
    """Stage 3's input: each sound's lags of sensors 1 and 2 behind
    sensor 0, in samples ``[H, 2]``."""
    return (fix.dists[:, 1:] - fix.dists[:, :1]) * SR


def stage_3(fix: Fixture, device=None) -> dict:
    """The FCNN location model ([32, 32], BatchNorm; 3000 epochs, patience
    500) on the lag pairs → the model, its per-epoch losses, its predictions and mean train-set
    location error (mm) and the seconds (host clock)."""
    lags = lag_features(fix)
    t0 = time.perf_counter()
    model, errors = train_location_model(
        lags, fix.sounds, lr=0.01, num_epochs=3000, patience=500,
        hidden_layers=[32, 32], batch_norm=True, device=device)
    preds = model(lags).cpu().numpy()
    seconds = time.perf_counter() - t0
    err_mm = float(np.linalg.norm(preds - fix.sounds[:, :2],
                                  axis=1).mean() * 1000)
    return dict(model=model, errors=errors, preds=preds, err_mm=err_mm,
                seconds=seconds)


def stage_4(fix: Fixture, model, folder, device=None) -> dict:
    """``save_setup`` into ``folder``, ``load_setup`` back onto
    ``device``; the reloaded model's prediction on the sixth sound's lags
    against the trained one's."""
    lags = lag_features(fix)
    save_setup(SENSORS, "air", C_SOUND, model, MODEL_ARGS, folder)
    conf, model2 = load_setup(Path(folder), device=device)
    p1 = model.call_np(tuple(lags[5]))
    p2 = model2.call_np(tuple(lags[5]))
    return dict(conf=conf, pred=p1, reloaded=p2,
                diff=float(np.abs(p1 - p2).max()))


def run(device=None, log=print) -> dict:
    """The four stages on ``device`` (None = the card)."""
    fix = make_fixture()
    log("stage 1-2: TNC calibration, then the joint refinement ...")
    res = dict(fixture=fix, **stages_1_2(fix, device))
    log(f"  TDOA residual: mean {res['resid_s'] * 1e6:.2f} µs "
        f"({res['resid']:.2f} samples); refined C {res['c']:.2f} m/s "
        f"(true {C_SOUND})")
    log("stage 3: FCNN location model on lag pairs ...")
    res["stage3"] = stage_3(fix, device)
    log(f"  FCNN mean location error: {res['stage3']['err_mm']:.2f} mm on "
        f"the train set, the metric the reference reports "
        f"({len(res['stage3']['errors'])} epochs)")
    log("stage 4: persist + reload setup ...")
    with tempfile.TemporaryDirectory() as td:
        res["stage4"] = stage_4(fix, res["stage3"]["model"], td, device)
    log(f"  reloaded model: pred {res['stage4']['reloaded']}, max |diff| "
        f"{res['stage4']['diff']:.3g}")
    return res


def gate(res: dict) -> bool:
    """The demo's bars: residual < 2 samples, FCNN < 10 mm, reload within
    1e-6."""
    return (res["resid"] < 2.0 and res["stage3"]["err_mm"] < 10.0
            and res["stage4"]["diff"] <= 1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)
    res = run("cpu" if args.cpu else None)
    s = res["seconds"]
    print(f"host seconds: calibrate {s[0]:.3f}, optimize_positions "
          f"{s[1]:.3f}, FCNN {res['stage3']['seconds']:.3f}")
    ok = gate(res)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
