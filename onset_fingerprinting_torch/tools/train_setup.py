"""Calibration: a labeled POSD session → a trained FCNN serve setup (port of
``onset_fingerprinting_tpu.tools.train_setup``).

The command-line loop around the reference's notebook workflow
(refresh.org trains the location model, ``config.save_setup`` persists it,
realtime/config.py:63-84 there):

    tools.mine_hits     recordings → POSD sessions (detect, group, align)
    tools.train_setup   THIS: session → FCNN → setup dir
    realtime.main       serve the setup

It reads a POSD session whose hits carry per-channel ``onset_start``
lists and ``location`` labels, builds sample-lag rows, trains the lags →
(x, y) FCNN (``locate.calibration.train_location_model``) on the card and
writes a setup directory (``ml_conf.json`` + ``model.pt``, the FCNN's
``state_dict``) for ``realtime.main``.  ``--model-input`` picks the lag
representation and is recorded in the setup, so that the engine feeds the
model the one it was trained on (``locate.make_locate_update``):
``arrival`` (sorted-onset pair lags, the reference's serve convention) or
``by_channel`` (fixed channel order ``np.diff``, its training convention,
unambiguous across the whole head).

Run from the repository root (``--cpu`` trains on the CPU):

    python -m onset_fingerprinting_torch.tools.train_setup session.json \
        --out setup_dir --sensors 0.9,0 0.9,120 0.9,240 \
        [--model-input by_channel] [--location-format polar|xy_cm]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core import posd


def session_lags_and_targets(
    session: dict,
    model_input: str = "arrival",
    location_format: str = "polar",
    radius_cm: float = 17.78,
) -> tuple[np.ndarray, np.ndarray]:
    """Hits → (sample-lag rows [N, 2], target positions [N, 2] meters).

    Hits missing a channel's onset (the -1 sentinel) or the ``location``
    label are skipped.  ``location_format="polar"`` reads the POSD
    convention (``[r01, phi_deg]``) scaled by ``radius_cm``; ``"xy_cm"``
    reads cartesian centimeters (what ``data.synth`` sessions store)."""
    hits = [h for h in session["hits"] if h.get("location") is not None]
    onsets = posd.onsets_array(hits)
    if onsets.ndim != 2 or onsets.shape[1] != 3:
        raise ValueError(
            "need per-channel onset_start lists for exactly 3 channels "
            f"(got shape {onsets.shape}); the learned locator completes "
            "groups of 3")
    locs = posd.locations_array(hits)
    keep = (onsets >= 0).all(axis=1)
    onsets, locs = onsets[keep], locs[keep]
    if model_input == "arrival":
        # sorted-onset pair lags (second - first, third - first)
        onsets = np.sort(onsets, axis=1)
        lags = (onsets[:, 1:] - onsets[:, :1]).astype(np.float32)
    elif model_input == "by_channel":
        # fixed channel order adjacent diffs (calibration.py:347 of the
        # reference)
        lags = np.diff(onsets, axis=1).astype(np.float32)
    else:
        raise ValueError(f"unknown model_input {model_input!r}")
    if location_format == "polar":
        r = locs[:, 0] * radius_cm
        phi = np.radians(locs[:, 1])
        xy_cm = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=1)
    elif location_format == "xy_cm":
        xy_cm = locs[:, :2]
    else:
        raise ValueError(f"unknown location_format {location_format!r}")
    return lags, (xy_cm / 100.0).astype(np.float32)  # FCNN targets: meters


def train_setup(
    json_path: str | Path,
    out_dir: str | Path,
    sensors: list,
    *,
    model_input: str = "arrival",
    location_format: str = "polar",
    radius_cm: float = 17.78,
    medium: str = "air",
    c: float | None = None,
    hidden_layers: tuple = (10, 10, 10),
    lr: float = 1e-2,
    epochs: int = 2500,
    epochs_per_step: int = 50,
    device=None,
) -> float:
    """Train on ``device`` (None = the card) and persist the setup;
    returns the training L1 error in cm."""
    from onset_fingerprinting_torch.locate.calibration import (
        train_location_model,
    )
    from onset_fingerprinting_torch.realtime.setup_io import save_setup

    session = posd.read_json(json_path)
    lags, targets = session_lags_and_targets(session, model_input,
                                             location_format, radius_cm)
    if len(lags) < 8:
        raise ValueError(f"only {len(lags)} usable labeled hits")
    bundle, _ = train_location_model(
        lags, targets, lr=lr, num_epochs=epochs, patience=epochs,
        epochs_per_step=epochs_per_step, hidden_layers=tuple(hidden_layers),
        device=device)
    pred = bundle(lags).cpu().numpy()
    err_cm = 100 * float(np.abs(pred - targets).sum(axis=1).mean())
    margs = {"output_size": 2, "hidden_layers": list(hidden_layers),
             "batch_norm": True}
    save_setup(sensors, medium, c, bundle, margs, out_dir,
               model_input=model_input,
               # the serve locator's lag-legality maps must match the
               # geometry the targets were scaled to
               drum_diameter=2 * radius_cm)
    return err_cm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("session_json")
    ap.add_argument("--out", default="setup", help="setup directory")
    ap.add_argument(
        "--sensors", nargs=3, required=True, metavar="R,PHI[,Z]",
        help="three sensor positions, spherical (r fraction, phi deg[, z])")
    ap.add_argument("--model-input", choices=["arrival", "by_channel"],
                    default="arrival")
    ap.add_argument("--location-format", choices=["polar", "xy_cm"],
                    default="polar")
    ap.add_argument("--radius-cm", type=float, default=17.78)
    ap.add_argument("--medium", default="air")
    ap.add_argument("--c", type=float, default=None,
                    help="speed of sound override (m/s)")
    ap.add_argument("--hidden", type=int, nargs="+", default=[10, 10, 10])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=2500)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = ap.parse_args(argv)
    sensors = []
    for s in args.sensors:
        v = [float(x) for x in s.split(",")]
        sensors.append(v + [0.0] * (3 - len(v)))
    err_cm = train_setup(
        args.session_json, args.out, sensors,
        model_input=args.model_input,
        location_format=args.location_format, radius_cm=args.radius_cm,
        medium=args.medium, c=args.c, hidden_layers=tuple(args.hidden),
        lr=args.lr, epochs=args.epochs,
        device="cpu" if args.cpu else None)
    print(f"setup written to {args.out}/ (train L1 {err_cm:.3f} cm, "
          f"model_input={args.model_input})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
