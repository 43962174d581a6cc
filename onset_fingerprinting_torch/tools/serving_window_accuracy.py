"""Accuracy of the serving window extractions (port of
examples/serving_window_accuracy.py).

The sample-anchored serving path pins each hit's onset at index ``pre`` of
its window: the detector runs over the session (K1 on the card: the 0.5 s
warmup and the whole session, each one launch on the coupled pipe), each
hit is anchored at its earliest detected arrival, and
``ops.windows.gather_hit_windows(anchored=True)`` cuts the windows (K2 on
the card, ``csrc/gather_vec.cu``).  The legacy block-aligned mode leaves
the onset at ``PRE_SERVE + (onset mod block)``, up to 127 samples of
jitter.  Two models:

- model A, trained with exact anchoring (pre = 8, shifts of up to 16
  samples), evaluated (a) exactly, (b) through the anchored serving gather
  at the detector's onsets and (c) through the block-aligned windows;
- model B, trained with serving-matched anchoring (pre = 128, shifts of up
  to 64: the block-aligned windows' offsets), evaluated through the
  block-aligned windows.

Both are ``build_cccnn(None, channels=4)``, whose stack has a GroupNorm
after every layer: its convolutions are the ``F.conv1d`` chain (cuDNN on
the card), as the JAX package runs them through XLA's conv and not through
its Pallas kernel.  Held-out hits are split into validation (checkpoint
selection; each model validates on its own deployment extraction) and test
halves.

Gate (the demo's): A's anchored error within 1.1x of A's exact error, and
B within 2x of A's exact error and 4x below the predict-the-mean floor.

Run: python -m onset_fingerprinting_torch.tools.serving_window_accuracy
[--cpu] [--hits N] [--epochs N]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from onset_fingerprinting_torch.core.audio_io import read_wav
from onset_fingerprinting_torch.core.config import TrainConfig
from onset_fingerprinting_torch.data.datasets import MCPOSD
from onset_fingerprinting_torch.data.synth import synth_location_session
from onset_fingerprinting_torch.detect import detect_onsets_amplitude
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.experiment import build_cccnn
from onset_fingerprinting_torch.models.train import Trainer, make_optimizer
from onset_fingerprinting_torch.ops.windows import (
    gather_hit_windows,
    gather_kernel_for,
)

SR = 96000
W = 256
BLOCK = 128
PRE_SERVE = 64  # lead-in before the block-aligned start
PRE = 8  # the anchored windows' and model A's lead-in
#: labelled onsets farther than this from every detected one fall back
SEARCH = 256


def serving_windows(audio: np.ndarray, onsets: np.ndarray) -> np.ndarray:
    """Block-aligned extraction: row 0 = (onset // BLOCK) * BLOCK -
    PRE_SERVE, so the onset sits at PRE_SERVE + (onset % BLOCK)."""
    rows = (onsets // BLOCK) * BLOCK - PRE_SERVE
    rows = np.clip(rows, 0, audio.shape[0] - W)
    idx = rows[:, None] + np.arange(W)[None, :]
    return np.transpose(audio[idx], (0, 2, 1)).astype(np.float32)


def anchors_from_onsets(onsets_det: np.ndarray, hit_onsets: np.ndarray
                        ) -> tuple[np.ndarray, int]:
    """Each hit's earliest detected onset within ±SEARCH samples of its
    labelled one, else the labelled onset (counted as missed)."""
    onsets_det = np.sort(np.asarray(onsets_det))
    anchors = np.empty(len(hit_onsets), np.int64)
    missed = 0
    for i, o in enumerate(hit_onsets):
        cand = onsets_det[(onsets_det >= o - SEARCH)
                          & (onsets_det <= o + SEARCH)]
        if len(cand):
            anchors[i] = cand.min()  # the earliest arrival anchors the hit
        else:
            anchors[i] = o
            missed += 1
    return anchors, missed


def anchored_serving_windows(audio: np.ndarray, hit_onsets: np.ndarray,
                             pre: int = PRE, device=None) -> dict:
    """The sample-anchored serving extraction on ``device`` (None = the
    card): the detector over the session, the anchors, then the anchored
    gather → ``windows [N, C, W]`` (on ``device``), ``missed``,
    ``anchors``, the detected ``onsets`` (sorted), the detector's own
    output (``detected``: channels, onsets, rel) and K2's ``route`` (on
    the card; None on the CPU)."""
    dev = resolve_device(device)
    channels, onsets_det, rel = detect_onsets_amplitude(audio, sr=SR,
                                                        device=dev)
    anchors, missed = anchors_from_onsets(onsets_det, hit_onsets)
    # the session on the card as a tensor of its own (aligned for the
    # row-vector gather), never an offset view
    x = torch.as_tensor(np.ascontiguousarray(audio, np.float32)).to(dev)
    c = x.shape[1]
    route = (gather_kernel_for(c, W, x.data_ptr())
             if dev.type == "cuda" else None)
    n = len(anchors)
    wins = gather_hit_windows(
        x, torch.as_tensor(anchors.astype(np.int32), device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev), c, W, pre,
        anchored=True)
    return dict(windows=wins, missed=missed, anchors=anchors,
                onsets=np.sort(np.asarray(onsets_det)), route=route,
                detected=dict(channels=np.asarray(channels),
                              onsets=np.asarray(onsets_det), rel=rel))


def split_masks(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The hit-level holdout: a quarter of the hits, halved into
    validation and test (``default_rng(1)``)."""
    rng = np.random.default_rng(1)
    held = rng.permutation(n)[: n // 4]
    val_idx, test_idx = held[: len(held) // 2], held[len(held) // 2 :]
    val_mask = np.zeros(n, bool)
    val_mask[val_idx] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True
    return val_mask, test_mask


@dataclass
class Fixture:
    """The session and every extraction the two models train, validate
    and test on (arrays or tensors)."""

    audio: np.ndarray
    onsets: np.ndarray
    locs: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    train_a: tuple  # exact anchoring, 4 shifted rounds of the train hits
    train_b: tuple  # serving-matched anchoring
    val_a: tuple  # exact windows of the validation hits
    val_b: tuple  # block-aligned windows of the validation hits
    x_exact: object  # exact windows of the test hits
    x_serv: np.ndarray  # block-aligned windows of the test hits

    @property
    def y_test(self) -> np.ndarray:
        return self.locs[self.test_mask]

    def mean_floor(self) -> float:
        """Predict the train hits' mean location, L1 on the test hits."""
        keep = ~(self.val_mask | self.test_mask)
        mean_pred = self.locs[keep].mean(axis=0)
        return float(np.mean(np.abs(mean_pred[None] - self.y_test)))


def make_fixture(hits: int = 512, device=None) -> Fixture:
    """The demo's session (``synth_location_session``, seed 0), its three
    MCPOSD extractions on ``device`` and the hit-level split."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        folder = Path(td)
        onsets, locs = synth_location_session(folder, n_hits=hits, sr=SR,
                                              seed=0)
        # exact-anchored training set (the reference's extraction)
        ds_a = MCPOSD.from_file(folder, "combined0", W, PRE, 16, 4,
                                device=dev)
        # serving-matched training set: onset offset ~ U[64, 192]
        ds_b = MCPOSD.from_file(folder, "combined0", W, 128, 64, 4,
                                device=dev)
        exact = MCPOSD.from_file(folder, "combined0", W, PRE, 0, 1,
                                 device=dev)
        audio, _ = read_wav(folder / "combined0.wav")
    val_mask, test_mask = split_masks(hits)
    xa, ya = ds_a[0]
    xb, yb = ds_b[0]
    keep = torch.as_tensor(np.tile(~(val_mask | test_mask), 4), device=dev)
    vm = torch.as_tensor(val_mask, device=dev)
    tm = torch.as_tensor(test_mask, device=dev)
    return Fixture(
        audio=audio, onsets=onsets, locs=locs, val_mask=val_mask,
        test_mask=test_mask, train_a=(xa[keep], ya[keep]),
        train_b=(xb[keep], yb[keep]), val_a=(exact.x[vm], exact.y[vm]),
        val_b=(serving_windows(audio, onsets[val_mask]), locs[val_mask]),
        x_exact=exact.x[tm], x_serv=serving_windows(audio, onsets[test_mask]))


def train_cccnn(x, y, val, epochs: int, lr: float, device=None):
    """The demo's model and schedule: ``build_cccnn`` trained full batch
    with adam under a cosine over 100 updates, validated every tenth of
    the epochs."""
    cfg = TrainConfig(lr=lr, num_epochs=epochs, min_epochs=0,
                      patience=epochs, loss="l1", seed=0, optimizer="adam")
    trainer = Trainer(build_cccnn(None, channels=4), cfg,
                      optimizer=make_optimizer("adam", lr,
                                               schedule="cosine",
                                               schedule_period=100),
                      device=device)
    state = trainer.fit((x, y), val, epochs_per_step=max(epochs // 10, 1))
    return trainer, state


def evaluate(fix: Fixture, x_anch, epochs: int = 1500, lr: float = 3e-3,
             device=None, log=print) -> dict:
    """Train models A and B and take their test L1 (cm) on each
    extraction; ``x_anch`` is the test hits' anchored windows."""
    dev = resolve_device(device)
    y_test = fix.y_test
    t0 = time.perf_counter()
    tr_a, st_a = train_cccnn(*fix.train_a, fix.val_a, epochs, lr, dev)
    res = dict(a_exact=tr_a.test(st_a, (fix.x_exact, y_test)),
               a_serv=tr_a.test(st_a, (fix.x_serv, y_test)),
               a_anch=tr_a.test(st_a, (x_anch, y_test)))
    t1 = time.perf_counter()
    log(f"model A (exact-trained): exact {res['a_exact']:.3f} cm, "
        f"block-aligned {res['a_serv']:.3f} cm, anchored "
        f"{res['a_anch']:.3f} cm")
    tr_b, st_b = train_cccnn(*fix.train_b, fix.val_b, epochs, lr, dev)
    res.update(b_serv=tr_b.test(st_b, (fix.x_serv, y_test)),
               b_exact=tr_b.test(st_b, (fix.x_exact, y_test)))
    t2 = time.perf_counter()
    log(f"model B (serving-matched aug): serving-gather "
        f"{res['b_serv']:.3f} cm, exact {res['b_exact']:.3f} cm")
    res["floor"] = fix.mean_floor()
    res["seconds"] = dict(train_a=t1 - t0, train_b=t2 - t1)
    res["steps"] = (len(tr_a.history["train_loss"])
                    + len(tr_b.history["train_loss"]))
    return res


def run(hits: int = 512, epochs: int = 1500, lr: float = 3e-3,
        device=None, log=print) -> dict:
    """The fixture, the anchored windows and the two models on ``device``
    (None = the card)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fix = make_fixture(hits, dev)
    n_train = len(fix.train_a[0])
    log(f"fixture {hits} hits; train {n_train} x4-aug windows, val "
        f"{fix.val_mask.sum()}, test {fix.test_mask.sum()} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    anch = anchored_serving_windows(fix.audio, fix.onsets[fix.test_mask],
                                    PRE, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_anch = time.perf_counter() - t0
    if anch["missed"]:
        log(f"anchored extraction: {anch['missed']} test hits undetected "
            "(fell back to labelled onsets)")
    res = evaluate(fix, anch["windows"], epochs, lr, dev, log)
    res["seconds"]["anchored"] = t_anch
    res.update(fixture=fix, anchored=anch)
    return res


def gate(res: dict) -> tuple[bool, bool]:
    """``(anch_ok, legacy_ok)``: the anchored gather closes the jitter gap
    (within 1.1x of exact, no serve-matched augmentation), and the
    matched augmentation mitigates the block-aligned mode."""
    anch_ok = res["a_anch"] < 1.1 * res["a_exact"]
    legacy_ok = (res["b_serv"] < 2.0 * res["a_exact"]
                 and res["b_serv"] < res["floor"] / 4.0)
    return anch_ok, legacy_ok


def report(res: dict, log=print) -> None:
    """The demo's table of the four test L1 rows and the floor."""
    log(f"{'path':<42}{'test L1 (cm)':>14}")
    for label, key in (("A: exact train  -> exact eval", "a_exact"),
                       ("A: exact train  -> ANCHORED serving eval",
                        "a_anch"),
                       ("A: exact train  -> block-aligned eval", "a_serv"),
                       ("B: matched aug  -> block-aligned eval", "b_serv")):
        log(f"{label:<42}{res[key]:>14.3f}")
    log(f"(predict-mean floor {res['floor']:.2f} cm)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--hits", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.hits, args.epochs, args.lr,
              "cpu" if args.cpu else None)
    print()
    report(res)
    print(f"total {time.perf_counter() - t0:.1f} s")
    anch_ok, legacy_ok = gate(res)
    if not anch_ok:
        print(f"anchored gate FAILED: {res['a_anch']:.3f} >= 1.1 x "
              f"{res['a_exact']:.3f}")
    ok = anch_ok and legacy_ok
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
