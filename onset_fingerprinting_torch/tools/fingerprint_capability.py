"""Fingerprinting capability: learned location models must beat
predict-the-mean by a wide margin on a physically learnable fixture (port
of examples/fingerprint_capability_demo.py).

The fixture is the modal-drum synthesiser's session (``data.synth``: each
sensor's waveform content varies with the hit position), split at hit
level (``MCPOSD.split_hits(0.75, seed=1)``): training windows are 4
extractions of each training hit with random shifts of up to 16 samples,
the held-out hits are extracted once and halved into validation and test.
Five results on the same fixture:

1. predict-the-mean, the floor;
2. lag-FCNN: CC argmax lags of every sensor pair → FCNN
   (``train_location_model``);
3. the flagship CCCNN of ``build_cccnn`` (GroupNorm after every layer, so
   its conv stack is the plain conv chain);
4. the same with pair-CC features (``cc_pairs="all"``, ±112 lags);
5. the fleet flagship in float32 (``workload.FLAGSHIP``: no GroupNorm, the
   DFT head), whose fused conv stack runs kernel K3 in every forward.

The bars are the demo's (``cccnn < 0.35 mean``, ``fcnn < 0.6 mean``,
``paired < 1.15 cccnn``) and, for the fifth, ``FLAGSHIP_F32_BAR``, set from
what the JAX package's same model reaches on this fixture.  They
read the median over the CCCNNs' init seeds (``SEEDS``), where the demo
trains seed 0 once: one seed's result moves by up to 3.5x between seeds
(the self-CC CCCNN from 0.60 to 2.08 cm over seeds 0-5 on the card), so a
one-seed bar gates the draw more than the model.  The lag-FCNN's init is
seed 0's, as in the JAX package.

With optax's cosine decay over 100 updates the CCCNNs' rate is 0 from the
101st update on: their weights stop there, whatever the epochs.

Run: python -m onset_fingerprinting_torch.tools.fingerprint_capability
[--cpu] [--hits N] [--epochs N] [--seeds N]
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

from onset_fingerprinting_torch.core.config import TrainConfig
from onset_fingerprinting_torch.data.datasets import MCPOSD
from onset_fingerprinting_torch.data.synth import synth_location_session
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate.calibration import train_location_model
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.experiment import build_cccnn
from onset_fingerprinting_torch.models.train import Trainer, make_optimizer
from onset_fingerprinting_torch.ops.xcorr import batch_full_correlate
from onset_fingerprinting_torch.workload import FLAGSHIP

SR = 96000
W = 256
#: the fifth model's bar, a fraction of predict-the-mean: the JAX package's
#: same model on the CPU reaches 2.1309 cm = 0.3186 x mean on this fixture
#: (its seed 0, the demo's protocol; tests/test_torch_port_capability.py run
#: as a module); the bar keeps the demo's own margin over what it measured
#: for the CCCNN (0.35 over 0.281, 1.25x)
FLAGSHIP_F32_BAR = 0.40
#: the CCCNNs' init seeds; the bars read the median over them
SEEDS = (0, 1, 2, 3, 4)
MODELS = ("fcnn", "cccnn", "paired", "flagship_f32")


@dataclass
class Fixture:
    x_train: torch.Tensor
    y_train: torch.Tensor
    val: tuple
    test: tuple


def make_fixture(hits: int = 768, device=None) -> Fixture:
    """The demo's fixture on ``device`` (None = the card)."""
    with tempfile.TemporaryDirectory() as td:
        synth_location_session(Path(td), n_hits=hits, sr=SR, seed=0)
        full = MCPOSD.from_file(td, "combined0", W, 8, 16, 4, device=device)
    train_ds, eval_ds = full.split_hits(0.75, seed=1)
    x_train, y_train = train_ds[0]
    val_ds, test_ds = eval_ds.split(0.5, seed=1)
    return Fixture(x_train, y_train, (val_ds.x, val_ds.y),
                   (test_ds.x, test_ds.y))


def pair_lags(x: torch.Tensor) -> torch.Tensor:
    """CC argmax lag of every unordered channel pair: ``[N, C, W] → [N,
    P]`` float32."""
    c = x.shape[1]
    feats = [torch.argmax(batch_full_correlate(x[:, i], x[:, j]), dim=-1)
             - (x.shape[-1] - 1)
             for i in range(c) for j in range(i + 1, c)]
    return torch.stack(feats, dim=-1).to(torch.float32)


def l1_cm(pred: torch.Tensor, y: torch.Tensor) -> float:
    return float((pred - y).abs().mean())


def flagship_f32() -> CCCNN:
    """The fleet flagship in float32 (its conv stack runs K3)."""
    return CCCNN(input_size=W, dtype=torch.float32, **FLAGSHIP)


def cccnn_trainer(model, epochs: int, lr: float, device,
                  seed: int = 0) -> Trainer:
    cfg = TrainConfig(lr=lr, num_epochs=epochs, min_epochs=0,
                      patience=epochs, loss="l1", seed=seed, optimizer="adam")
    return Trainer(model, cfg, optimizer=make_optimizer(
        "adam", lr, schedule="cosine", schedule_period=100), device=device)


#: the three CCCNNs, each built anew for every seed
CCCNNS = {
    "cccnn": lambda: build_cccnn(None, channels=4, w=W),
    "paired": lambda: build_cccnn(None, channels=4, cc_pairs="all",
                                  cc_pair_lags=112, w=W),
    "flagship_f32": flagship_f32,
}


def train_models(fix: Fixture, epochs: int = 2000, lr: float = 3e-3,
                 device=None, log=print, seeds=(0,)) -> dict:
    """Train the lag-FCNN once (its init is seed 0's, as in the JAX
    package) and each CCCNN once per seed in ``seeds``.  Returns each
    model's test L1 (cm): per seed under ``"runs"`` and, under the model's
    name, the median over the seeds.  Also the training seconds, the
    number of forwards each CCCNN ran (training steps, validation passes,
    the tests) and seed ``seeds[0]``'s trainer and state."""
    res = {"seconds": {}, "trainers": {}, "forwards": {}, "steps": {},
           "runs": {name: [] for name in CCCNNS}}
    t0 = time.perf_counter()
    bundle, _ = train_location_model(
        pair_lags(fix.x_train), fix.y_train, lr=1e-2,
        num_epochs=epochs, patience=epochs, epochs_per_step=100,
        hidden_layers=[64, 64], device=device)
    res["fcnn"] = l1_cm(bundle(pair_lags(fix.test[0])), fix.test[1])
    res["seconds"]["fcnn"] = time.perf_counter() - t0
    log(f"lag-FCNN: {res['fcnn']:.4f} cm "
        f"({res['seconds']['fcnn']:.1f} s)")
    for seed in seeds:
        for name, build in CCCNNS.items():
            t0 = time.perf_counter()
            trainer = cccnn_trainer(build(), epochs, lr, device, seed)
            state = trainer.fit((fix.x_train, fix.y_train), fix.val,
                                epochs_per_step=max(epochs // 10, 1))
            res["runs"][name].append(trainer.test(state, fix.test))
            res["seconds"][name] = (res["seconds"].get(name, 0.0)
                                    + time.perf_counter() - t0)
            steps = len(trainer.history["train_loss"])
            res["steps"][name] = res["steps"].get(name, 0) + steps
            res["forwards"][name] = (res["forwards"].get(name, 0) + steps
                                     + len(trainer.history["val_loss"]) + 1)
            res["trainers"].setdefault(name, (trainer, state))
            log(f"{name} seed {seed}: {res['runs'][name][-1]:.4f} cm "
                f"({time.perf_counter() - t0:.1f} s, {steps} steps)")
    for name, runs in res["runs"].items():
        res[name] = float(np.median(runs))
    return res


def bars(res: dict) -> list[tuple[str, bool]]:
    """The capability bars on the models' (median) test L1: ``(description,
    met)``."""
    base, cc = res["mean"], res["cccnn"]
    return [
        (f"cccnn {cc:.4f} < 0.35 x mean {base:.4f}", cc < 0.35 * base),
        (f"fcnn {res['fcnn']:.4f} < 0.6 x mean", res["fcnn"] < 0.6 * base),
        (f"paired {res['paired']:.4f} < 1.15 x cccnn",
         res["paired"] < 1.15 * cc),
        (f"flagship_f32 {res['flagship_f32']:.4f} < {FLAGSHIP_F32_BAR} x "
         f"mean", res["flagship_f32"] < FLAGSHIP_F32_BAR * base),
    ]


def run(hits: int = 768, epochs: int = 2000, lr: float = 3e-3, device=None,
        log=print, seeds=SEEDS) -> dict:
    """The fixture, the mean floor and the four trained models (the CCCNNs
    once per seed)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fix = make_fixture(hits, dev)
    log(f"fixture: {hits} hits -> train {tuple(fix.x_train.shape)} val "
        f"{tuple(fix.val[0].shape)} test {tuple(fix.test[0].shape)} "
        f"({time.perf_counter() - t0:.1f} s)")
    res = {"mean": l1_cm(fix.y_train.mean(dim=0), fix.test[1]),
           "fixture": fix}
    res.update(train_models(fix, epochs, lr, dev, log, seeds))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--hits", type=int, default=768)
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seeds", type=int, default=len(SEEDS),
                    help="train each CCCNN from seeds 0..N-1")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    t0 = time.perf_counter()
    res = run(args.hits, args.epochs, args.lr, device,
              seeds=tuple(range(args.seeds)))
    print(f"\n{'model':<22}{'test L1 (cm), median':>22}  per seed")
    for name in ("mean", *MODELS):
        runs = res["runs"].get(name, [])
        print(f"{name:<22}{res[name]:>22.4f}  "
              + " ".join(f"{v:.4f}" for v in runs))
    print(f"total {time.perf_counter() - t0:.1f} s")
    ok = True
    for what, met in bars(res):
        print(f"{'met' if met else 'MISSED'}: {what}")
        ok &= met
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
