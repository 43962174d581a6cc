"""Location-model training with hyperparameter search (port of
``onset_fingerprinting_tpu.models.experiment``, JAX experiment.py:25-190):
load an MCPOSD session, train CCCNN location regressors full batch under a
random-search study with median pruning, report the best ``hp_metric``.

Run: python -m onset_fingerprinting_torch.models.experiment <folder> <name>
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from onset_fingerprinting_torch.core.config import TrainConfig
from onset_fingerprinting_torch.data.datasets import MCPOSD
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.hpo import Study, Trial, TrialPruned
from onset_fingerprinting_torch.models.train import Trainer, make_optimizer

#: the flagship conv schedule (reference train.py:79-90)
FLAGSHIP_KERNELS = (1, 33, 64, 15, 15, 15, 1)
FLAGSHIP_PADDING = 1


def flagship_conv_output_length(w: int) -> int:
    """Conv-stack output length V for a window of ``w`` samples: each
    stride-1 layer maps ``t -> t + 2*padding - k + 1`` (V = 133 at w =
    256), clamped at 0 as flax's conv is."""
    v = w
    for k in FLAGSHIP_KERNELS:
        v = max(v + 2 * FLAGSHIP_PADDING - k + 1, 0)
    return v


def build_cccnn(trial: Optional[Trial] = None, channels: int = 4,
                cc_pairs: Optional[str] = None,
                cc_pair_lags: Optional[int] = None,
                search_pairs: bool = False, w: int = 256) -> CCCNN:
    """The reference's HPO-winning skeleton (train.py:79-90): 7 conv layers
    of width 5, kernels [1, 33, 64, 15, 15, 15, 1], GroupNorm after each,
    the normalised-CC head; dropout searched when a trial is given.
    ``cc_pairs``/``cc_pair_lags`` add the pair-CC features;
    ``search_pairs=True`` lets the trial choose the pair mode."""
    dropout = trial.suggest_float("dropout", 0.0, 0.1) if trial else 0.0
    if search_pairs and trial is not None:
        cc_pairs = trial.suggest_categorical(
            "cc_pairs", [None, "adjacent", "all"])
    if cc_pairs is not None:
        v = flagship_conv_output_length(w)
        if v < 2:
            # no feature positions to correlate: the self-CC head instead
            cc_pairs = None
            cc_pair_lags = None
        elif cc_pair_lags is None:
            # the physical TDOA range (~112 lags at 96 kHz), inside V
            cc_pair_lags = min(112, v - 1)
    return CCCNN(
        input_size=w,
        output_size=2,
        channels=channels,
        layer_sizes=[5] * 7,
        kernel_sizes=list(FLAGSHIP_KERNELS),
        dropout_rate=dropout,
        batch_norm=True,
        group=False,
        cc_norm=True,
        cc_pairs=cc_pairs,
        cc_pair_lags=cc_pair_lags,
    )


def run_location_hpo(folder: str | Path, name: str, w: int = 256,
                     channels: int = 4, pre_samples: int = 8,
                     n_trials: int = 3, num_epochs: int = 1000,
                     min_epochs: int = 100, patience: int = 500,
                     subsample: int = 8, seed: int = 0, mesh=None,
                     sampler: str = "tpe", search_pairs: bool = False,
                     device=None) -> Study:
    """MCPOSD load → hit-level train / val / test split → HPO study over
    CCCNN configurations → the best validation L1, the selected trial's
    test L1 as its user attribute ``test_l1`` (train.py:22-145 of the
    reference).  ``mesh`` trains each trial data parallel over its
    ``data`` axis (``Trainer(mesh=)``)."""
    dataset = MCPOSD.from_file(folder, name, w, pre_samples, 16, 4,
                               device=device)
    train_ds, eval_ds = dataset.split_hits(0.8, seed=seed)
    x, y = train_ds[0]
    train = (x[::subsample], y[::subsample])
    # eval_ds extracts held-out hits once: its window split is a hit split
    val_ds, test_ds = eval_ds.split(0.5, seed=seed)
    val = (val_ds.x, val_ds.y)
    test = (test_ds.x, test_ds.y)
    study = Study(seed=seed, sampler=sampler)

    def objective(trial: Trial) -> float:
        model = build_cccnn(trial, channels, search_pairs=search_pairs, w=w)
        lr = trial.suggest_float("lr", 3e-4, 1e-2, log=True)
        cfg = TrainConfig(lr=lr, num_epochs=num_epochs,
                          min_epochs=min_epochs, patience=patience,
                          loss="l1", seed=seed + trial.number,
                          optimizer="adam")
        trainer = Trainer(model, cfg, optimizer=make_optimizer(
            "adam", lr, schedule="cosine", schedule_period=100),
            device=device, mesh=mesh)
        # a pruning check every 10% of the budget; training continues
        # across the chunks (the state threaded through)
        chunk = max(num_epochs // 10, 1)
        state = None
        for step in range(10):
            state = trainer.fit(train, val, num_epochs=chunk, state=state,
                                epochs_per_step=chunk)
            trial.report(trainer.history["val_loss"][-1], step)
            if trial.should_prune():
                raise TrialPruned()
        # selection sees the validation metric only; the test metric rides
        # along for the selected trial
        trial.set_user_attr("test_l1", trainer.test(state, test))
        return trainer.test(state, val)

    study.optimize(objective, n_trials=n_trials, catch=(RuntimeError,))
    return study


if __name__ == "__main__":  # pragma: no cover - CLI
    folder, name = sys.argv[1], sys.argv[2]
    study = run_location_hpo(folder, name)
    print("best val L1:", study.best_value)
    print("test L1 of selected trial:",
          study.best_trial.user_attrs.get("test_l1"))
    print("best params:", study.best_params)
