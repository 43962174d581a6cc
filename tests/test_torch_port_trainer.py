"""``Trainer.fit`` against the JAX package's: the same init (flax's, carried
across), the same data, the same optimizer chain with clip 1.0 and warm
restarts.  A narrow CCCNN (3 layers, its stack through K3's Function with
the plain forward) and a CNN with xent; full batch, mini batch and
``epochs_per_step=5``; early stopping, a continued fit, the best state
restored, predictions and checkpoints.  Bar: the same history within 1e-4
and the same stopping epoch.

The CCCNN runs use sgd (the CNN's nadam, the trainer's default): a few of
the normalised-CC head's features are correlations at lags where the maps
hardly overlap, rounding residue of ~1e-9 that differs between the two
packages' DFT products.  Their weights' gradients are residue too, and
adam divides a gradient by its own size, so one step moves such a weight
by up to the learning rate in either package's own direction.  sgd keeps
a residue a residue.  The optimizers themselves are held to optax on
fixed gradients (tests/test_torch_port_optim.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import TrainConfig as JTrainConfig
from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.models.cnn import CNN as JCNN
from onset_fingerprinting_tpu.models.train import Trainer as JTrainer
from onset_fingerprinting_torch.core.config import TrainConfig
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.cnn import CNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
    cnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.models.train import Trainer

NARROW = dict(output_size=2, channels=3, layer_sizes=(4, 4, 3),
              kernel_sizes=(5, 3, 1), dropout_rate=0.0, cc_impl="dft",
              cc_norm=True)
ZONES = dict(output_size=4, layer_sizes=(4, 6), kernel_size=5, pool=True,
             batch_norm=True, dropout_rate=0.0)


def regression_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (40, 3, 48)).astype(np.float32)
    y = rng.normal(0, 1, (40, 2)).astype(np.float32)
    return (x[:30], y[:30]), (x[30:], y[30:])


def zone_data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (36, 3, 32)).astype(np.float32)
    y = rng.integers(0, 4, 36).astype(np.int32)
    x[np.arange(36), y % 3, :4] += 2.0  # a learnable cue
    return (x[:28], y[:28]), (x[28:], y[28:])


def pair(kind, **cfg_kw):
    """(JAX trainer, port trainer) on the CPU, and the port's state started
    from the JAX trainer's init."""
    cfg = dict(dict(lr=1e-2, num_epochs=40, min_epochs=5, patience=3,
                    seed=0), **cfg_kw)
    if kind == "cccnn":
        jm, tm, conv = JCCCNN(**NARROW), CCCNN(48, **NARROW), \
            cccnn_state_dict_from_flax
        x0 = np.zeros((1, 3, 48), np.float32)
    else:
        jm, tm, conv = JCNN(**ZONES), CNN(32, 3, **ZONES), \
            cnn_state_dict_from_flax
        x0 = np.zeros((1, 3, 32), np.float32)
    jt = JTrainer(jm, JTrainConfig(**cfg))
    tt = Trainer(tm, TrainConfig(**cfg), device="cpu")
    jstate = jt.init_state(jnp.asarray(x0))
    tstate = tt.init_state()
    tstate.module.load_state_dict(conv(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats})))
    return jt, tt, jstate, tstate, conv


def assert_same_run(jt, tt, jstate, tstate, conv):
    for key in ("train_loss", "val_loss"):
        assert len(tt.history[key]) == len(jt.history[key]), key
        np.testing.assert_allclose(tt.history[key], jt.history[key],
                                   atol=1e-4, err_msg=key)
    want = conv(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    for name, v in tstate.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["full", "mini", "scanned"])
def test_fit_cccnn_matches_jax(mode):
    train, val = regression_data()
    jt, tt, js, ts, conv = pair(
        "cccnn", loss="l1", optimizer="sgd", lr=0.05,
        batch_size=8 if mode == "mini" else None)
    k = 5 if mode == "scanned" else 1
    js = jt.fit(train, val, epochs_per_step=k, state=js)
    ts = tt.fit(train, val, epochs_per_step=k, state=ts)
    assert_same_run(jt, tt, js, ts, conv)
    # early stopping acted: fewer epochs ran than the budget
    assert len(tt.history["train_loss"]) < 40 * (3 if mode == "mini" else 1)
    assert tt.best_loss == pytest.approx(jt.best_loss, abs=1e-4)
    np.testing.assert_allclose(tt.predict(ts, val[0]),
                               jt.predict(js, val[0]), atol=1e-4)
    assert tt.test(ts, val) == pytest.approx(jt.test(js, val), abs=1e-4)


@pytest.mark.parametrize("mode", ["full", "mini"])
def test_fit_cnn_xent_matches_jax(mode):
    train, val = zone_data()
    jt, tt, js, ts, conv = pair(
        "cnn", loss="xent", batch_size=8 if mode == "mini" else None)
    js = jt.fit(train, val, state=js)
    ts = tt.fit(train, val, state=ts)
    assert_same_run(jt, tt, js, ts, conv)
    assert tt.accuracy(ts, val) == jt.accuracy(js, val)


def test_continued_fit_matches_jax():
    """Two chunks threaded through ``state=``, as ``run_location_hpo``
    does; no validation set (the monitor is the train loss)."""
    train, _ = regression_data(2)
    jt, tt, js, ts, conv = pair("cccnn", loss="mse", optimizer="sgd",
                                patience=100)
    for _ in range(2):
        js = jt.fit(train, num_epochs=6, state=js, epochs_per_step=3)
        ts = tt.fit(train, num_epochs=6, state=ts, epochs_per_step=3)
    assert_same_run(jt, tt, js, ts, conv)
    assert ts.step == int(js.step)


def test_best_state_is_a_copy_restored_at_the_end():
    """With a rate that makes the validation loss climb, the returned state
    holds the best epoch's weights, not the last epoch's."""
    train, val = regression_data(3)
    tt = Trainer(CCCNN(48, **NARROW),
                 TrainConfig(lr=0.3, num_epochs=12, patience=20, seed=0,
                             optimizer="adam", grad_clip=0.0), device="cpu")
    state = tt.fit(train, val)
    best = int(np.argmin(tt.history["val_loss"]))
    assert best < len(tt.history["val_loss"]) - 1
    assert state.step == best + 1
    assert tt._eval_loss(state, *map(tt._tensor, val)) == pytest.approx(
        tt.history["val_loss"][best], abs=1e-6)


def test_checkpoint_round_trip(tmp_path):
    train, val = regression_data()
    tt = Trainer(CNN(48, 3, layer_sizes=(3,), batch_norm=True,
                     dropout_rate=0.0),
                 TrainConfig(num_epochs=3, seed=1), device="cpu")
    state = tt.fit(train)
    tt.save_checkpoint(state, tmp_path / "m.pt")
    back = tt.load_checkpoint(tmp_path / "m.pt")
    for a, b in zip(state.module.state_dict().values(),
                    back.module.state_dict().values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tt.predict(back, val[0]),
                                  tt.predict(state, val[0]))
    assert back.optimizer.count == 0


def test_init_state_is_seeded_and_dropout_uses_its_generator():
    m = CCCNN(48, **dict(NARROW, dropout_rate=0.5))
    a = Trainer(m, TrainConfig(seed=4), device="cpu").init_state()
    b = Trainer(m, TrainConfig(seed=4), device="cpu").init_state()
    for u, v in zip(a.module.state_dict().values(),
                    b.module.state_dict().values()):
        assert torch.equal(u, v)
    x = torch.randn(4, 3, 48, generator=torch.Generator().manual_seed(0))
    a.module.train()
    assert torch.equal(a.module(x, generator=a.generator),
                       b.module.train()(x, generator=b.generator))
    with pytest.raises(ValueError, match="generator"):
        a.module(x)
