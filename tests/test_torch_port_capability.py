"""The slice as a whole: the fingerprint-capability tool at 48 hits and 30
epochs against the JAX package's demo (examples/fingerprint_capability_
demo.py) on the same fixture, with flax's inits carried across.

The fixture is JAX's (its training windows carry ``jax.random`` shifts the
port cannot draw); the validation and test windows, which have no shift,
are also the port's own ``make_fixture`` bit for bit.  The predict-the-mean
floor and the lags are exact, the three CCCNNs' test L1 within 1e-4
relative.  The lag-FCNN's within 10% (``FCNN_RTOL``; 4.6% measured): the
Dense biases in front of its BatchNorms have a gradient of 0 in exact
arithmetic and a rounding residue in each package, which adam, dividing a
gradient by its own size, turns into steps of its own in each; the norms'
running means follow those biases into the eval-mode predictions.
tests/test_torch_port_calibration_train.py holds the same loop to 1e-4
with the BatchNorms left out."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import TrainConfig as JTrainConfig
from onset_fingerprinting_tpu.data.datasets import MCPOSD as JMCPOSD
from onset_fingerprinting_tpu.data.synth import (
    synth_location_session as jsynth,
)
from onset_fingerprinting_tpu.locate.calibration import (
    train_location_model as jtrain_location_model,
)
from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.models.experiment import (
    build_cccnn as jbuild_cccnn,
)
from onset_fingerprinting_tpu.models.fcnn import FCNN as JFCNN
from onset_fingerprinting_tpu.models.train import Trainer as JTrainer
from onset_fingerprinting_tpu.models.train import (
    make_optimizer as jmake_optimizer,
)
from onset_fingerprinting_tpu.ops.xcorr import batch_full_correlate
from onset_fingerprinting_torch.locate import calibration as tcal
from onset_fingerprinting_torch.models import train as ttrain
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.fcnn import FCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
    fcnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.tools import fingerprint_capability as tool
from onset_fingerprinting_torch.workload import FLAGSHIP

HITS, EPOCHS, LR = 48, 30, 3e-3
FCNN_RTOL = 0.1


def jax_pair_lags(x):
    """The demo's ``pair_lags``."""
    xj = jnp.asarray(x)
    c = x.shape[1]
    feats = [jnp.argmax(batch_full_correlate(xj[:, i], xj[:, j]), axis=-1)
             - (x.shape[-1] - 1) for i in range(c) for j in range(i + 1, c)]
    return np.asarray(jnp.stack(feats, axis=-1), np.float32)


MODEL_NAMES = ("cccnn", "paired", "flagship_f32")


def jax_models():
    return {
        "cccnn": jbuild_cccnn(None, channels=4),
        "paired": jbuild_cccnn(None, channels=4, cc_pairs="all",
                               cc_pair_lags=112),
        "flagship_f32": JCCCNN(conv_impl="conv", **FLAGSHIP),
    }


def jax_capability(folder, hits, epochs, models=("fcnn", *MODEL_NAMES),
                   epochs_per_step=None):
    """The JAX demo's steps on the CPU: its fixture (written to ``folder``),
    the mean floor and each of ``models`` trained from JAX's seed 0.
    ``epochs_per_step`` (default the demo's ``epochs // 10``) sets the
    CCCNNs' validation chunks.  Returns ``(results, inits, arrays)``:
    test L1 per model, each model's init as the port's ``state_dict`` and
    the fixture's ``(x_train, y_train, val, test)``."""
    jsynth(folder, n_hits=hits, sr=tool.SR, seed=0)
    full = JMCPOSD.from_file(folder, "combined0", tool.W, 8, 16, 4)
    train_ds, eval_ds = full.split_hits(0.75, seed=1)
    xt, yt = (np.asarray(a) for a in train_ds[0])
    val_ds, test_ds = eval_ds.split(0.5, seed=1)
    val = (np.asarray(val_ds.x), np.asarray(val_ds.y))
    test = (np.asarray(test_ds.x), np.asarray(test_ds.y))
    jres = {"mean": float(np.mean(np.abs(yt.mean(axis=0) - test[1])))}
    inits = {}
    if "fcnn" in models:
        lags_t = jax_pair_lags(xt)
        bundle, _ = jtrain_location_model(
            lags_t, yt, lr=1e-2, num_epochs=epochs, patience=epochs,
            epochs_per_step=100, hidden_layers=[64, 64])
        jres["fcnn"] = float(np.mean(np.abs(np.asarray(
            bundle(jnp.asarray(jax_pair_lags(test[0])))) - test[1])))
        inits["fcnn"] = fcnn_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, JFCNN(output_size=2, hidden_layers=[64, 64]).init(
                jax.random.PRNGKey(0), jnp.asarray(lags_t), train=False)))
    cfg = JTrainConfig(lr=LR, num_epochs=epochs, min_epochs=0,
                       patience=epochs, loss="l1", seed=0, optimizer="adam")
    for name, model in jax_models().items():
        if name not in models:
            continue
        tr = JTrainer(model, cfg, optimizer=jmake_optimizer(
            "adam", LR, schedule="cosine", schedule_period=100))
        init = tr.init_state(jnp.asarray(xt))
        inits[name] = cccnn_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, {"params": init.params}))
        state = tr.fit((xt, yt), val, state=init,
                       epochs_per_step=epochs_per_step
                       or max(epochs // 10, 1))
        jres[name] = tr.test(state, test)
    return jres, inits, (xt, yt, val, test)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The demo's steps in JAX, then the tool's ``train_models`` on JAX's
    fixture from JAX's inits."""
    jres, inits, (xt, yt, val, test) = jax_capability(
        tmp_path_factory.mktemp("capability"), HITS, EPOCHS)
    lags_t = jax_pair_lags(xt)

    def flax_init(module, seed, device):
        if isinstance(module, FCNN):
            sd = inits["fcnn"]
        elif not module.fused:
            sd = inits["paired" if module.pairs else "cccnn"]
        else:
            sd = inits["flagship_f32"]
        module.load_state_dict(sd)
        return module.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(tcal, "init_module", flax_init)
    mp.setattr(ttrain, "init_module", flax_init)
    try:
        fix = tool.Fixture(*(torch.as_tensor(a) for a in (xt, yt)),
                           tuple(map(torch.as_tensor, val)),
                           tuple(map(torch.as_tensor, test)))
        tres = tool.train_models(fix, EPOCHS, LR, device="cpu",
                                 log=lambda *a: None)
    finally:
        mp.undo()
    tres["mean"] = tool.l1_cm(fix.y_train.mean(dim=0), fix.test[1])
    own = tool.make_fixture(HITS, device="cpu")
    return dict(jax=jres, port=tres, fix=fix, own=own, lags=lags_t)


def test_fixture_and_floor_match_jax(runs):
    fix, own = runs["fix"], runs["own"]
    for a, b in zip((*own.val, *own.test), (*fix.val, *fix.test)):
        assert torch.equal(a, b)
    assert torch.equal(own.y_train, fix.y_train)
    assert own.x_train.shape == fix.x_train.shape
    assert runs["port"]["mean"] == pytest.approx(runs["jax"]["mean"],
                                                 rel=1e-6)
    np.testing.assert_array_equal(tool.pair_lags(fix.x_train).numpy(),
                                  runs["lags"])


@pytest.mark.parametrize("name", tool.MODELS)
def test_trained_model_matches_jax(runs, name):
    got, want = runs["port"][name], runs["jax"][name]
    assert np.isfinite(got)
    rtol = FCNN_RTOL if name == "fcnn" else 1e-4
    assert got == pytest.approx(want, rel=rtol), (got, want)


def test_forwards_and_bars(runs):
    res = runs["port"]
    for name in ("cccnn", "paired", "flagship_f32"):
        # one seed: 30 steps, 10 validation passes, the test
        assert res["forwards"][name] == EPOCHS + 10 + 1
        assert res["runs"][name] == [res[name]]
    met = tool.bars(dict(res, cccnn=0.3 * res["mean"],
                         fcnn=0.5 * res["mean"], paired=0.31 * res["mean"],
                         flagship_f32=0.1 * res["mean"]))
    assert all(ok for _, ok in met)
    assert not tool.bars(dict(res, cccnn=0.5 * res["mean"]))[0][1]


def test_bars_read_the_median_over_seeds(monkeypatch):
    """Each CCCNN trains once per seed; its result is the median."""
    fix = tool.make_fixture(8, device="cpu")
    calls = []

    def fake_fit(self, train, val, epochs_per_step=1):
        calls.append(self.cfg.seed)
        self.history["train_loss"].append(0.0)
        state = self.init_state()
        state.module.fc.bias.data.fill_(float(self.cfg.seed))
        return state

    monkeypatch.setattr(ttrain.Trainer, "fit", fake_fit)
    res = tool.train_models(fix, epochs=2, device="cpu", seeds=(3, 0, 7),
                            log=lambda *a: None)
    assert calls == [3] * 3 + [0] * 3 + [7] * 3
    for name in ("cccnn", "paired", "flagship_f32"):
        assert len(res["runs"][name]) == 3
        assert res[name] == sorted(res["runs"][name])[1]
        assert res["forwards"][name] == 3 * (1 + 0 + 1)



if __name__ == "__main__":
    # the JAX package's capability results on the CPU at any size, e.g.
    # the fifth model's bar (tools/fingerprint_capability.py):
    #   python -m tests.test_torch_port_capability --hits 768 --epochs 200 \
    #       --epochs-per-step 200 --models flagship_f32
    # (optax's cosine decay leaves the CCCNNs' rate at 0 after 100
    # updates, so one chunk of 200 epochs ends at the 2000-epoch demo's
    # state)
    import argparse
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--hits", type=int, default=768)
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--epochs-per-step", type=int, default=None)
    ap.add_argument("--models", nargs="+", default=["fcnn", *MODEL_NAMES])
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as td:
        res = jax_capability(td, args.hits, args.epochs, args.models,
                             args.epochs_per_step)[0]
    for name, v in res.items():
        print(f"{name:<14}{v:.4f} cm ({v / res['mean']:.4f} x mean)")
