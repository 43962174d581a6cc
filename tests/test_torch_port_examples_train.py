"""The twins of the examples that train or stream, against the JAX
examples on the CPU: the two CCCNNs of ``tools/serving_window_accuracy.py``
(examples/serving_window_accuracy.py), ``tools/location_hpo.py``
(examples/hpo_demo.py), ``tools/calibration_run.py``
(examples/calibration_demo.py) and ``tools/cc_bench.py``
(examples/cc_bench.py).

Models start from flax's inits carried across
(``models/jax_import``) and train on JAX's own training windows (their
random shifts come from ``jax.random``, which the port cannot draw): the
serving CCCNNs' test L1 within 1e-4 relative of JAX's, the calibration
FCNN within ``FCNN_RTOL`` (tests/test_torch_port_capability.py: the Dense
biases in front of its BatchNorms are rounding residue that adam turns
into steps of its own in each package).  The HPO study's trial draws
equal JAX's at 2 trials (the sampler's random startup draws, which read
no objective value), the streaming CC is within 1e-4 of its scale of
JAX's, and each twin's gate runs at a small size."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.audio_io import read_wav as jread_wav
from onset_fingerprinting_tpu.core.coords import (
    spherical_to_cartesian as jspherical,
)
from onset_fingerprinting_tpu.data.datasets import MCPOSD as JMCPOSD
from onset_fingerprinting_tpu.data.synth import (
    synth_location_session as jsynth,
)
from onset_fingerprinting_tpu.locate.calibration import (
    calibration_locations as jcalibration_locations,
)
from onset_fingerprinting_tpu.locate.calibration import (
    train_location_model as jtrain_location_model,
)
from onset_fingerprinting_tpu.models import experiment as jexperiment
from onset_fingerprinting_tpu.models.fcnn import FCNN as JFCNN
from onset_fingerprinting_tpu.models.train import Trainer as JTrainer
from onset_fingerprinting_tpu.ops.xcorr import (
    streaming_cc_init as jstreaming_cc_init,
)
from onset_fingerprinting_tpu.ops.xcorr import (
    streaming_cc_update as jstreaming_cc_update,
)
from onset_fingerprinting_torch.core.audio_io import read_wav
from onset_fingerprinting_torch.locate import calibration as tcal
from onset_fingerprinting_torch.models import train as ttrain
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
    fcnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops.xcorr import (
    streaming_cc_init,
    streaming_cc_update,
)
from onset_fingerprinting_torch.tools import calibration_run as cal
from onset_fingerprinting_torch.tools import cc_bench
from onset_fingerprinting_torch.tools import location_hpo
from onset_fingerprinting_torch.tools import serving_window_accuracy as swa

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the serving CCCNNs' size here (the demo's: 512 hits, 1500 epochs)
SWA_HITS, SWA_EPOCHS, LR = 24, 4, 3e-3
#: the study's size here (the demo's: 48 hits, 2 trials x 300 epochs)
HPO_HITS, HPO_TRIALS, HPO_EPOCHS = 24, 2, 2
FCNN_RTOL = 0.1


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(*a):
    pass


# -- the serving CCCNNs ------------------------------------------------------

@pytest.fixture(scope="module")
def swa_runs(tmp_path_factory):
    """The demo's two models in JAX on JAX's extractions, then the twin's
    ``evaluate`` on the same arrays from flax's init."""
    demo = load_example("serving_window_accuracy")
    folder = tmp_path_factory.mktemp("swa")
    onsets, locs = jsynth(folder, n_hits=SWA_HITS, sr=swa.SR, seed=0)
    onsets, locs = np.asarray(onsets), np.asarray(locs)
    ds_a = JMCPOSD.from_file(folder, "combined0", swa.W, 8, 16, 4)
    ds_b = JMCPOSD.from_file(folder, "combined0", swa.W, 128, 64, 4)
    exact = JMCPOSD.from_file(folder, "combined0", swa.W, 8, 0, 1)
    audio = np.asarray(jread_wav(folder / "combined0.wav")[0])
    val_mask, test_mask = swa.split_masks(SWA_HITS)
    keep = np.tile(~(val_mask | test_mask), 4)
    xa, ya = (np.asarray(v) for v in ds_a[0])
    xb, yb = (np.asarray(v) for v in ds_b[0])
    ex, ey = np.asarray(exact.x), np.asarray(exact.y)
    fix = swa.Fixture(
        audio, onsets, locs, val_mask, test_mask, (xa[keep], ya[keep]),
        (xb[keep], yb[keep]), (ex[val_mask], ey[val_mask]),
        (demo.serving_windows(audio, onsets[val_mask]), locs[val_mask]),
        ex[test_mask], demo.serving_windows(audio, onsets[test_mask]))
    # anchored windows two samples late: a detector's timing error
    x_anch = np.transpose(audio[(onsets[test_mask] - 6)[:, None]
                                + np.arange(swa.W)], (0, 2, 1)).copy()
    y_test = locs[test_mask]
    # the inits the demo's two trainers draw, recorded as they are drawn
    # (compiled once, not op by op)
    jinits = []

    def recording(self, x):
        jinits.append(jax.jit(lambda x: init_state(self, x))(x))
        return jinits[-1]

    init_state = JTrainer.init_state
    mp = pytest.MonkeyPatch()
    mp.setattr(JTrainer, "init_state", recording)
    try:
        tr_a, st_a = demo.train_cccnn(xa[keep], ya[keep], fix.val_a,
                                      SWA_EPOCHS, LR)
        tr_b, st_b = demo.train_cccnn(xb[keep], yb[keep], fix.val_b,
                                      SWA_EPOCHS, LR)
    finally:
        mp.undo()
    # the demo's test L1 (``Trainer.test``: mean |out - y|, op by op)
    # through the trainers' compiled L1 evaluation, the same formula
    ev_a, ev_b = tr_a.make_eval_step(), tr_b.make_eval_step()
    jres = dict(a_exact=float(ev_a(st_a, fix.x_exact, y_test)),
                a_serv=float(ev_a(st_a, fix.x_serv, y_test)),
                a_anch=float(ev_a(st_a, x_anch, y_test)),
                b_serv=float(ev_b(st_b, fix.x_serv, y_test)),
                b_exact=float(ev_b(st_b, fix.x_exact, y_test)))
    sds = [cccnn_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": init.params})) for init in jinits]

    def flax_init(module, seed, device):
        module.load_state_dict(sds.pop(0))
        return module.to(device)

    mp.setattr(ttrain, "init_module", flax_init)
    try:
        tres = swa.evaluate(fix, x_anch, SWA_EPOCHS, LR, device="cpu",
                            log=quiet)
    finally:
        mp.undo()
    assert len(jinits) == 2 and not sds
    return dict(jax=jres, port=tres, fix=fix)


@pytest.mark.parametrize("key", ["a_exact", "a_anch", "a_serv", "b_serv",
                                 "b_exact"])
def test_swa_models_match_jax(swa_runs, key):
    got, want = swa_runs["port"][key], swa_runs["jax"][key]
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-4), (got, want)


def test_swa_floor_steps_and_gate(swa_runs):
    res, fix = swa_runs["port"], swa_runs["fix"]
    keep = ~(fix.val_mask | fix.test_mask)
    want = np.mean(np.abs(fix.locs[keep].mean(axis=0)[None]
                          - fix.locs[fix.test_mask]))
    assert res["floor"] == pytest.approx(float(want), rel=1e-6)
    assert res["steps"] == 2 * SWA_EPOCHS
    anch_ok, legacy_ok = swa.gate(res)
    assert anch_ok == (res["a_anch"] < 1.1 * res["a_exact"])
    assert legacy_ok == (res["b_serv"] < 2.0 * res["a_exact"]
                         and res["b_serv"] < res["floor"] / 4.0)
    good = dict(res, a_exact=1.0, a_anch=1.05, b_serv=1.5, floor=8.0)
    assert swa.gate(good) == (True, True)
    assert swa.gate(dict(good, a_anch=1.2)) == (False, True)
    assert swa.gate(dict(good, b_serv=2.1)) == (True, False)


# -- the HPO study -----------------------------------------------------------

def test_hpo_fixtures_match_the_demo(tmp_path):
    demo = load_example("hpo_demo")
    for fixture in ("modal", "airlag"):
        port, ref = tmp_path / f"port_{fixture}", tmp_path / f"jax_{fixture}"
        port.mkdir(), ref.mkdir()
        location_hpo.write_fixture(port, fixture, HPO_HITS)
        if fixture == "modal":
            jsynth(ref, n_hits=HPO_HITS, sr=location_hpo.SR, seed=0)
        else:
            demo.synth_session(ref, n_hits=HPO_HITS)
        np.testing.assert_array_equal(
            read_wav(port / "combined0.wav")[0],
            read_wav(ref / "combined0.wav")[0])
        hits = [(p / "combined0.json").read_text() for p in (port, ref)]
        if fixture == "modal":
            assert hits[0] == hits[1]


class UntrainedJaxTrainer:
    """JAX's trainer in ``run_location_hpo`` with its training taken out:
    the study's first ``n_startup_trials`` (2) draws are uniform-random
    and read no objective value, so JAX's study draws the same params
    without training (the trained study is held to the port's in
    tests/test_torch_port_experiment.py)."""

    def __init__(self, *args, **kwargs):
        self.history = {"val_loss": [1.0]}

    def fit(self, *args, **kwargs):
        return None

    def test(self, state, data):
        return 1.0


def test_hpo_trials_match_jax(tmp_path, monkeypatch):
    """The twin's study against JAX's on JAX's session: the same trial
    draws (the sampler's startup trials), every trial complete, the gate
    met."""
    res = location_hpo.run(HPO_TRIALS, HPO_EPOCHS, HPO_HITS, device="cpu",
                           log=quiet)
    jsynth(tmp_path, n_hits=HPO_HITS, sr=location_hpo.SR, seed=0)
    monkeypatch.setattr(jexperiment, "Trainer", UntrainedJaxTrainer)
    study = jexperiment.run_location_hpo(
        tmp_path, "combined0", w=256, channels=4, pre_samples=8,
        n_trials=HPO_TRIALS, num_epochs=HPO_EPOCHS, min_epochs=0,
        patience=HPO_EPOCHS, subsample=1, sampler="tpe")
    got = [t.params for t in res["study"].results]
    want = [t.params for t in study.results]
    assert got == want and len(got) == HPO_TRIALS
    assert study.n_startup_trials >= HPO_TRIALS
    assert res["states"] == [t.state for t in study.results]
    assert location_hpo.gate(res)
    assert np.isfinite(res["study"].best_trial.user_attrs["test_l1"])


# -- calibration -------------------------------------------------------------

def demo_geometry():
    """The demo's true sensors and sounds (calibration_demo.py:42-56), on
    JAX's coords."""
    radius = cal.RADIUS
    sensors = np.array([
        tuple(map(float, jspherical(*p)))
        for p in [(0.8 * radius, 135, 80), (0.8 * radius, 15, 60),
                  (0.15, 100, 20)]])
    sounds = np.asarray([(0.0, 0.0, 0.0)] * 4 + [
        tuple(map(float, jspherical(*p)))
        for p in jcalibration_locations(10, 4, radius * 0.9, 0)])
    return sensors, sounds


@pytest.fixture(scope="module")
def calibration():
    """The twin's stage 3 on the CPU from flax's init, and JAX's on the
    same lags (the demo's 3000 epochs; patience 500 stops both at the same
    epoch)."""
    fix = cal.make_fixture()
    lags = cal.lag_features(fix)
    jmodel, jerrors = jtrain_location_model(
        lags, fix.sounds, lr=0.01, num_epochs=3000, patience=500,
        hidden_layers=[32, 32], batch_norm=True)
    jpreds = np.asarray(jmodel(jnp.asarray(lags, jnp.float32)))
    sd = fcnn_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, JFCNN(output_size=2, hidden_layers=[32, 32],
                          batch_norm=True).init(
            jax.random.PRNGKey(0), jnp.asarray(lags, jnp.float32),
            train=False)))

    def flax_init(module, seed, device):
        module.load_state_dict(sd)
        return module.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(tcal, "init_module", flax_init)
    try:
        s3 = cal.stage_3(fix, "cpu")
    finally:
        mp.undo()
    return dict(fix=fix, stage3=s3, jpreds=jpreds, jerrors=jerrors)


def test_calibration_fixture_matches_the_demo(calibration):
    fix = calibration["fix"]
    sensors, sounds = demo_geometry()
    for port, ref in ((fix.sensors, sensors), (fix.sounds, sounds)):
        assert port.shape == ref.shape
        assert np.all(np.abs(np.float32(port) - np.float32(ref))
                      <= np.spacing(np.abs(np.float32(ref))))
    dists = np.linalg.norm(fix.sounds[:, None] - fix.sensors[None],
                           axis=-1) / cal.C_SOUND
    np.testing.assert_array_equal(fix.tdoa, np.diff(dists, axis=1))
    np.testing.assert_array_equal(fix.onsets[:, 0], 0.0)
    assert fix.onsets.shape == (44, 3)


def test_calibration_stage3_matches_jax(calibration):
    s3, jpreds = calibration["stage3"], calibration["jpreds"]
    sounds = calibration["fix"].sounds
    jerr = float(np.linalg.norm(jpreds - sounds[:, :2], axis=1).mean()
                 * 1000)
    assert s3["err_mm"] == pytest.approx(jerr, rel=FCNN_RTOL)
    scale = np.abs(jpreds).max()
    assert np.abs(s3["preds"] - jpreds).max() <= FCNN_RTOL * scale
    assert len(s3["errors"]) == len(calibration["jerrors"])


def test_calibration_stages_and_gate_on_the_cpu(calibration, tmp_path):
    fix, s3 = calibration["fix"], calibration["stage3"]
    s12 = cal.stages_1_2(fix, "cpu")
    s4 = cal.stage_4(fix, s3["model"], tmp_path, "cpu")
    assert s4["diff"] <= 1e-6
    assert s4["conf"]["model_args"] == cal.MODEL_ARGS
    np.testing.assert_array_equal(s4["conf"]["sensor_locations"],
                                  cal.SENSORS)
    assert abs(s12["c"] - cal.C_SOUND) < 1.0
    res = dict(s12, stage3=s3, stage4=s4)
    assert s12["resid"] < 2.0 and s3["err_mm"] < 10.0 and cal.gate(res)
    assert not cal.gate(dict(res, resid=2.5))
    assert not cal.gate(dict(res, stage4=dict(s4, diff=1e-5)))


# -- streaming CC ------------------------------------------------------------

def test_cc_signals_match_the_demo():
    saved = np.random.get_state()
    try:
        np.random.seed(0)  # the demo's legacy global generator
        n = 6400
        t = np.linspace(0, 10, n)
        a = (np.sin(2 * np.pi * t * 300) + 0.01 * np.random.rand(n)
             ).astype(np.float32)
        b = (np.sin(2 * np.pi * t * 300 + 0.5) + 0.01 * np.random.rand(n)
             ).astype(np.float32)
    finally:
        np.random.set_state(saved)
    got = cc_bench.signals(n)
    np.testing.assert_array_equal(got[0], a)
    np.testing.assert_array_equal(got[1], b)


def test_cc_update_matches_jax():
    """Block by block over 8 pairs, every block's full CC within 1e-4 of
    its scale of JAX's ``streaming_cc_update``."""
    n, block, pairs, blocks = 256, 64, 8, 40
    ab, bb = cc_bench.pair_streams(*cc_bench.signals(block * blocks), pairs)
    state = streaming_cc_init(n, (pairs,), device="cpu")
    jstate = jstreaming_cc_init(n, (pairs,))
    update = jax.jit(jstreaming_cc_update)
    for i in range(0, block * blocks, block):
        state, cc = streaming_cc_update(
            state, torch.as_tensor(ab[:, i : i + block]),
            torch.as_tensor(bb[:, i : i + block]))
        jstate, jcc = update(jstate, jnp.asarray(ab[:, i : i + block]),
                             jnp.asarray(bb[:, i : i + block]))
        jcc = np.asarray(jcc)
        assert cc.shape == jcc.shape == (pairs, 2 * n - 1)
        assert np.abs(cc.numpy() - jcc).max() <= 1e-4 * np.abs(jcc).max()


def test_cc_gate_on_the_cpu():
    res = cc_bench.run(256, 64, 200, 4, device="cpu", log=quiet)
    assert res["checked"] == 3 and cc_bench.gate(res)
    assert res["ccs"].shape == (200, 4, 511)
    np.testing.assert_array_equal(res["ccs"][-1].numpy(), res["last"].numpy())
    assert not cc_bench.gate(dict(res, max_err=2e-3))
