"""``models.experiment`` against the JAX package's: ``build_cccnn``'s
models (with and without pair features, chosen by a trial, the fallback
for short windows) equal flax's forward with flax's parameters carried
across (atol 1e-4, rtol 1e-4, test_torch_port_cccnn.py's bar),
``flagship_conv_output_length`` equal, and ``run_location_hpo`` end to end
on a small session on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models import experiment as jexp
from onset_fingerprinting_tpu.models.hpo import Study as JStudy
from onset_fingerprinting_torch.data.synth import synth_location_session
from onset_fingerprinting_torch.models import experiment as texp
from onset_fingerprinting_torch.models.hpo import Study
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)


@pytest.mark.parametrize("w", [40, 200, 256, 300, 500])
def test_flagship_conv_output_length_matches_jax(w):
    assert texp.flagship_conv_output_length(w) == \
        jexp.flagship_conv_output_length(w)


@pytest.mark.parametrize("kw", [
    dict(), dict(cc_pairs="all", cc_pair_lags=112),
    dict(cc_pairs="adjacent"), dict(cc_pairs="all", w=140)], ids=str)
def test_build_cccnn_matches_jax(kw):
    w = kw.get("w", 256)
    x = np.random.default_rng(0).normal(0, 0.3, (3, 4, w)).astype(
        np.float32)
    jm = jexp.build_cccnn(None, 4, **kw)
    tm = texp.build_cccnn(None, 4, **kw)
    assert (tm.pairs is None) == (jm.cc_pairs is None)
    assert tm.cc_pair_lags == jm.cc_pair_lags
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm.load_state_dict(cccnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables,
                                                        jnp.asarray(x))),
                               atol=1e-4, rtol=1e-4)


def test_build_cccnn_with_a_trial_draws_as_jax():
    """A trial's draws (dropout, the pair mode) come from the copied
    search, so a seeded study builds the same models in both packages."""
    built = {}
    for name, study, build in (("torch", Study(seed=5), texp.build_cccnn),
                               ("jax", JStudy(seed=5), jexp.build_cccnn)):
        built[name] = []

        def objective(trial, build=build, out=built[name]):
            m = build(trial, 4, search_pairs=True)
            pairs = m.pairs if name == "torch" else m.cc_pairs
            out.append((m.dropout_rate, pairs is None, trial.params))
            return m.dropout_rate

        study.optimize(objective, n_trials=6)
    assert built["torch"] == built["jax"]


def test_run_location_hpo_on_the_cpu(tmp_path):
    synth_location_session(tmp_path, n_hits=24, sr=96000, seed=0)
    study = texp.run_location_hpo(tmp_path, "combined0", n_trials=2,
                                  num_epochs=2, min_epochs=0, subsample=4,
                                  device="cpu")
    assert len(study.trials) == 2
    assert np.isfinite(study.best_value)
    assert np.isfinite(study.best_trial.user_attrs["test_l1"])
    assert set(study.best_params) >= {"dropout", "lr"}
