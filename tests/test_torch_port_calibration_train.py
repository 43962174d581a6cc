"""``train_location_model`` against the JAX package's, both loops (one
epoch per step with the pre-update best state; chunks of epochs with the
post-chunk loss), from flax's init of the same FCNN (carried across in
place of the port's own draw).  Bar: the per-epoch losses within 1e-4,
the stopping epoch equal, the returned weights within 1e-4 and, without
BatchNorm, the bundle's predictions within 1e-4.

With BatchNorm, the Dense biases in front of a norm and the norms' running
means are left out: the norm cancels those biases, so their gradient is 0
in exact arithmetic and a rounding residue in each package, which adam
turns into steps of its own in each; the running means follow the biases.
Every training loss (batch statistics) is still held to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from onset_fingerprinting_tpu.locate import calibration as jcal
from onset_fingerprinting_tpu.models.fcnn import FCNN as JFCNN
from onset_fingerprinting_torch.locate import calibration as tcal
from onset_fingerprinting_torch.models.jax_import import (
    fcnn_state_dict_from_flax,
)


def lag_data(n=64, seed=0):
    """Lag vectors of hits on a disc and their positions."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    sensors = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
    d = np.linalg.norm(pos[:, None] - sensors[None], axis=-1)
    lags = np.stack([d[:, i] - d[:, j] for i in range(4)
                     for j in range(i + 1, 4)], axis=1) * 20
    return np.round(lags).astype(np.float32), pos


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("epochs_per_step,lossfun", [(1, "l1"), (1, "mse"),
                                                     (5, "l1"), (5, "mse")])
def test_train_location_model_matches_jax(monkeypatch, epochs_per_step,
                                          lossfun, batch_norm):
    lags, pos = lag_data()
    net = dict(hidden_layers=[16, 16], batch_norm=batch_norm)
    kw = dict(lr=1e-2, lossfun=lossfun, num_epochs=60, patience=4,
              epochs_per_step=epochs_per_step, **net)
    jbundle, jerr = jcal.train_location_model(lags, pos, **kw)
    init = JFCNN(output_size=2, **net).init(
        jax.random.PRNGKey(0), jnp.asarray(lags), train=False)
    sd = fcnn_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, init))

    def flax_init(module, seed, device):
        assert seed == 0
        module.load_state_dict(sd)
        return module.to(device)

    monkeypatch.setattr(tcal, "init_module", flax_init)
    tbundle, terr = tcal.train_location_model(lags, pos, device="cpu", **kw)
    assert len(terr) == len(jerr)
    np.testing.assert_allclose(terr, jerr, atol=1e-4)
    want = fcnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jbundle.variables))
    for name, v in tbundle.model.state_dict().items():
        if batch_norm and (name.endswith("running_mean") or (
                name.startswith("layers.") and name.endswith(".bias"))):
            continue
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)
    if not batch_norm:
        np.testing.assert_allclose(tbundle(lags).numpy(),
                                   np.asarray(jbundle(jnp.asarray(lags))),
                                   atol=1e-4)
        np.testing.assert_allclose(tbundle.call_np(lags[3]),
                                   jbundle.call_np(lags[3]), atol=1e-4)
