"""The port's FCNN and CNN against flax, parameters carried across by
``models.jax_import``: eval forwards, one training forward (outputs, the
BatchNorm running stats with the biased variance, gradients), the bundle's
numpy call, the L2 penalty; then the flax-style init and dropout.  Bar:
float32 atol 1e-5, rtol 1e-4 (grads 1e-4); bfloat16 CNN 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.cnn import CNN as JCNN
from onset_fingerprinting_tpu.models.fcnn import FCNN as JFCNN
from onset_fingerprinting_tpu.models.fcnn import FCNNBundle as JBundle
from onset_fingerprinting_torch.models.cnn import CNN
from onset_fingerprinting_torch.models.fcnn import (
    FCNN,
    FCNNBundle,
    dropout,
    flax_init_,
    init_module,
)
from onset_fingerprinting_torch.models.jax_import import (
    cnn_state_dict_from_flax,
    fcnn_state_dict_from_flax,
)

KW = dict(atol=1e-5, rtol=1e-4)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, seed=7):
    """Every 1-D leaf moved off its init, so that each carried vector (biases,
    BatchNorm scale and stats) counts; variances stay positive."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.abs(v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        if v.ndim == 1 else np.asarray(v), to_numpy(variables))


def flax_grads_and_stats(jm, variables, x, y):
    """One flax training forward: (out, new batch_stats, grads of the L1
    loss)."""
    def loss(p):
        out, upd = jm.apply({"params": p, **{
            k: v for k, v in variables.items() if k != "params"}},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - y)), (out, upd)

    g, (out, upd) = jax.grad(loss, has_aux=True)(variables["params"])
    return np.asarray(out), to_numpy(upd.get("batch_stats", {})), to_numpy(g)


FCNN_CASES = [
    dict(hidden_layers=(10, 10, 10)),
    dict(hidden_layers=(16, 8), activation="tanh"),
    dict(hidden_layers=(12,), batch_norm=False, activation="silu"),
    dict(hidden_layers=(6, 6), bias=False, activation="leakyrelu"),
    dict(hidden_layers=(8, 8), activation="elu", output_size=3),
]


@pytest.mark.parametrize("cfg", FCNN_CASES, ids=str)
def test_fcnn_matches_flax(cfg):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    out_size = cfg.get("output_size", 2)
    y = rng.normal(size=(32, out_size)).astype(np.float32)
    jm = JFCNN(**cfg)
    variables = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = FCNN(6, **cfg)
    tm.load_state_dict(fcnn_state_dict_from_flax(variables))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **KW)
    # training: batch statistics, running stats (biased variance), grads
    jout, jstats, jgrads = flax_grads_and_stats(jm, variables, x, y)
    tm.train()
    out = tm(torch.as_tensor(x))
    (out - torch.as_tensor(y)).abs().mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **KW)
    want_sd = fcnn_state_dict_from_flax({"params": jgrads,
                                         "batch_stats": jstats})
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   err_msg=name, **KW)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_batchnorm_keeps_the_biased_variance():
    tm = FCNN(3, hidden_layers=(4,))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    tm.train()(x)
    h = tm.layers[0](x).detach()
    var = h.var(dim=0, unbiased=False)
    torch.testing.assert_close(tm.norms[0].running_var, 0.99 + 0.01 * var)
    assert not torch.allclose(tm.norms[0].running_var,
                              0.99 + 0.01 * h.var(dim=0, unbiased=True))


def test_bundle_call_np_and_l2_match_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    jm = JFCNN(hidden_layers=(8, 8), l2_reg=0.01)
    variables = perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    tm = FCNN(6, hidden_layers=(8, 8), l2_reg=0.01)
    tm.load_state_dict(fcnn_state_dict_from_flax(variables))
    want = JBundle(jm, variables).call_np(x[1])
    got = FCNNBundle(tm).call_np(x[1])
    np.testing.assert_allclose(got, want, **KW)
    np.testing.assert_allclose(float(tm.l2_loss().detach()),
                               float(jm.l2_loss(variables["params"])),
                               rtol=1e-5)
    assert float(FCNN(6, hidden_layers=(4,)).l2_loss()) == 0.0


CNN_CASES = [
    dict(),
    dict(batch_norm=True, pool=True, kernel_size=7, layer_sizes=(8, 16)),
    dict(padding=0, dilation=2, activation="relu"),
    dict(groups=3, layer_sizes=(6, 9), batch_norm=True),
    dict(pool=True, output_size=5),
]


@pytest.mark.parametrize("cfg", CNN_CASES, ids=str)
def test_cnn_matches_flax(cfg):
    cfg = dict(cfg, dropout_rate=0.0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 3, 40)).astype(np.float32)
    y = rng.normal(size=(6, cfg.get("output_size", 2))).astype(np.float32)
    jm = JCNN(**cfg)
    variables = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = CNN(40, 3, **cfg)
    tm.load_state_dict(cnn_state_dict_from_flax(variables))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **KW)
    jout, jstats, jgrads = flax_grads_and_stats(jm, variables, x, y)
    out = tm.train()(torch.as_tensor(x))
    (out - torch.as_tensor(y)).abs().mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **KW)
    want_sd = cnn_state_dict_from_flax({"params": jgrads,
                                        "batch_stats": jstats})
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   err_msg=name, **KW)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_cnn_bf16_matches_flax():
    cfg = dict(dropout_rate=0.0, dtype=jnp.bfloat16)
    x = np.random.default_rng(5).normal(size=(4, 3, 32)).astype(np.float32)
    jm = JCNN(**cfg)
    variables = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = CNN(32, 3, dropout_rate=0.0, dtype=torch.bfloat16)
    tm.load_state_dict(cnn_state_dict_from_flax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


def test_flax_init_draws_lecun_normal_from_the_generator():
    m = CNN(64, 4, layer_sizes=(32, 32), batch_norm=True)
    init_module(m, seed=3, device="cpu")
    w = m.convs[1].weight  # fan_in 32 * 3
    std = (1 / 96) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.1
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(float(c.bias.abs().max()) == 0 for c in m.convs)
    assert torch.equal(m.norms[0].weight, torch.ones(32))
    again = init_module(CNN(64, 4, layer_sizes=(32, 32), batch_norm=True),
                        seed=3, device="cpu")
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    other = flax_init_(FCNN(4, hidden_layers=(5,)),
                       torch.Generator().manual_seed(4))
    assert not torch.equal(other.layers[0].weight,
                           init_module(FCNN(4, hidden_layers=(5,)), 3,
                                       "cpu").layers[0].weight)


def test_eye_init_is_identity_plus_noise():
    m = init_module(FCNN(6, hidden_layers=(6, 4), eye_init=True,
                         eye_noise_floor=0.01), seed=0, device="cpu")
    for lin in (*m.layers, m.out):
        o, i = lin.weight.shape
        dev = lin.weight - torch.eye(o, i)
        assert 0.003 < float(dev.std()) < 0.03
        assert float(lin.bias.abs().max()) == 0


def test_dropout_uses_the_given_generator():
    x = torch.ones(4000)
    a = dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(dropout(x, 0.25, False, None), x)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)
