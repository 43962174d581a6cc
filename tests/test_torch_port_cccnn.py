"""The port's CCCNN against the flax CCCNN with the same parameters,
carried across by ``models.jax_import``: the flagship stack, ``cc_impl``
dft/fft × ``cc_norm`` on/off, the pair head, grouped convs, GroupNorm,
pooling, strides and dilation, float32.  Bar: about 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.models.cccnn import paired_xcorr as jpaired_xcorr
from onset_fingerprinting_tpu.ops import xcorr as jx
from onset_fingerprinting_torch.models.cccnn import CCCNN, paired_xcorr
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import xcorr as tx
from onset_fingerprinting_torch.workload import FLAGSHIP, cccnn_flax_params

FLAG = {k: v for k, v in FLAGSHIP.items() if k not in ("cc_impl", "cc_norm")}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("cc_impl", ["dft", "fft"])
@pytest.mark.parametrize("cc_norm", [True, False])
def test_flagship_matches_flax(cc_impl, cc_norm):
    jm = JCCCNN(cc_impl=cc_impl, cc_norm=cc_norm, conv_impl="conv", **FLAG)
    x = np.random.default_rng(0).normal(0, 0.3, (6, 4, 256)).astype(
        np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    # non-zero biases so the bias path is exercised
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.05 if v.ndim == 1 else v, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = CCCNN(input_size=256, cc_impl=cc_impl, cc_norm=cc_norm, **FLAG)
    tm.load_state_dict(cccnn_state_dict_from_flax(to_numpy(variables)))
    assert tm.fc.in_features == (1064 if cc_norm else 1060)
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_self_correlate_dft_matches_jax_and_fft():
    a = np.random.default_rng(2).normal(size=(3, 4, 5, 133)).astype(
        np.float32)
    want = np.asarray(jx.batch_self_correlate_dft(jnp.asarray(a),
                                                  sum_axis=2))
    got = tx.batch_self_correlate_dft(torch.as_tensor(a), sum_axis=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
    fft = tx.batch_full_correlate(torch.as_tensor(a),
                                  torch.as_tensor(a)).sum(dim=2)
    np.testing.assert_allclose(got.numpy(), fft.numpy(), atol=1e-3)


def test_full_correlate_matches_numpy():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 50)).astype(np.float32)
    got = tx.batch_full_correlate(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.correlate(a, b, "full"),
                               atol=1e-4)


@pytest.mark.parametrize("n", [5, 133, 256])
def test_dft_matrices_equal_jax(n):
    for t, j in zip(tx._dft_matrices(n), jx._dft_matrices(n)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tx._dft_inv_sin(n), jx._dft_inv_sin(n))


def test_self_and_pair_correlate_dft_matches_jax():
    a = np.random.default_rng(4).normal(size=(3, 4, 5, 133)).astype(
        np.float32)
    pi, pj = [0, 0, 1, 2], [1, 3, 2, 3]
    want = jx.self_and_pair_correlate_dft(jnp.asarray(a), jnp.array(pi),
                                          jnp.array(pj))
    got = tx.self_and_pair_correlate_dft(torch.as_tensor(a),
                                         torch.tensor(pi), torch.tensor(pj))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-4)
    # the pair CC is the FFT cross-correlation of the pair, summed over maps
    t = torch.as_tensor(a)
    fft = tx.batch_full_correlate(t[:, pi], t[:, pj]).sum(dim=2)
    np.testing.assert_allclose(got[1].numpy(), fft.numpy(), atol=1e-3)


def test_paired_xcorr_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 3 * 4, 20)).astype(
        np.float32)
    want = np.asarray(jpaired_xcorr(jnp.asarray(x), 3, 4))
    got = paired_xcorr(torch.as_tensor(x), 3, 4)
    assert got.shape == (2, 2, 39)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="C\\*K"):
        paired_xcorr(torch.as_tensor(x), 3, 5)


#: a small stack on which every option runs (L = 64)
SMALL = dict(output_size=2, channels=3, layer_sizes=(4, 6),
             kernel_sizes=(5, 3), dropout_rate=0.0, cc_norm=True)


@pytest.mark.parametrize("opt", [
    dict(cc_pairs="adjacent", cc_impl="dft"),
    dict(cc_pairs="adjacent", cc_impl="fft"),
    dict(cc_pairs="all", cc_impl="dft"),
    dict(cc_pairs="all", cc_impl="fft"),
    dict(cc_pairs="all", cc_pair_lags=10, cc_impl="dft"),
    dict(cc_pairs="adjacent", cc_pair_lags=5, cc_impl="fft", cc_norm=False),
    dict(group=True),
    dict(batch_norm=True),
    dict(group=True, batch_norm=True, cc_pairs="all", cc_impl="dft"),
    dict(pool=True),
    dict(strides=2),
    dict(dilation=2, cc_impl="dft"),
    dict(group=True, pool=True, strides=(2, 1), conv_impl="conv"),
    dict(batch_norm=True, conv_impl="mxu", conv_u_block=8),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_options_match_flax(opt):
    cfg = dict(SMALL, **opt)
    jm = JCCCNN(**cfg)
    x = np.random.default_rng(6).normal(0, 0.3, (5, 3, 64)).astype(
        np.float32)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]))
    # perturb biases and the GroupNorm scale so every carried vector counts
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(
        lambda v: v + rng.normal(0, 0.05, v.shape).astype(np.float32)
        if v.ndim == 1 else v, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = CCCNN(input_size=64, **cfg)
    tm.load_state_dict(cccnn_state_dict_from_flax(to_numpy(variables)))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("opt,match", [
    (dict(cc_pairs="pairs"), "cc_pairs"),
    (dict(cc_pairs="all", cc_pair_lags=64), "cc_pair_lags"),
    (dict(cc_impl="matmul"), "cc_impl"),
    (dict(conv_impl="cudnn"), "conv_impl"),
    (dict(group=True, conv_impl="mxu"), "group=False"),
    (dict(conv_impl="pallas", strides=2), "stride=1"),
    (dict(conv_impl="mxu", dilation=2), "stride=1"),
    (dict(conv_impl="pallas", batch_norm=True), "batch_norm"),
])
def test_invalid_options_raise_like_flax(opt, match):
    """The port refuses what the JAX package refuses (L = 64, V = 64)."""
    with pytest.raises(ValueError):
        JCCCNN(**opt).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64)))
    with pytest.raises(ValueError, match=match):
        CCCNN(input_size=64, **opt)


@pytest.mark.parametrize("config", [
    dict(FLAGSHIP, cc_pairs="all", cc_pair_lags=112),
    dict(SMALL, group=True, batch_norm=True, pool=True),
], ids=["flagship-pairs", "small-group-norm-pool"])
def test_random_flax_params_fit_flax(config):
    """``cccnn_flax_params`` has the tree flax builds, and carries over."""
    length = 256 if config["channels"] == 4 else 64
    params = cccnn_flax_params(config, seed=1, window=length)
    jm = JCCCNN(**config)
    init = jm.init(jax.random.PRNGKey(0),
                   jnp.zeros((1, config["channels"], length)))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(to_numpy(init))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(init)):
        assert a.shape == b.shape and a.dtype == np.float32
    tm = CCCNN(input_size=length, **config)
    tm.load_state_dict(cccnn_state_dict_from_flax(params))
