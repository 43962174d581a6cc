"""The port's CCCNN against the flax CCCNN with the same parameters,
carried across by ``models.jax_import``: the flagship stack, ``cc_impl``
dft/fft × ``cc_norm`` on/off, float32.  Bar: about 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.ops import xcorr as jx
from onset_fingerprinting_torch.models.cccnn import CCCNN, paired_xcorr
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import xcorr as tx
from onset_fingerprinting_torch.workload import FLAGSHIP

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


@pytest.mark.parametrize("opt", [dict(group=True), dict(batch_norm=True),
                                 dict(pool=True), dict(cc_pairs="all")])
def test_unported_options_raise(opt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CCCNN(input_size=64, **opt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paired_xcorr(torch.zeros(1, 6, 8), 3, 2)
