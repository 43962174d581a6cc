"""The port's RNN and CNNRNN against flax, parameters carried across by
``models.jax_import`` (every 1-D leaf moved off its init so each carried
bias counts), eval forwards on the same numpy inputs.  Bar: atol 1e-5,
rtol 1e-4 (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.rnn import CNNRNN as JCNNRNN
from onset_fingerprinting_tpu.models.rnn import RNN as JRNN
from onset_fingerprinting_torch.models.jax_import import (
    cnnrnn_state_dict_from_flax,
    rnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.models.rnn import CNNRNN, RNN

KW = dict(atol=1e-5, rtol=1e-4)


def perturbed(variables, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.abs(np.asarray(v) + rng.normal(0, 0.2, v.shape)
                         ).astype(np.float32)
        if v.ndim == 1 else np.asarray(v), variables)


def inputs(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


RNN_CASES = [
    dict(rnn_type="GRU"),
    dict(rnn_type="GRU", bidirectional=True),
    dict(rnn_type="LSTM", bidirectional=True),
    dict(rnn_type="RNN", num_layers=1),
    dict(rnn_type="GRU", share_input_weights=True, num_heads=3),
    dict(rnn_type="LSTM", share_input_weights=True, bidirectional=True,
         num_layers=1),
    dict(rnn_type="RNN", permute_input=False, num_heads=4),
]


@pytest.mark.parametrize("case", RNN_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c.items())
                              for c in RNN_CASES])
def test_rnn_matches_flax(case):
    c, length = 4, 24
    args = {**dict(output_size=2, hidden_size=12, num_layers=2,
                   dropout_rate=0.3), **case}
    shape = (5, c, length) if args.get("permute_input", True) else (
        5, length, c)
    x = inputs(shape)
    jm = JRNN(**args)
    variables = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = RNN(c, **args).eval()
    model.load_state_dict(rnn_state_dict_from_flax(
        variables, args.get("bidirectional", False)))
    with torch.no_grad():
        out = model(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, **KW)


CNNRNN_CASES = [
    dict(),
    dict(batch_norm=True, pool=True, n_rnn_layers=2, activation="relu"),
    dict(layer_sizes=(6,), kernel_size=5, padding=2, dilation=2,
         num_heads=4),
]


@pytest.mark.parametrize("case", CNNRNN_CASES, ids=["plain", "bn-pool-2",
                                                    "dilated"])
def test_cnnrnn_matches_flax(case):
    c, length = 3, 40
    args = dict(output_size=3, n_hidden=16, dropout_rate=0.2, **case)
    x = inputs((4, c, length), seed=2)
    jm = JCNNRNN(**args)
    variables = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = CNNRNN(length, c, **args).eval()
    model.load_state_dict(cnnrnn_state_dict_from_flax(variables))
    with torch.no_grad():
        out = model(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, **KW)


def test_training_dropout_draws_from_the_generator():
    """In training the masks come from the generator ``forward`` is given:
    the same seed gives the same output, another seed another, and none
    raises."""
    x = torch.tensor(inputs((3, 4, 16)))
    for model in (RNN(4, hidden_size=8, dropout_rate=0.5),
                  CNNRNN(16, 4, n_hidden=8, n_rnn_layers=2)):
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(0))
        b = model(x, generator=torch.Generator().manual_seed(0))
        c = model(x, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)
        with pytest.raises(ValueError, match="generator"):
            model(x)


def test_flax_style_init():
    """``init_module`` initialises the recurrent layers per gate as flax's
    cells (LeCun-normal input kernels, orthogonal hidden kernels, zero
    biases) and the attention's projections LeCun-normal, from the seed."""
    from onset_fingerprinting_torch.models.fcnn import init_module

    m = init_module(RNN(3, hidden_size=16, rnn_type="LSTM"), 0, "cpu")
    again = init_module(RNN(3, hidden_size=16, rnn_type="LSTM"), 0, "cpu")
    for k, v in m.state_dict().items():
        torch.testing.assert_close(v, again.state_dict()[k], rtol=0, atol=0)
    lstm = m.rnn[1]
    for gate in lstm.weight_hh_l0.view(4, 16, 16):
        torch.testing.assert_close(gate @ gate.T, torch.eye(16), rtol=0,
                                   atol=1e-5)
    # the truncation at two of the normal's standard deviations
    bound = 2 / (16 ** 0.5 * 0.87962566103423978) + 1e-6
    assert float(lstm.weight_ih_l0.detach().abs().max()) <= bound
    assert not lstm.bias_ih_l0.any() and not lstm.bias_hh_l0.any()
    w = m.attention.in_proj_weight.detach()
    assert float(w.abs().max()) <= bound
    assert not m.attention.in_proj_bias.any()
