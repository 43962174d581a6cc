"""The fused conv stack's plain version (kernel K3's reference) against
``conv_stack_fused`` in Pallas interpret mode, at the parametrisations of
tests/test_pallas_conv.py:54-62.  Bar: float32 atol 5e-4, rtol 1e-4; the
bfloat16 path within 5e-2 of the float32 golden."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.ops.pallas_conv import conv_stack_fused
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    conv_stack,
    stack_lengths,
)

FLAGSHIP_KS = (1, 33, 64, 15, 15, 15, 1)
PARAMS = [
    (FLAGSHIP_KS, (5,) * 7, 256, 1, "silu"),  # the serving stack
    ((3, 3), (8, 16), 64, 1, "relu"),  # CCCNN defaults
    ((7, 4), (3, 5), 96, 0, "tanh"),  # even kernel, no padding
    ((1,), (6,), 40, 2, "silu"),  # pointwise only
    ((33,), (5,), 256, 16, "silu"),  # padding at the Pallas limit
]


def make_stack(kernel_sizes, layer_sizes, seed=0, scale=0.3):
    """Flax-layout ``[K, I, O]`` weights (as tests/test_pallas_conv.py);
    ``scale=None`` draws them at the models' LeCun scale 1/sqrt(K*I)."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    cin = 1
    for o, k in zip(layer_sizes, kernel_sizes):
        sc = scale if scale is not None else 1 / np.sqrt(k * cin)
        ws.append(rng.normal(size=(k, cin, o)).astype(np.float32) * sc)
        bs.append(rng.normal(size=(o,)).astype(np.float32) * 0.1)
        cin = o
    return ws, bs


def torch_layout(ws, bs):
    return ([torch.as_tensor(np.ascontiguousarray(w.transpose(2, 1, 0)))
             for w in ws], [torch.as_tensor(b) for b in bs])


@pytest.mark.parametrize(
    "kernel_sizes,layer_sizes,length,padding,activation", PARAMS)
def test_matches_pallas_interpret(kernel_sizes, layer_sizes, length, padding,
                                  activation):
    ws, bs = make_stack(kernel_sizes, layer_sizes)
    x = np.random.default_rng(7).normal(size=(19, length)).astype(np.float32)
    want = np.asarray(conv_stack_fused(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), padding=padding, activation=activation,
        compute_dtype=jnp.float32, block_lanes=128, interpret=True,
    ))
    tws, tbs = torch_layout(ws, bs)
    before = _cuda.CONV_STACK.plain_calls
    got = conv_stack(torch.as_tensor(x), tws, tbs, padding, activation,
                     torch.float32)
    assert _cuda.CONV_STACK.plain_calls == before + 1
    assert got.shape == want.shape
    assert got.shape[1] == stack_lengths(length, tws, padding)[-1]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "kernel_sizes,layer_sizes,length,padding,activation", PARAMS)
def test_bf16_within_bound_of_f32_golden(kernel_sizes, layer_sizes, length,
                                         padding, activation):
    # at the models' weight scale: bf16 error compounds with the gain of
    # each layer, and the 0.3 scale above amplifies ~5x per wide layer
    ws, bs = make_stack(kernel_sizes, layer_sizes, seed=1, scale=None)
    x = np.random.default_rng(8).normal(size=(11, length)).astype(np.float32)
    want = np.asarray(conv_stack_fused(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), padding=padding, activation=activation,
        compute_dtype=jnp.float32, block_lanes=128, interpret=True,
    ))
    tws, tbs = torch_layout(ws, bs)
    got = conv_stack(torch.as_tensor(x), tws, tbs, padding, activation,
                     torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=5e-2)


def test_rejects_unchained_layers():
    ws = [torch.zeros(4, 1, 3), torch.zeros(4, 5, 3)]
    bs = [torch.zeros(4), torch.zeros(4)]
    with pytest.raises(ValueError, match="chain"):
        conv_stack(torch.zeros(2, 32), ws, bs)
