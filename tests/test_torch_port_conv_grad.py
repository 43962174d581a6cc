"""K3 under autograd on the CPU: the port's differentiable conv stack (its
``autograd.Function`` with the plain forward standing in for the kernel)
against the JAX package's ``conv_stack_fused`` custom VJP in Pallas
interpret mode, its counters, and the flagship CCCNN's gradients against
flax's.  Bar: atol 1e-5, rtol 1e-4 (tests/test_pallas_conv.py:206-226)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.ops.pallas_conv import conv_stack_fused
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    conv_stack,
    conv_stack_reference,
    kernel_for,
)

FLAGSHIP_KS = (1, 33, 64, 15, 15, 15, 1)
STACKS = [
    (FLAGSHIP_KS, (5,) * 7, 256, 1, "silu"),
    ((3, 3), (8, 16), 64, 1, "relu"),
    ((7, 4), (3, 5), 96, 0, "tanh"),
]


def make_stack(kernel_sizes, layer_sizes, seed=0):
    """Flax-layout ``[K, I, O]`` weights at the LeCun scale, small
    biases."""
    rng = np.random.default_rng(seed)
    ws, bs, cin = [], [], 1
    for o, k in zip(layer_sizes, kernel_sizes):
        ws.append(rng.normal(size=(k, cin, o)).astype(np.float32)
                  / np.sqrt(k * cin))
        bs.append(rng.normal(size=(o,)).astype(np.float32) * 0.1)
        cin = o
    return ws, bs


def torch_leaves(ws, bs, x):
    return ([torch.tensor(w.transpose(2, 1, 0), requires_grad=True)
             for w in ws], [torch.tensor(b, requires_grad=True) for b in bs],
            torch.tensor(x, requires_grad=True))


@pytest.mark.parametrize("ks,widths,length,pad,act", STACKS)
def test_grads_match_pallas_custom_vjp(ks, widths, length, pad, act):
    ws, bs = make_stack(ks, widths)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, length)).astype(np.float32)

    def fused(xx, ww, bb):
        return conv_stack_fused(xx, ww, bb, padding=pad, activation=act,
                                compute_dtype=jnp.float32, block_lanes=128,
                                interpret=True)

    out = fused(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                tuple(map(jnp.asarray, bs)))
    ct = rng.normal(size=out.shape).astype(np.float32)
    gx, gw, gb = jax.grad(
        lambda xx, ww, bb: jnp.sum(fused(xx, ww, bb) * ct),
        argnums=(0, 1, 2))(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                           tuple(map(jnp.asarray, bs)))
    tw, tb, tx = torch_leaves(ws, bs, x)
    got = conv_stack(tx, tw, tb, pad, act, torch.float32)
    got.backward(torch.as_tensor(ct))
    kw = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **kw)
    for t, j in zip(tw, gw):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(j).transpose(2, 1, 0), **kw)
    for t, j in zip(tb, gb):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need_x", [False, True])
def test_function_equals_autograd_of_the_plain_chain(dtype, need_x):
    """The Function's grads are autograd's of the plain chain, bit for bit
    on the CPU; its forward counts one plain call, its backward one
    recompute and no plain call."""
    ws, bs = make_stack(FLAGSHIP_KS, (5,) * 7, seed=1)
    x = np.random.default_rng(4).normal(size=(5, 256)).astype(np.float32)
    tw, tb, tx = torch_leaves(ws, bs, x)
    tx.requires_grad_(need_x)
    kernel = kernel_for(256, tw, 1, dtype, len(x))
    before = (kernel.plain_calls, kernel.backward_recomputes)
    out = conv_stack(tx, tw, tb, 1, "silu", dtype)
    assert type(out.grad_fn).__name__ == "_ConvStackBackward"
    assert (kernel.plain_calls, kernel.backward_recomputes) == (
        before[0] + 1, before[1])
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    leaves = [*tw, *tb] + ([tx] if need_x else [])
    got = torch.autograd.grad(out, leaves, ct)
    assert (kernel.plain_calls, kernel.backward_recomputes) == (
        before[0] + 1, before[1] + 1)
    ref = conv_stack_reference(tx, tw, tb, 1, "silu", dtype)
    want = torch.autograd.grad(ref, leaves, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert conv_stack(tx, tw, tb, 1, "silu", dtype).grad_fn is None


def test_only_the_needed_grads_are_formed():
    ws, bs = make_stack((3, 3), (4, 2))
    tw, tb, tx = torch_leaves(ws, bs, np.ones((2, 16), np.float32))
    tx.requires_grad_(False)
    tw[0].requires_grad_(False)
    out = conv_stack(tx, tw, tb, 1, "silu", torch.float32)
    out.sum().backward()
    assert tx.grad is None and tw[0].grad is None
    assert all(t.grad is not None for t in (tw[1], *tb))


class TestFlagshipCCCNN:
    KW = dict(output_size=2, channels=4, layer_sizes=(5,) * 7,
              kernel_sizes=FLAGSHIP_KS, dropout_rate=0.0, cc_impl="dft",
              cc_norm=True)

    def test_gradients_match_flax(self):
        """test_pallas_conv.py::test_gradients_match_conv_impl's setup: the
        port's fused CCCNN (K3's Function) against flax's conv chain."""
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 4, 256)).astype(np.float32)
        y = rng.normal(size=(4, 2)).astype(np.float32)
        jm = JCCCNN(conv_impl="conv", **self.KW)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

        def loss(p):
            return jnp.mean(jnp.abs(jm.apply(p, jnp.asarray(x)) - y))

        want = cccnn_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
        tm = CCCNN(input_size=256, **self.KW)
        assert tm.fused
        tm.load_state_dict(cccnn_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        before = _cuda.CONV_STACK.backward_recomputes
        (tm(torch.as_tensor(x)) - torch.as_tensor(y)).abs().mean().backward()
        assert _cuda.CONV_STACK.backward_recomputes == before + 1
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_the_dft_head_trains_after_an_inference_mode_call():
    """The head's cached DFT matrices, first made under inference_mode (as
    the serving paths call it), still take part in a backward."""
    from onset_fingerprinting_torch.ops.xcorr import batch_self_correlate_dft

    a = torch.randn(2, 3, 4, 37, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        batch_self_correlate_dft(a, sum_axis=2)
    x = a.clone().requires_grad_()
    for prec in ("highest", "default"):
        batch_self_correlate_dft(x, sum_axis=2, precision=prec).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
