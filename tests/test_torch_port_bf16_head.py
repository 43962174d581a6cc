"""The bf16 CCCNN against the JAX package: the DFT head's ``precision``,
JAX's bf16 fused conv stack (Pallas, interpret mode) against the port's
plain K3, and the flax bf16 CCCNN against the port's.

A bf16 model's head rounds both operands of each of its products to bf16
and accumulates in f32 (``precision="default"``, the TPU's one-pass
matmul).  On the CPU the JAX package runs ``Precision.DEFAULT`` in full
f32, so against JAX the head is compared on bf16-rounded features with a
bf16-sized tolerance; against a float64 numpy emulation of the rounding
points it is compared at f32 accumulation size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.ops import xcorr as jx
from onset_fingerprinting_tpu.ops.pallas_conv import conv_stack_fused
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import xcorr as tx
from onset_fingerprinting_torch.ops.conv_stack import conv_stack_reference
from onset_fingerprinting_torch.workload import FLAGSHIP, cccnn_flax_params

PI, PJ = [0, 0, 1, 2], [1, 3, 2, 3]


def bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even), as
    float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_bf16_rounding_helper_matches_torch():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 100
    want = torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(bf16(x), want)


def emulate_self(a: np.ndarray) -> np.ndarray:
    """The bf16 self-CC head in float64 from its rounding points: features
    and forward matrices rounded to bf16, the power spectrum (summed over
    axis 2) and the inverse rounded to bf16."""
    re_m, im_m, inv = tx._dft_matrices(a.shape[-1])
    a64 = bf16(a).astype(np.float64)
    re = a64 @ bf16(re_m).astype(np.float64)
    im = a64 @ bf16(im_m).astype(np.float64)
    power = (re * re + im * im).sum(axis=2).astype(np.float32)
    return bf16(power).astype(np.float64) @ bf16(inv).astype(np.float64)


def emulate_pairs(a: np.ndarray) -> np.ndarray:
    re_m, im_m, inv_cos = tx._dft_matrices(a.shape[-1])
    inv_sin = tx._dft_inv_sin(a.shape[-1])
    a64 = bf16(a).astype(np.float64)
    re = a64 @ bf16(re_m).astype(np.float64)
    im = a64 @ bf16(im_m).astype(np.float64)
    cr = (re[:, PI] * re[:, PJ] + im[:, PI] * im[:, PJ]).sum(axis=2)
    ci = (im[:, PI] * re[:, PJ] - re[:, PI] * im[:, PJ]).sum(axis=2)
    return (bf16(cr.astype(np.float32)).astype(np.float64)
            @ bf16(inv_cos).astype(np.float64)
            + bf16(ci.astype(np.float32)).astype(np.float64)
            @ bf16(inv_sin).astype(np.float64))


def features(seed: int, shape=(3, 4, 5, 133)) -> np.ndarray:
    """Conv-stack-like features: bf16 values, as K3 in bf16 emits them."""
    return bf16(np.random.default_rng(seed).normal(size=shape)
                .astype(np.float32))


def close_to(got: np.ndarray, want: np.ndarray, frac: float) -> None:
    """Every value within ``frac`` of the largest magnitude of ``want``."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, (err, scale, err / scale)


def test_bf16_self_head_equals_its_emulation():
    """The products accumulate in f32 where the emulation uses f64, and the
    power spectrum rounds to bf16 in both: within 1e-6 of the output's
    scale (about 8 f32 ulps of a 133-term sum)."""
    a = features(1)
    got = tx.batch_self_correlate_dft(torch.as_tensor(a), sum_axis=2,
                                      precision="default").numpy()
    assert got.dtype == np.float32
    close_to(got, emulate_self(a), 1e-6)


def test_bf16_pair_head_equals_its_emulation():
    a = features(2)
    self_cc, pair_cc = tx.self_and_pair_correlate_dft(
        torch.as_tensor(a), torch.tensor(PI), torch.tensor(PJ),
        precision="default")
    close_to(self_cc.numpy(), emulate_self(a), 1e-6)
    close_to(pair_cc.numpy(), emulate_pairs(a), 1e-6)


def test_bf16_head_matches_jax_on_bf16_features():
    """JAX on the CPU runs DEFAULT in f32, so it rounds only the features;
    the port also rounds the DFT matrices and the spectra (relative error
    up to 2^-8 each): within 1e-2 of the output's scale, and the f32 head
    is within 1e-5 of JAX on the same features."""
    a = features(3)
    want = np.asarray(jx.batch_self_correlate_dft(
        jnp.asarray(a), precision=jax.lax.Precision.DEFAULT, sum_axis=2))
    got = tx.batch_self_correlate_dft(torch.as_tensor(a), sum_axis=2,
                                      precision="default").numpy()
    close_to(got, want, 1e-2)
    f32 = tx.batch_self_correlate_dft(torch.as_tensor(a), sum_axis=2).numpy()
    close_to(f32, want, 1e-5)
    # the bf16 head is not the f32 head
    assert not np.array_equal(got, f32)
    jself, jpair = jx.self_and_pair_correlate_dft(
        jnp.asarray(a), jnp.array(PI), jnp.array(PJ),
        precision=jax.lax.Precision.DEFAULT)
    tself, tpair = tx.self_and_pair_correlate_dft(
        torch.as_tensor(a), torch.tensor(PI), torch.tensor(PJ),
        precision="default")
    close_to(tself.numpy(), np.asarray(jself), 1e-2)
    close_to(tpair.numpy(), np.asarray(jpair), 1e-2)


def test_highest_is_the_plain_f32_product():
    """``precision="highest"`` is the f32 product the head ran before the
    argument existed, bit for bit."""
    a = torch.as_tensor(np.random.default_rng(4).normal(size=(6, 133))
                        .astype(np.float32))
    re_m, im_m, inv, _ = tx._dft_tensors(133, a.device)
    re, im = torch.matmul(a, re_m), torch.matmul(a, im_m)
    want = torch.matmul(re * re + im * im, inv)
    assert torch.equal(tx.batch_self_correlate_dft(a), want)
    assert torch.equal(tx.dft_matmul(a, re_m), re)


def test_precision_is_validated():
    with pytest.raises(ValueError, match="precision"):
        tx.batch_self_correlate_dft(torch.zeros(2, 8), precision="high")


def flagship_stack(seed: int):
    """Flagship conv weights ``[K, I, O]`` (flax layout) and biases."""
    params = cccnn_flax_params(FLAGSHIP, seed=seed)["params"]["_ConvStack_0"]
    rng = np.random.default_rng(seed + 100)
    ws = [params[f"Conv_{i}"]["kernel"] for i in range(len(params))]
    bs = [(0.1 * rng.normal(size=w.shape[-1])).astype(np.float32)
          for w in ws]
    return ws, bs


def test_jax_bf16_conv_stack_matches_port_plain():
    """JAX's fused bf16 conv stack (the Pallas kernel in interpret mode)
    against the port's plain K3 in bf16, on the flagship stack: the same
    rounding points (input and weights to bf16, bias and activation in
    f32, each layer's output stored as bf16).  A sum of up to 320 products
    taken in another order can flip a bf16 rounding, so: at least 99% of
    the values equal (measured 99.9%), and every value within about one
    bf16 ulp (``ops/conv_stack.far_values``' bar, 1e-3 + 4e-3·|v|;
    measured 2.4e-4 at most)."""
    ws, bs = flagship_stack(0)
    x = np.random.default_rng(5).normal(size=(16, 256)).astype(np.float32)
    want = np.asarray(conv_stack_fused(
        jnp.asarray(x), tuple(jnp.asarray(w) for w in ws),
        tuple(jnp.asarray(b) for b in bs), padding=1,
        compute_dtype=jnp.bfloat16, block_lanes=128, interpret=True))
    got = conv_stack_reference(
        torch.as_tensor(x),
        [torch.as_tensor(w.transpose(2, 1, 0)) for w in ws],
        [torch.as_tensor(b) for b in bs], 1, "silu", torch.bfloat16).numpy()
    assert got.shape == want.shape == (16, 133, 5)
    # both store bf16 values
    np.testing.assert_array_equal(bf16(got), got)
    np.testing.assert_array_equal(bf16(want), want)
    assert np.mean(got == want) >= 0.99
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=4e-3)


@pytest.mark.parametrize("pairs", [None, "all"], ids=["flagship", "pairs"])
def test_flax_bf16_cccnn_matches_port(pairs):
    """Flax ``CCCNN(dtype=bfloat16)`` (its conv stack through the Pallas
    kernel in interpret mode, as it serves) against the port's bf16 CCCNN,
    weights carried across.  Both round the same points in the stack; the
    heads differ by the bf16 rounding of the DFT matrices and spectra,
    which JAX on the CPU does not do: within 2e-2 of the outputs' scale.
    The f32 model is outside that bar, so the bar sees the head's
    precision."""
    config = dict(FLAGSHIP, cc_pairs=pairs)
    params = cccnn_flax_params(config, seed=3)
    x = np.random.default_rng(6).normal(0, 0.3, (6, 4, 256)).astype(
        np.float32)
    jm = JCCCNN(dtype=jnp.bfloat16, conv_impl="pallas", **config)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        tm = CCCNN(input_size=256, dtype=dt, **config).eval()
        tm.load_state_dict(cccnn_state_dict_from_flax(params))
        with torch.no_grad():
            outs[dt] = tm(torch.as_tensor(x)).numpy()
    close_to(outs[torch.bfloat16], want, 1.5e-3)
    scale = float(np.abs(want).max())
    assert np.abs(outs[torch.float32] - want).max() > 1.5e-3 * scale
