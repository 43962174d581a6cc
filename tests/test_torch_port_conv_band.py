"""The tensor-core conv stack's tiling (``csrc/conv_stack_mma.cu``),
emulated in plain torch on the CPU: the band, the pair table the kernel
builds its A fragments from, the per-block banded product over the plan's
buffers, the routing rule and the weight cache.

The emulation is held against ``conv_stack_reference`` and the JAX
``conv_stack_fused`` in interpret mode at float32 (atol 5e-4, rtol 1e-4,
the bar of test_torch_port_conv_stack.py), and in bfloat16 against the
reference at the card's bar (atol 3e-2, rtol 2e-2: same rounding points,
another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.ops.pallas_conv import (
    _Z,
    _pack_band,
    _plan,
    conv_stack_fused,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    _ACTIVATIONS,
    TB,
    ZR,
    conv_stack_reference,
    kernel_for,
    mma_plan,
    pack_taps,
    packed_weights,
)

from test_torch_port_conv_stack import make_stack, torch_layout

STACKS = [
    ((1, 33, 64, 15, 15, 15, 1), (5,) * 7, 256, 1, "silu"),  # flagship
    ((3, 3), (8, 16), 64, 1, "relu"),
    ((7, 4), (3, 5), 96, 0, "tanh"),
    # layer 3 writes 64 positions into the buffer where layer 1 left 66:
    # layer 4 reads position 64 as padding, which only the zero tail clears
    ((1, 3, 5, 3), (4,) * 4, 64, 1, "silu"),
]
IDS = ["flagship", "3-3_8-16", "7-4_3-5_pad0", "zero_tail"]


def band(w: torch.Tensor, tb: int, s: int, off: int) -> torch.Tensor:
    """``band[o * tb + tau, i * s + j] = w[o, i, j - tau - off]``, zero
    outside ``[0, K)``: the product of one block of ``tb`` output
    positions with a window of ``s`` rows per input feature."""
    o, i, k = w.shape
    rows = torch.arange(o * tb)[:, None]
    cols = torch.arange(i * s)[None, :]
    kk = cols % s - rows % tb - off
    valid = (kk >= 0) & (kk < k)
    vals = w[rows // tb, cols // s, kk.clamp(0, k - 1)]
    return torch.where(valid, vals, torch.zeros((), dtype=w.dtype))


def band_from_taps(taps: torch.Tensor, s: int) -> torch.Tensor:
    """The band as the kernel's lanes read it: A-fragment register ``r`` of
    lane ``l`` at k-chunk ``kc`` is pair ``j + (0, -8, 8, 0)[r]`` of the
    table, ``j = kc + 2 * (l % 4) - l // 4 + 15``, and holds rows
    ``g + (0, 8, 0, 8)[r]``, columns ``kc + c + (0, 0, 8, 8)[r] + (0, 1)``
    of the m16 x k16 tile (PTX mma.m16n8k16 fragment layout)."""
    o, i, tw = taps.shape
    pairs = taps.view(torch.bfloat16).reshape(o, i, tw, 2).float()
    out = torch.full((o * TB, i * s), float("nan"))
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for kc in range(0, s, 16):
            j = kc + c - g + 15
            for dj, dr, dc in ((0, 0, 0), (-8, 8, 0), (8, 0, 8), (0, 8, 8)):
                for e in range(2):
                    col = torch.arange(i) * s + kc + c + dc + e
                    out.view(o, TB, i * s)[:, g + dr][:, col] = (
                        pairs[:, :, j + dj, e])
    return out


def emulate(x, weights, biases, padding, activation, dtype):
    """The kernel's schedule in plain torch: ping-pong buffers
    ``[feature, row, signal]`` of the plan's size, one banded product per
    block of ``TB`` positions, the epilogue's mask and zero tails."""
    plan = mma_plan(x.shape[1], [tuple(w.shape) for w in weights], padding)
    assert plan is not None
    act = _ACTIVATIONS[activation]
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    n = x.shape[0]
    feat = max([1] + [w.shape[0] for w in weights])
    # rows the kernel never zeroes or writes hold garbage
    bufs = [torch.full((feat, plan.buf_rows, n), float("nan"))
            for _ in range(2)]
    for buf in bufs:
        buf[:, :ZR] = 0
    bufs[0][0, ZR:ZR + x.shape[1]] = rnd(x).T
    bufs[0][0, ZR + x.shape[1]:plan.in_zero_end] = 0
    cur = 0
    for w, b, lp in zip(weights, biases, plan.layers):
        src, dst = bufs[cur], bufs[1 - cur]
        a = band(rnd(w), TB, lp.s, 0)
        tau = torch.arange(lp.out_feat * TB) % TB
        for blk in range(lp.n_blk):
            t0 = blk * TB
            start = plan.win0 + t0
            win = src[:lp.in_feat, start:start + lp.s]
            assert win.shape[1] == lp.s, "window past the buffer's end"
            y = a @ win.reshape(lp.in_feat * lp.s, n)
            y = act(y + b.float().repeat_interleave(TB)[:, None])
            y = torch.where((t0 + tau < lp.t_out)[:, None], y, 0.0)
            assert ZR + t0 + TB <= plan.buf_rows
            dst[:lp.out_feat, ZR + t0:ZR + t0 + TB] = rnd(y).reshape(
                lp.out_feat, TB, n)
        dst[:lp.out_feat, ZR + TB * lp.n_blk:lp.zero_end] = 0
        cur = 1 - cur
    last = plan.layers[-1]
    return bufs[cur][:last.out_feat, ZR:ZR + last.t_out].permute(2, 1, 0)


def _case(ks, widths, length, seed=0, scale=0.3, n=1000):
    ws, bs = make_stack(ks, widths, seed=seed, scale=scale)
    x = np.random.default_rng(seed + 7).normal(size=(n, length))
    return ws, bs, x.astype(np.float32)


@pytest.mark.parametrize("ks,widths,length,pad,act", STACKS, ids=IDS)
def test_band_follows_jax_pack_band(ks, widths, length, pad, act):
    """With the JAX plan's window (``s_pad`` rows from the aligned row
    ``t0``, i.e. ``off = _Z - pad``), the band equals ``_pack_band``."""
    ws, _, _ = _case(ks, widths, length)
    shapes = [w.shape for w in ws]
    layers, _ = _plan(length, shapes, pad)
    tws, _ = torch_layout(ws, [np.zeros(w.shape[2]) for w in ws])
    for w_jax, w, lp in zip(ws, tws, layers):
        want = np.asarray(_pack_band(jnp.asarray(w_jax), lp, jnp.float32))
        got = band(w, lp.tb, lp.s_pad, _Z - pad).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks,widths,length,pad,act", STACKS, ids=IDS)
def test_pair_table_fragments_equal_band(ks, widths, length, pad, act):
    ws, _, _ = _case(ks, widths, length)
    tws, _ = torch_layout(ws, [np.zeros(w.shape[2]) for w in ws])
    plan = mma_plan(length, [tuple(w.shape) for w in tws], pad)
    for w, lp in zip(tws, plan.layers):
        taps = pack_taps(w, lp.s)
        assert taps.shape == (lp.out_feat, lp.in_feat, lp.s + 16)
        want = band(w.to(torch.bfloat16).float(), TB, lp.s, 0)
        torch.testing.assert_close(band_from_taps(taps, lp.s), want,
                                   atol=0, rtol=0)


@pytest.mark.parametrize("ks,widths,length,pad,act", STACKS, ids=IDS)
def test_emulation_matches_reference_and_pallas(ks, widths, length, pad,
                                                act):
    ws, bs, x = _case(ks, widths, length)
    tws, tbs = torch_layout(ws, bs)
    xt = torch.as_tensor(x)
    got = emulate(xt, tws, tbs, pad, act, torch.float32)
    ref = conv_stack_reference(xt, tws, tbs, pad, act, torch.float32)
    torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-4)
    want = np.asarray(conv_stack_fused(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), padding=pad, activation=act,
        compute_dtype=jnp.float32, block_lanes=512, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("ks,widths,length,pad,act", STACKS, ids=IDS)
def test_emulation_bf16_matches_reference(ks, widths, length, pad, act):
    ws, bs, x = _case(ks, widths, length, seed=1, scale=None)
    tws, tbs = torch_layout(ws, bs)
    xt = torch.as_tensor(x)
    got = emulate(xt, tws, tbs, pad, act, torch.bfloat16)
    ref = conv_stack_reference(xt, tws, tbs, pad, act, torch.bfloat16)
    torch.testing.assert_close(got, ref, atol=3e-2, rtol=2e-2)


def test_route_rule():
    flagship = [torch.zeros(5, 1, 1)] + [
        torch.zeros(5, 5, k) for k in (33, 64, 15, 15, 15, 1)]
    wide = [torch.zeros(8, 1, 3), torch.zeros(16, 8, 3)]
    bf16, f32 = torch.bfloat16, torch.float32
    assert kernel_for(256, flagship, 1, bf16) is _cuda.CONV_STACK_MMA
    assert kernel_for(256, flagship, 1, f32) is _cuda.CONV_STACK
    # padding past the 16 leading zero rows
    assert kernel_for(256, [torch.zeros(5, 1, 33)], 17, bf16) is (
        _cuda.CONV_STACK)
    # 16 features at L = 256: two buffers of 16 x 290 rows x 32 bytes
    assert mma_plan(256, [tuple(w.shape) for w in wide], 1) is None
    assert kernel_for(256, wide, 1, bf16) is _cuda.CONV_STACK
    assert kernel_for(64, wide, 1, bf16) is _cuda.CONV_STACK_MMA
    # the plain version counts on the kernel it stands in for: the route
    # of its batch (3 signals: the cluster kernel)
    bs = [torch.zeros(5)] * 7
    kernels = (_cuda.CONV_STACK_MMA_CLUSTER, _cuda.CONV_STACK_MMA,
               _cuda.CONV_STACK)
    before = [k.plain_calls for k in kernels]
    conv_stack_reference(torch.zeros(3, 256), flagship, bs, 1, "silu", bf16)
    assert [k.plain_calls for k in kernels] == [before[0] + 1, *before[1:]]


def test_flagship_plan_fits_two_ctas_per_sm():
    plan = mma_plan(256, [(5, 1, 1)] + [(5, 5, k)
                                        for k in (33, 64, 15, 15, 15, 1)], 1)
    assert [lp.s for lp in plan.layers] == [16, 48, 80, 32, 32, 32, 16]
    assert [lp.t_out for lp in plan.layers] == [258, 228, 167, 155, 143,
                                                131, 133]
    assert 2 * (plan.smem + 1024) <= 228 * 1024


def test_inplace_weight_update_repacks():
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(5, 1, 3, generator=g), torch.randn(5, 5, 3, generator=g)]
    bs = [torch.randn(5, generator=g), torch.randn(5, generator=g)]
    calls = []

    def pack():
        calls.append(1)
        return pack_taps(ws[1], 32).clone()

    k = _cuda.CONV_STACK_MMA
    first = packed_weights(k, ws, bs, torch.bfloat16, pack)
    assert packed_weights(k, ws, bs, torch.bfloat16, pack) is first
    assert len(calls) == 1
    ws[1].add_(1.0)
    again = packed_weights(k, ws, bs, torch.bfloat16, pack)
    assert len(calls) == 2 and not torch.equal(again, first)
    assert torch.equal(again, pack_taps(ws[1], 32))
    bs[0].mul_(2.0)  # a bias update repacks too
    packed_weights(k, ws, bs, torch.bfloat16, pack)
    assert len(calls) == 3
    # the other kernel's packing is kept apart
    packed_weights(_cuda.CONV_STACK, ws, bs, torch.bfloat16, pack)
    assert len(calls) == 4
