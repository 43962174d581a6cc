"""K3's bf16 parity gate and its tools, on the CPU: the far-signal count
that ``chip_smoke.py`` and the card tests apply, the issued-FLOP count,
the planted race of ``tools/conv_stack_gate.py`` and its float64 witness
of a rounding flip."""

import torch

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    conv_stack_reference,
    far_signals,
    issued_flops,
    mma_plan,
)
from onset_fingerprinting_torch.tools import conv_stack_gate as gate

FLAGSHIP_SHAPES = [(5, 1, 1)] + [(5, 5, k) for k in (33, 64, 15, 15, 15, 1)]


def test_far_signals_lists_signals_past_one_bf16_ulp():
    g = torch.Generator().manual_seed(0)
    p = (0.2 * torch.randn(6, 10, 5, generator=g)).to(torch.bfloat16).float()
    k = p.clone()
    p[1, 3, 2] = 0.3
    k[1, 3, 2] = 0.3 + 2 ** -9  # one bf16 ulp at 0.3: not far
    k[4, 0, 1] += 0.01  # five ulps or more: far
    k[5, 9, 4] += 0.005
    assert far_signals(k, p).tolist() == [4, 5]
    assert far_signals(p, p).numel() == 0


def test_gate_limits():
    assert [gate.far_cap(b) for b in (37, 1000, 131072)] == [16, 16, 2048]
    assert [gate.unexplained_limit(b) for b in (37, 1000, 131072)] == [
        1, 1, 2]


def test_issued_flops_of_the_flagship():
    plan = mma_plan(256, FLAGSHIP_SHAPES, 1)
    # per signal: 2 * O * TB * I * s * n_blk summed over the seven layers
    assert issued_flops(plan, 1) == 2324480
    assert round(issued_flops(plan, 131072) / 1e9, 1) == 304.7


def test_planted_race_moves_the_zeroing_ahead_of_the_barrier():
    src = (_cuda.CSRC / _cuda.CONV_STACK_MMA.source).read_text()
    planted = gate.planted_race_source(src)
    assert planted != src
    assert sorted(planted.splitlines()) == sorted(src.splitlines())
    for text, before in ((src, False), (planted, True)):
        zero = text.index(gate._ZERO_FROM)
        barrier = text.index(gate._BARRIER)
        assert (zero < barrier) is before
        # the barrier still follows the layer's shapes
        assert text.index("const int I = d.I[l]") < barrier


def test_round_bf16_rounds_once():
    # just above the midpoint of 1 and 1 + 2**-7: a cast through float32
    # lands on the midpoint and rounds to even, 1.0
    v = torch.tensor([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30), 0.3],
                     dtype=torch.float64)
    assert float(v[0].to(torch.bfloat16)) == 1.0
    r = gate.round_bf16(v)
    assert r.tolist() == [1 + 2 ** -7, -(1 + 2 ** -7), float(
        torch.tensor(0.3).to(torch.bfloat16))]
    m = gate.boundary_margin(v)
    assert bool((m >= 0).all() and (m <= 0.5).all())
    assert float(m[0]) < 1e-6


def _flagship(n, seed=0, last_bias=0.0):
    ws, bs = gate.flagship_stack(seed, device="cpu")
    bs[-1] = bs[-1] + last_bias
    x = torch.randn(n, 256, generator=torch.Generator().manual_seed(seed))
    return x, ws, bs


def test_float64_emulation_matches_the_plain_version():
    x, ws, bs = _flagship(16)
    e, pre = gate.emulate64(x, ws, bs)
    p = conv_stack_reference(x, ws, bs, 1, "silu", torch.bfloat16)
    assert e.shape == p.shape and len(pre) == 7
    assert far_signals(e.float(), p).numel() == 0
    torch.testing.assert_close(e.float(), p, atol=3e-2, rtol=2e-2)


def _near_ties(v, n):
    """The ``n`` values ``(o, t)`` of ``v [O, T]`` in [0.5, 0.7) nearest a
    bf16 rounding boundary: one bf16 ulp (2**-8) there is a far value."""
    m = torch.where((v.abs() >= 0.5) & (v.abs() < 0.7),
                    gate.boundary_margin(v), 1.0)
    return [divmod(i, v.shape[1]) for i in m.flatten().argsort()[:n].tolist()]


def test_witness_finds_a_planted_rounding_flip():
    # outputs near 0.6
    x, ws, bs = _flagship(2, last_bias=0.9)
    e, pre = gate.emulate64(x, ws, bs)
    assert gate.witness(x[1], ws, bs, e[1].float())["explained"]
    (o, t), = _near_ties(pre[-1][1], 1)
    flipped, _ = gate.emulate64(x[1:2], ws, bs, flips=[(6, 0, o, t)])
    got = gate.witness(x[1], ws, bs, flipped[0].float())
    assert got["far"] == 1 and got["explained"]
    assert got["flip"] == (6, o, t) and got["flip_far"] == 0
    assert got["flip_margin"] < 1e-3


def test_gate_passes_one_flip_and_counts_two_as_unexplained():
    x, ws, bs = _flagship(4, last_bias=0.9)
    e, pre = gate.emulate64(x, ws, bs)
    plain = e.float()
    out = plain.clone()
    (o, t), = _near_ties(pre[-1][1], 1)
    one, _ = gate.emulate64(x[1:2], ws, bs, flips=[(6, 0, o, t)])
    out[1] = one[0].float()
    two, _ = gate.emulate64(x[3:4], ws, bs, flips=[
        (6, 0, o, t) for o, t in _near_ties(pre[-1][3], 2)])
    out[3] = two[0].float()
    far, unexplained = gate.gate(out, plain, x, ws, bs)
    assert far.tolist() == [1, 3] and unexplained == [3]
    assert gate.passes(far, unexplained, 4)
    assert not gate.passes(far, [1, 3], 4)
    # past the cap nothing is witnessed
    assert not gate.passes(torch.arange(17), [], 4)
