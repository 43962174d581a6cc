"""The cluster K3 kernel's schedule (``csrc/conv_stack_mma_cluster.cu``),
emulated in plain torch on the CPU: the plan (``cluster_plan``: each
layer's tasks split over the CTAs of a cluster, the halo rows each CTA
receives from their owners, the shared memory), the route, and a
segmented emulation in which each CTA computes its tasks only from its own
buffers (its own rows, which it wrote, and the halo, copied from the CTAs
that wrote it; zeros where no task wrote), with the block product of
``test_torch_port_conv_band.emulate``.

The segmented emulation equals the unsegmented one bit for bit in
bfloat16 (the kernel's claim against ``conv_stack_mma.cu``: the same
products on the same rows), and JAX's ``conv_stack_fused`` in interpret
mode in float32 within atol 5e-4, rtol 1e-4 (the bar of
test_torch_port_conv_stack.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.ops.pallas_conv import conv_stack_fused
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    _ACTIVATIONS,
    CLUSTER_CTAS,
    CLUSTER_MAX_CTAS,
    LAYER_TABLE,
    ClusterLayer,
    MMA_SIGNALS,
    SMEM_LIMIT,
    TB,
    ZR,
    cluster_desc,
    cluster_plan,
    conv_stack_reference,
    kernel_for,
    mma_plan,
    split_runs,
    warp_load,
)

from test_torch_port_conv_band import IDS, STACKS, _case, band, emulate
from test_torch_port_conv_stack import torch_layout

FLAGSHIP = [(5, 1, 1)] + [(5, 5, k) for k in (33, 64, 15, 15, 15, 1)]
#: (length, shapes, padding) of every plan checked: the flagship at the
#: fleet's and the realtime classifier's lengths, and the band tests'
#: stacks
PLANS = [(256, FLAGSHIP, 1), (512, FLAGSHIP, 1)] + [
    (length, [(o, i, k) for o, i, k in zip(
        widths, (1,) + tuple(widths[:-1]), ks)], pad)
    for ks, widths, length, pad, _ in STACKS]
PLAN_IDS = ["flagship-256", "flagship-512"] + IDS


def _plans():
    return [pytest.param(length, shapes, pad, ctas, id=f"{name}-{ctas}")
            for (length, shapes, pad), name in zip(PLANS, PLAN_IDS)
            for ctas in (8, 16)]


@pytest.mark.parametrize("length,shapes,pad,ctas", _plans())
def test_plan_splits_every_task_once(length, shapes, pad, ctas):
    plan = cluster_plan(length, shapes, pad, 48, ctas)
    mma = mma_plan(length, shapes, pad)
    assert plan is not None and plan.ctas == ctas and plan.groups == 3
    most = max(lp.n_pair for lp in plan.layers)
    assert plan.ranges == split_runs(most, ctas)
    for lp, mp in zip(plan.layers, mma.layers):
        assert lp.n_pair * 2 == mp.n_blk and lp.s == mp.s
        # contiguous runs, in rank order, covering every task once: each
        # CTA's fixed range clipped to the layer's tasks
        owned = [p for p0, p1 in lp.runs for p in range(p0, p1)]
        assert owned == list(range(lp.n_pair))
        assert lp.runs == tuple((min(p0, lp.n_pair), min(p1, lp.n_pair))
                                for p0, p1 in plan.ranges)
        assert max(p1 - p0 for p0, p1 in lp.runs) <= -(-most // ctas)
        # each CTA's warp units: every (task, feature) once
        for c in range(ctas):
            got = sorted((p, f) for p, f0, nf in lp.units(c)
                         for f in range(f0, f0 + nf))
            p0, p1 = lp.runs[c]
            assert got == [(p, f) for p in range(p0, p1)
                           for f in range(lp.out_feat)]
            assert all(1 <= nf <= min(5, lp.fg) for _, _, nf in lp.units(c))
            # on the busiest CTA no other unit size gives its busiest warp
            # fewer products a step
            if p1 - p0 == max(q1 - q0 for q0, q1 in lp.runs):
                load = max(warp_load(lp.units(c)))
                for fg in range(1, min(5, lp.out_feat) + 1):
                    other = ClusterLayer(lp.in_feat, lp.out_feat, lp.t_out,
                                         lp.s, lp.n_pair, lp.runs, fg)
                    assert load <= max(warp_load(other.units(c)))


@pytest.mark.parametrize("length,shapes,pad,ctas", _plans())
def test_plan_halo_rows_have_one_owner(length, shapes, pad, ctas):
    """Every row a CTA's next-layer tasks read is written by exactly one
    CTA of its cluster in the layer before (its own rows by itself, the
    halo by another), or is a row no task writes (before ZR, past the last
    task), which the kernel zeroes as the tensor-core kernel's buffers
    hold zeros there; the reads and writes lie in the CTA's buffers, and
    an owner's rows lie in its own."""
    plan = cluster_plan(length, shapes, pad, 1, ctas)
    mma = mma_plan(length, shapes, pad)
    for li, lp in enumerate(plan.layers):
        for c in range(ctas):
            r0, r1 = lp.reads(c, plan.win0)
            w0, w1 = lp.writes(c)
            lo, hi = plan.base(c), plan.base(c) + plan.in_rows
            assert plan.base(c) % 8 == 0
            assert r0 == r1 or lo <= r0 < r1 <= hi
            assert w0 == w1 or lo <= w0 < w1 <= hi
            if li == 0:
                # the input's rows: x at [ZR, ZR + L), zeros elsewhere
                assert r0 >= 0 and r1 <= mma.in_zero_end
                continue
            prev = plan.layers[li - 1]
            assert r1 <= mma.layers[li - 1].zero_end
            halo = plan.halo(li - 1, c)
            for row in range(r0, r1):
                writers = [k for k in range(ctas)
                           if prev.writes(k)[0] <= row < prev.writes(k)[1]]
                own = plan.owner(li - 1, row)
                assert writers == ([] if own is None else [own])
                assert (row in halo) == (own not in (None, c))
                if own is None:
                    assert row < ZR or row >= ZR + 2 * TB * prev.n_pair
                else:  # where the owner keeps it
                    assert plan.base(own) <= row < (plan.base(own)
                                                    + plan.in_rows)
            # at most the windows' reach past the range, and padding
            # rows before it
            assert len(halo) <= lp.s - TB + pad


@pytest.mark.parametrize("length,shapes,pad,ctas", _plans())
def test_plan_shared_memory_fits(length, shapes, pad, ctas):
    plan = cluster_plan(length, shapes, pad, 1, ctas)
    feat = max(o for o, _, _ in shapes)
    assert plan.max_feat == feat
    assert plan.taps_words == sum(o * i * (lp.s + 16) for (o, i, _), lp in
                                  zip(shapes, plan.layers))
    assert plan.taps_words % 4 == 0
    assert plan.in_rows % 8 == 0
    assert plan.smem == (feat * 2 * plan.in_rows * 32 + 4 * plan.taps_words
                         + 16 * -(-plan.bias_words // 4) + 4 * LAYER_TABLE)
    assert plan.smem <= SMEM_LIMIT
    d = cluster_desc(plan, 48, length, "silu")
    assert list(d.range)[:ctas + 1] == [p0 for p0, _ in plan.ranges] + [
        plan.ranges[-1][1]]
    assert list(d.n_pair)[:len(shapes)] == [lp.n_pair for lp in plan.layers]


def test_flagship_512_plan():
    """The realtime classifier's stack on clusters of 8 CTAs: at most two
    tasks each past layer 0 (three there), units of two features (8
    products a step on the busiest warp); its buffers a fraction of the
    tensor-core kernel's.  On 16 (the route's), one task each past layer
    0, in units of one feature (4 a step)."""
    plan = cluster_plan(512, FLAGSHIP, 1, 48, 8)
    assert plan.ctas == 8 and plan.groups == 3
    assert [lp.n_pair for lp in plan.layers] == [17, 16, 14, 13, 13, 13, 13]
    assert [max(p1 - p0 for p0, p1 in lp.runs) for lp in plan.layers] == [
        3, 2, 2, 2, 2, 2, 2]
    assert [lp.fg for lp in plan.layers] == [1, 2, 2, 2, 2, 2, 2]
    assert [max(warp_load(lp.units(7))) for lp in plan.layers] == [
        8, 8, 0, 0, 0, 0, 0]
    wide = cluster_plan(512, FLAGSHIP, 1, 48)
    assert wide.ctas == CLUSTER_CTAS == 16
    assert [max(p1 - p0 for p0, p1 in lp.runs) for lp in wide.layers] == [
        2, 1, 1, 1, 1, 1, 1]
    assert [lp.fg for lp in wide.layers] == [2, 1, 1, 1, 1, 1, 1]
    assert max(warp_load(wide.layers[2].units(0))) == 4
    assert plan.ranges == ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                           (10, 12), (12, 14), (14, 17))
    # CTA 1's K = 64 windows: rows 79 to 222 from its base, 64
    assert plan.in_rows == 144
    assert plan.smem == 5 * 2 * 144 * 32 + 4 * 8560 + 16 * 9 + 4 * 145
    assert plan.smem < mma_plan(512, FLAGSHIP, 1).smem / 2
    assert split_runs(14, 8) == ((0, 1), (1, 2), (2, 4), (4, 6), (6, 8),
                                 (8, 10), (10, 12), (12, 14))


def test_route_rule_by_batch():
    """The cluster kernel takes a bf16 stack with a tensor-core plan where
    the tensor-core kernel's CTAs (one per 16 signals) would leave the card
    mostly idle; without a batch the route is the old one."""
    flagship = [torch.zeros(s) for s in FLAGSHIP]
    bf16 = torch.bfloat16
    cluster, mma = _cuda.CONV_STACK_MMA_CLUSTER, _cuda.CONV_STACK_MMA
    assert kernel_for(512, flagship, 1, bf16, 48) is cluster
    assert kernel_for(256, flagship, 1, bf16, 131072) is mma
    assert kernel_for(256, flagship, 1, bf16) is mma
    most = CLUSTER_MAX_CTAS * MMA_SIGNALS
    assert kernel_for(256, flagship, 1, bf16, most) is cluster
    assert kernel_for(256, flagship, 1, bf16, most + 1) is mma
    assert kernel_for(512, flagship, 1, torch.float32, 48) is (
        _cuda.CONV_STACK)
    # no tensor-core plan: 16 features at L = 256
    wide = [torch.zeros(8, 1, 3), torch.zeros(16, 8, 3)]
    assert kernel_for(256, wide, 1, bf16, 48) is _cuda.CONV_STACK
    # the plain version and the backward count on the batch's route
    bs = [torch.zeros(5)] * 7
    before = (cluster.plain_calls, mma.plain_calls)
    conv_stack_reference(torch.zeros(48, 512), flagship, bs, 1, "silu", bf16)
    assert (cluster.plain_calls, mma.plain_calls) == (before[0] + 1,
                                                      before[1])


def emulate_cluster(x, weights, biases, padding, activation, dtype,
                    ctas=CLUSTER_CTAS):
    """The cluster kernel's schedule in plain torch: per CTA two buffers
    ``[feature, in_rows, signal]`` over its fixed span of rows, alternating
    by layer (NaN where nothing is written); each task's two blocks from
    the CTA's current buffer into its next one; then each CTA zeroes the
    rows of its next windows no task wrote and copies the halo from its
    owners' next buffers; the output from each CTA's last buffer."""
    length = x.shape[1]
    shapes = [tuple(w.shape) for w in weights]
    n = x.shape[0]
    plan = cluster_plan(length, shapes, padding, n, ctas)
    assert plan is not None
    act = _ACTIVATIONS[activation]
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    nan = float("nan")
    bufs = [[torch.full((plan.max_feat, plan.in_rows, n), nan)
             for _ in range(2)] for _ in range(ctas)]
    xr = rnd(x).T
    for c in range(ctas):
        r0, r1 = plan.layers[0].reads(c, plan.win0)
        for row in range(r0, r1):
            t = row - ZR
            bufs[c][0][0, row - plan.base(c)] = (
                xr[t] if 0 <= t < length else 0.0)
    n_layers = len(plan.layers)
    for li, (w, b, lp) in enumerate(zip(weights, biases, plan.layers)):
        a = band(rnd(w), TB, lp.s, 0)
        tau = torch.arange(lp.out_feat * TB) % TB
        cur, nxt = li % 2, (li + 1) % 2
        for c in range(ctas):
            p0, p1 = lp.runs[c]
            base = plan.base(c)
            for blk in range(2 * p0, 2 * p1):
                t0 = blk * TB
                start = plan.win0 + t0 - base
                win = bufs[c][cur][:lp.in_feat, start:start + lp.s]
                assert win.shape[1] == lp.s, "window past the buffer's end"
                # test_torch_port_conv_band.emulate's block product
                y = a @ win.reshape(lp.in_feat * lp.s, n)
                y = act(y + b.float().repeat_interleave(TB)[:, None])
                y = torch.where((t0 + tau < lp.t_out)[:, None], y, 0.0)
                o0 = ZR + t0 - base
                bufs[c][nxt][:lp.out_feat, o0:o0 + TB] = rnd(y).reshape(
                    lp.out_feat, TB, n)
        if li + 1 == n_layers:
            break
        for c in range(ctas):  # zero rows, then the halo from its owners
            r0, r1 = plan.layers[li + 1].reads(c, plan.win0)
            for row in range(r0, r1):
                own = plan.owner(li, row)
                if own != c:
                    bufs[c][nxt][:lp.out_feat, row - plan.base(c)] = (
                        0.0 if own is None else bufs[own][nxt][
                            :lp.out_feat, row - plan.base(own)])
    last = plan.layers[-1]
    res = torch.full((n, last.t_out, last.out_feat), nan)
    for c in range(ctas):
        p0, p1 = last.runs[c]
        t_lo, t_hi = 2 * TB * p0, min(2 * TB * p1, last.t_out)
        if t_hi > t_lo:
            o0 = ZR + t_lo - plan.base(c)
            res[:, t_lo:t_hi] = bufs[c][n_layers % 2][
                :last.out_feat, o0:o0 + t_hi - t_lo].permute(2, 1, 0)
    return res


def _segment_cases():
    cases = [pytest.param(((1, 33, 64, 15, 15, 15, 1), (5,) * 7, length, 1,
                           "silu"), ctas, id=f"flagship-{length}-{ctas}")
             for length in (256, 512) for ctas in (8, 16)]
    cases += [pytest.param(st, 8, id=f"{name}-8")
              for st, name in zip(STACKS[1:], IDS[1:])]
    return cases


@pytest.mark.parametrize("stack,ctas", _segment_cases())
def test_segmented_emulation_bf16_equals_unsegmented(stack, ctas):
    """Bit for bit (atol 0): each CTA's tasks from its own run and the halo
    copied from its owners give the tensor-core kernel's products."""
    ks, widths, length, pad, act = stack
    ws, bs, x = _case(ks, widths, length, seed=3, scale=None, n=20)
    tws, tbs = torch_layout(ws, bs)
    xt = torch.as_tensor(x)
    got = emulate_cluster(xt, tws, tbs, pad, act, torch.bfloat16, ctas)
    want = emulate(xt, tws, tbs, pad, act, torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("stack,ctas", _segment_cases())
def test_segmented_emulation_f32_matches_pallas(stack, ctas):
    ks, widths, length, pad, act = stack
    ws, bs, x = _case(ks, widths, length, seed=4, n=3)
    tws, tbs = torch_layout(ws, bs)
    got = emulate_cluster(torch.as_tensor(x), tws, tbs, pad, act,
                          torch.float32, ctas)
    want = np.asarray(conv_stack_fused(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), padding=pad, activation=act,
        compute_dtype=jnp.float32, block_lanes=512, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-4)
