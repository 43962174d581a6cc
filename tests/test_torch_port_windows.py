"""Hit lists and window gathers (the plain versions of kernels K2 and K4)
against ``onset_fingerprinting_tpu.ops.windows``.  Bar: bit-exact — the JAX
gathers run at ``Precision.HIGHEST``, where the lane select is exact, and
the roll gather is a pure permutation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.ops import windows as jw
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops import windows as tw

HI = jax.lax.Precision.HIGHEST


def events(nb, n_streams, cps, p, seed):
    rng = np.random.default_rng(seed)
    on = rng.random((nb, n_streams * cps)) < p
    deltas = rng.integers(0, 128, (nb, n_streams * cps)).astype(np.int32)
    return on, deltas


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("with_deltas", [False, True])
@pytest.mark.parametrize("capacity", [2, 6])
def test_top_hit_blocks(with_deltas, capacity):
    on, deltas = events(40, 32, 4, 0.03, seed=capacity)
    d_t = torch.as_tensor(deltas) if with_deltas else None
    d_j = jnp.asarray(deltas) if with_deltas else None
    st_t, v_t = tw.top_hit_blocks(torch.as_tensor(on), 128, 32, capacity, d_t)
    st_j, v_j = jw.top_hit_blocks(jnp.asarray(on), 128, 32, capacity, d_j)
    assert int(v_t.sum()) > 0
    eq(st_t, st_j)
    eq(v_t, v_j)
    assert st_t.dtype == torch.int32


@pytest.mark.parametrize("capacity", [16, 1024])
def test_compact_hits(capacity):
    on, _ = events(30, 16, 4, 0.05, seed=7)
    out_t = tw.compact_hits(torch.as_tensor(on), 128, 16, capacity)
    out_j = jw.compact_hits(jnp.asarray(on), 128, 16, capacity)
    for t, j in zip(out_t, out_j):
        eq(t, j)
    assert (int(out_t[3]) > 0) == (capacity == 16)


@pytest.mark.parametrize("capacity", [20, 512])
@pytest.mark.parametrize("return_indices", [False, True])
def test_compact_hit_list(capacity, return_indices):
    on, deltas = events(40, 32, 4, 0.03, seed=11)
    st_j, v_j = jw.top_hit_blocks(jnp.asarray(on), 128, 32, 6,
                                  jnp.asarray(deltas))
    out_j = jw.compact_hit_list(st_j, v_j, capacity, return_indices)
    out_t = tw.compact_hit_list(torch.as_tensor(np.array(st_j)),
                                torch.as_tensor(np.array(v_j)), capacity,
                                return_indices)
    assert len(out_t) == len(out_j) == (5 if return_indices else 4)
    for t, j in zip(out_t, out_j):
        eq(t, j)
    # overflow is counted, never silent
    assert int(out_t[3]) == max(int(np.asarray(v_j).sum()) - capacity, 0)
    assert (int(out_t[3]) > 0) == (capacity == 20)


def hits(t, n_streams, n, seed, window):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, t, n).astype(np.int32)
    # both clip edges and in-between residuals
    starts[:5] = [0, 3, t - 1, t - window - 3, 64 + 5]
    sids = rng.integers(0, n_streams, n).astype(np.int32)
    return starts, sids


@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gather_hit_windows(anchored, backend):
    t, c, cps, w, pre = 1024, 128, 4, 256, 64
    x = np.random.default_rng(0).normal(size=(t, c)).astype(np.float32)
    starts, sids = hits(t, c // cps, 37, seed=1, window=w)
    want = jw.gather_hit_windows(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(sids), cps, w, pre,
        backend=backend, interpret=True, precision=HI, anchored=anchored,
    )
    before = _cuda.GATHER.plain_calls
    got = tw.gather_hit_windows(torch.as_tensor(x), torch.as_tensor(starts),
                                torch.as_tensor(sids), cps, w, pre, anchored)
    assert _cuda.GATHER.plain_calls == before + 1
    assert got.shape == (37, cps, w)
    eq(got, want)


@pytest.mark.parametrize("anchored", [True, False])
def test_gather_block_windows(anchored):
    t, c, cps, w, pre = 768, 64, 2, 128, 32
    x = np.random.default_rng(2).normal(size=(t, c)).astype(np.float32)
    rng = np.random.default_rng(3)
    block_starts = (rng.integers(0, t // 128, (c // cps, 3)) * 128).astype(
        np.int32)
    want = jw.gather_block_windows(
        jnp.asarray(x), jnp.asarray(block_starts), cps, w, pre,
        backend="xla", precision=HI, anchored=anchored,
    )
    got = tw.gather_block_windows(torch.as_tensor(x),
                                  torch.as_tensor(block_starts), cps, w, pre,
                                  anchored)
    assert got.shape == (c // cps, 3, cps, w)
    eq(got, want)


def test_gather_rejects_short_input():
    x = torch.zeros((100, 8))
    with pytest.raises(ValueError, match="shorter"):
        tw.gather_hit_windows(x, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 4, 96,
                              anchored=True)


@pytest.mark.parametrize("cps", [1, 2, 4, 8])
def test_gather_windows_roll_matches_jax_interpret(cps):
    """K4's plain version == the Pallas roll kernel in interpret mode,
    including the in-tile lane wrap and the start clamp."""
    t, c, w = 500, 256, 64
    groups = 128 // cps
    rng = np.random.default_rng(cps)
    x = rng.normal(size=(t, c)).astype(np.float32)
    n = 24
    row_start = rng.integers(0, t, n).astype(np.int32)
    sids = rng.integers(0, c // cps, n).astype(np.int32)
    # tile-edge streams (lanes wrap inside their own tile), starts past
    # T - W (clamped to T - W: 496 reads from 436) and off-8 starts
    sids[:4] = [groups - 1, groups, 2 * groups - 1, c // cps - 1]
    row_start[:4] = [496, 3, t - 1, t - w + 5]
    want = jw._gather_pallas_roll(jnp.asarray(x), jnp.asarray(row_start),
                                  jnp.asarray(sids), cps, w, interpret=True)
    before = _cuda.GATHER_ROLL.plain_calls
    got = tw.gather_windows_roll(torch.as_tensor(x),
                                 torch.as_tensor(row_start),
                                 torch.as_tensor(sids), cps, w)
    assert _cuda.GATHER_ROLL.plain_calls == before + 1
    assert got.shape == (n, w, 8) and got.dtype == torch.float32
    eq(got, want)
    # the contract, written out for the wrapping stream of hit 0
    r = 436
    lanes = (groups - 1) * cps + np.arange(8)
    np.testing.assert_array_equal(got[0].numpy(),
                                  x[r:r + w][:, lanes % 128])


def test_gather_windows_roll_equals_block_aligned_gather():
    t, c, cps, w, pre = 1024, 256, 4, 256, 64
    x = np.random.default_rng(8).normal(size=(t, c)).astype(np.float32)
    starts, sids = hits(t, c // cps, 37, seed=9, window=w)
    starts_t = torch.as_tensor(starts)
    rows8 = torch.clamp(starts_t - pre, 0, t - w) // 8 * 8
    roll = tw.gather_windows_roll(torch.as_tensor(x), rows8,
                                  torch.as_tensor(sids), cps, w)
    block = tw.gather_hit_windows(torch.as_tensor(x), starts_t,
                                  torch.as_tensor(sids), cps, w, pre)
    assert torch.equal(roll[:, :, :cps].transpose(1, 2), block)


@pytest.mark.parametrize("c,cps", [(96, 4), (384, 3)])
def test_gather_windows_roll_rejects_narrow_layout(c, cps):
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="wide layout"):
        tw.gather_windows_roll(torch.zeros((300, c)), z, z, cps, 64)


# ---- the redesigned gathers' routes and addressing (the card kernels are
# ---- held to the plain versions in test_torch_port_cuda.py)

@pytest.mark.parametrize("cps,w,ptr,want,variant", [
    (4, 256, 0, "gather_vec", "cps4"),  # the fleet path
    (1, 256, 0, "gather_vec", "cps1"),
    (2, 256, 0, "gather_vec", "cps2"),  # also a ragged C, C % 4 == 2
    (8, 64, 0, "gather_vec", "cps8"),
    (3, 256, 0, "gather", ""),  # an odd cps: no instantiation
    (4, 254, 0, "gather", ""),  # W % 4 != 0
    (4, 256, 8, "gather", ""),  # x 8-byte aligned: no 16-byte loads
    (2, 256, 8, "gather_vec", "cps2"),  # 8 bytes are enough at V = 2
])
def test_gather_kernel_for(cps, w, ptr, want, variant):
    route = tw.gather_kernel_for(cps, w, ptr)
    assert (route.kernel.name, route.variant) == (want, variant)
    assert route.entry in route.kernel.entries


@pytest.mark.parametrize("cps,w,ptr,want,variant", [
    (4, 256, 0, "gather_roll_vec", "v4"),  # the anatomy
    (1, 64, 0, "gather_roll_vec", "v1"),
    (2, 64, 0, "gather_roll_vec", "v2"),
    (8, 256, 0, "gather_roll_vec", "v4"),
    (4, 255, 0, "gather_roll", ""),  # W * 2 % 4 != 0
    (4, 256, 4, "gather_roll", ""),  # x 4-byte aligned only
])
def test_roll_kernel_for(cps, w, ptr, want, variant):
    route = tw.roll_kernel_for(cps, w, ptr)
    assert (route.kernel.name, route.variant) == (want, variant)
    assert route.entry in route.kernel.entries


def test_every_shape_routes_to_a_kernel():
    """Any shape the wrappers accept names a kernel record, one of its C
    entry points, and the row-vector kernel wherever it takes the shape."""
    for cps in range(1, 17):
        for w in (1, 2, 3, 4, 64, 254, 256, 300):
            for ptr in (0, 4, 8, 16):
                routes = tw.gather_routes(cps, w, ptr)
                route = tw.gather_kernel_for(cps, w, ptr)
                assert route.kernel in _cuda.KERNELS
                assert route.entry in route.kernel.entries
                assert route == routes.get("vec", routes["old"])
                if 128 % cps == 0:
                    routes = tw.roll_routes(cps, w, ptr)
                    route = tw.roll_kernel_for(cps, w, ptr)
                    assert route.kernel in (_cuda.GATHER_ROLL_VEC,
                                            _cuda.GATHER_ROLL)
                    assert route.entry in route.kernel.entries
                    assert route == routes.get("vec", routes["old"])


def replay_gather_vec(x, starts, sids, cps, w, pre, anchored):
    """``gather_vec.cu`` on the CPU: each thread's item (CTA e // 256,
    thread e % 256) its loads, then its stores of the register transpose,
    into a NaN-filled output (a store that lands twice or never is
    caught)."""
    t, c = x.shape
    n = starts.shape[0]
    v = tw.vec_width(cps)
    loads, stores = tw.gather_vec_addresses(starts, sids, t, c, cps, w, pre,
                                            anchored)
    assert loads.shape == (n, w // 4, 4, cps // v)
    assert stores.shape == (n, w // 4, cps)
    assert bool((loads % v == 0).all()) and bool((stores % 4 == 0).all())
    xf = x.reshape(-1)
    out = torch.full((n * cps * w,), float("nan"))
    hits = torch.zeros(n * cps * w, dtype=torch.int64)
    quads = w // 4
    for e in range(n * quads):
        i, q = divmod(e, quads)
        regs = xf[loads[i, q][..., None] + torch.arange(v)]  # [4, cps/V, V]
        regs = regs.reshape(4, cps)  # row r, channel j * V + k
        for ch in range(cps):
            at = stores[i, q, ch] + torch.arange(4)
            out[at] = regs[:, ch]  # one 16-byte store: rows 4q .. 4q+3
            hits[at] += 1
    assert bool((hits == 1).all())
    return out.reshape(n, cps, w)


def cut_hits(t, n_streams, n, seed, window, pre):
    """``n`` hits with both clip edges (and for n > 5 in-between
    residuals), streams at both ends."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, t, n).astype(np.int32)
    sids = rng.integers(0, n_streams, n).astype(np.int32)
    edge = [0, pre + 3, t - 1, t - window - 3 + pre, pre + 64 + 5][:n]
    starts[:len(edge)] = edge
    sids[:2] = [n_streams - 1, 0][:min(n, 2)]
    return starts, sids


@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("cps,c,n", [
    (4, 256, 37), (1, 256, 37), (2, 256, 37), (8, 256, 37),
    (4, 256, 1), (4, 256, 0),
    (2, 102, 37),  # ragged C (not a multiple of 4 or 128): xla reference
])
def test_gather_vec_addressing_replays_jax(anchored, cps, c, n):
    t, w, pre = 1024, 256, 64
    x = np.random.default_rng(c + cps).normal(size=(t, c)).astype(np.float32)
    starts, sids = cut_hits(t, c // cps, n, seed=n + cps, window=w, pre=pre)
    xt, st, si = (torch.as_tensor(a) for a in (x, starts, sids))
    got = replay_gather_vec(xt, st, si, cps, w, pre, anchored)
    assert torch.equal(got, tw.gather_hit_windows_reference(
        xt, st, si, cps, w, pre, anchored))
    if n == 0:
        return
    backend = "pallas" if c % 128 == 0 else "xla"
    want = jw.gather_hit_windows(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(sids), cps, w, pre,
        backend=backend, interpret=True, precision=HI, anchored=anchored,
    )
    eq(got, want)


def replay_roll_vec(x, row_start, sids, cps, w):
    """``gather_roll_vec.cu`` on the CPU: each thread's V-float loads, then
    its stores, into a NaN-filled output."""
    t, c = x.shape
    n = row_start.shape[0]
    v = tw.roll_vec_width(cps)
    loads, stores = tw.roll_vec_addresses(row_start, sids, t, c, cps, w)
    per_hit = w * 8 // (v * 4)
    assert loads.shape == stores.shape == (n, per_hit, 4)
    # aligned vectors that never straddle the tile's wrap
    assert bool((loads % v == 0).all()) and bool((stores % v == 0).all())
    assert bool(((loads % 128) + v <= 128).all())
    xf = x.reshape(-1)
    out = torch.full((n * w * 8,), float("nan"))
    hits = torch.zeros(n * w * 8, dtype=torch.int64)
    for e in range(n * per_hit):
        i, th = divmod(e, per_hit)
        regs = xf[loads[i, th][:, None] + torch.arange(v)]  # 4 loads first
        at = stores[i, th][:, None] + torch.arange(v)
        out[at] = regs
        hits[at] += 1
    assert bool((hits == 1).all())
    return out.reshape(n, w, 8)


def roll_hits(t, c, cps, n, seed, w):
    rng = np.random.default_rng(seed)
    groups = 128 // cps
    row_start = rng.integers(0, t, n).astype(np.int32)
    sids = rng.integers(0, c // cps, n).astype(np.int32)
    # tile-edge streams (the wrap), starts past T - W, negative and off-8
    edge_s = [groups - 1, groups, 2 * groups - 1, c // cps - 1, 0][:n]
    edge_r = [t - 1, -5, 3, t - w + 5, 0][:n]
    sids[:len(edge_s)] = edge_s
    row_start[:len(edge_r)] = edge_r
    return row_start, sids


@pytest.mark.parametrize("cps,n", [
    (1, 29), (2, 29), (4, 29), (8, 29), (4, 1), (4, 0)])
def test_roll_vec_addressing_replays_jax(cps, n):
    t, c, w = 500, 256, 64
    x = np.random.default_rng(cps).normal(size=(t, c)).astype(np.float32)
    row_start, sids = roll_hits(t, c, cps, n, seed=n, w=w)
    xt, rs, si = (torch.as_tensor(a) for a in (x, row_start, sids))
    got = replay_roll_vec(xt, rs, si, cps, w)
    assert torch.equal(got, tw.gather_windows_roll_reference(xt, rs, si, cps,
                                                             w))
    if n == 0:
        return
    want = jw._gather_pallas_roll(jnp.asarray(x), jnp.asarray(row_start),
                                  jnp.asarray(sids), cps, w, interpret=True)
    # the Pallas kernel floors and never clips: its interpret mode leaves a
    # negative start undefined (the hit lists never make one)
    keep = row_start >= 0
    assert not keep.all() if n > 1 else keep.all()
    eq(got[torch.as_tensor(keep)], np.asarray(want)[keep])
