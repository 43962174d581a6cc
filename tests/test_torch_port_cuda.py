"""The kernels against their plain versions on the card, at small shapes
(the full-width checks are in chip_smoke.py).  Marked ``cuda``:
they skip on a machine without CUDA.  Run on the card with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda
"""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("coupled,backtrack,hipass,on_th,c,nb", [
    # per-channel gate: the pipelined kernel
    (False, False, 2000.0, 0.5, 200, 60), (False, True, 0.0, 0.5, 200, 60),
    (False, False, 2000.0, 3.0, 200, 60),  # manual (absolute) thresholds
    (False, True, 2000.0, 0.5, 237, 60),  # ragged: 13 of 32 lanes
    (False, False, 2000.0, 0.5, 200, 61),  # 488 sub-blocks: 3 x slots
    # coupled_off: the one-thread-per-channel kernel
    (True, True, 2000.0, 0.5, 200, 60), (True, False, 0.0, 0.5, 200, 60),
])
def test_detector_kernel_matches_plain(coupled, backtrack, hipass, on_th, c,
                                       nb):
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        kernel_for,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.workload import make_audio

    cfg = DetectorConfig(n_channels=c, coupled_off_gate=coupled,
                         backtrack=backtrack, backtrack_buffer_size=256,
                         hipass_freq=hipass, on_threshold=on_th,
                         off_threshold=on_th / 5)
    fst, params, st, _ = make_fused_detector(cfg)
    kernel = kernel_for(fst.plain)
    assert kernel is (_cuda.DETECTOR if coupled else _cuda.DETECTOR_PIPE)
    before = kernel.launches
    x = make_audio(128 * nb, c, seed=1)
    wk = fused_warmup_minmax(fst, params, st, x[: 128 * 38])
    wp = warmup_minmax(fst.plain, params, st, x[: 128 * 38])
    sk, (on_k, d_k, r_k) = fused_detect_offline(fst, params, wk, x)
    sp, (on_p, d_p, r_p) = detect_offline(fst.plain, params, wp, x)
    assert kernel.launches == before + 2
    assert int(on_p.sum()) > 0
    for a, b in zip(wk, wp):
        assert torch.equal(a, b)
    assert torch.equal(on_k, on_p) and torch.equal(d_k, d_p)
    assert torch.equal(r_k, r_p)
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)
    # events only: the same events, no rel
    sk2, (on_k2, d_k2, r_k2) = fused_detect_offline(fst, params, wk, x,
                                                    emit_rel=False)
    assert r_k2 is None
    assert torch.equal(on_k2, on_p) and torch.equal(d_k2, d_p)
    for a, b in zip(sk2, sp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backtrack", [False, True])
def test_detector_pipe_carries_state_across_launches(backtrack):
    """Two launches over the halves of a recording equal one launch over
    the whole, bit for bit."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.ops.fused_detector import (
        make_fused_detector,
    )
    from onset_fingerprinting_torch.workload import make_audio

    cfg = DetectorConfig(n_channels=300, hipass_freq=2000.0,
                         coupled_off_gate=False, backtrack=backtrack,
                         backtrack_buffer_size=256)
    _, _, st, run = make_fused_detector(cfg)
    x = make_audio(128 * 50, 300, seed=4)
    s_all, (on, d, rel) = run(st, x)
    s1, (on1, d1, r1) = run(st, x[: 128 * 21])
    s2, (on2, d2, r2) = run(s1, x[128 * 21:])
    assert int(on.sum()) > 0
    assert torch.equal(torch.cat([on1, on2]), on)
    assert torch.equal(torch.cat([d1, d2]), d)
    assert torch.equal(torch.cat([r1, r2]), rel)
    for a, b in zip(s2, s_all):
        assert torch.equal(a, b)


def test_fleet_detector_runs_the_pipe_kernel_only():
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import kernel_for
    from onset_fingerprinting_torch.pipeline import (
        fleet_detector_config,
        make_detect_fingerprint,
    )
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        WINDOW,
        chunk_capacities,
        make_audio,
    )

    streams, t = 64, 32000  # one chunk of the fleet path, 64 streams
    model = CCCNN(input_size=WINDOW, dtype=torch.bfloat16, **FLAGSHIP)
    run = make_detect_fingerprint(fleet_detector_config(streams), model,
                                  streams, t,
                                  chunk_capacities(streams, t)[1])
    assert kernel_for(run.static.plain) is _cuda.DETECTOR_PIPE
    pipe, old = _cuda.DETECTOR_PIPE, _cuda.DETECTOR
    before = (pipe.launches, pipe.plain_calls, old.launches, old.plain_calls)
    audio = [make_audio(t, streams * 4, seed=5 + j) for j in range(3)]
    state = run.warmup(run.init_state(), audio[0][: 128 * 38])
    events = 0
    for x in audio:
        state, on, deltas = run.detect(state, x)
        events += int(on.sum())
    assert (pipe.launches, pipe.plain_calls, old.launches,
            old.plain_calls) == (before[0] + 4, *before[1:])
    assert events > 0


@pytest.mark.parametrize("anchored", [True, False])
def test_gather_kernel_matches_plain(anchored):
    from onset_fingerprinting_torch.ops.windows import (
        gather_hit_windows,
        gather_hit_windows_reference,
    )

    rng = np.random.default_rng(0)
    x = torch.randn(4096, 256, device="cuda")
    starts = torch.as_tensor(rng.integers(0, 4096, 999).astype(np.int32),
                             device="cuda")
    sids = torch.as_tensor(rng.integers(0, 64, 999).astype(np.int32),
                           device="cuda")
    k = gather_hit_windows(x, starts, sids, 4, 256, 64, anchored)
    p = gather_hit_windows_reference(x, starts, sids, 4, 256, 64, anchored)
    assert torch.equal(k, p)


def _stack(ks, widths, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws, bs, cin = [], [], 1
    for o, k in zip(widths, ks):
        ws.append((torch.randn(o, cin, k, generator=g) / (k * cin) ** 0.5
                   ).cuda())
        bs.append((0.1 * torch.randn(o, generator=g)).cuda())
        cin = o
    return ws, bs


FLAGSHIP_KS = (1, 33, 64, 15, 15, 15, 1)


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 5e-4, 1e-4), (torch.bfloat16, 3e-2, 2e-2)])
@pytest.mark.parametrize("ks,widths,pad,length,batch,act", [
    (FLAGSHIP_KS, (5,) * 7, 1, 256, 1000, "silu"),
    ((3, 3), (8, 16), 1, 256, 1000, "silu"),
    ((7, 4), (3, 5), 0, 256, 1000, "silu"),
    # 16 features fit the tensor-core kernel's buffers at L = 64
    ((3, 3), (8, 16), 1, 64, 1000, "silu"),
    # a batch that is a multiple of neither kernel's signals per CTA
    (FLAGSHIP_KS, (5,) * 7, 1, 256, 37, "silu"),
    # the CUDA-core kernel's edges: O = 1, 5 and 9 (ragged feature
    # groups), K = 1 and 64, output lengths that are no multiple of any
    # lane tile, every activation
    ((5, 3), (4, 1), 1, 256, 300, "relu"),
    ((3, 7), (9, 9), 2, 200, 300, "tanh"),
    ((64, 1), (5, 5), 1, 256, 300, "elu"),
    ((33,), (5,), 3, 100, 100, "sigmoid"),
    ((15, 15), (5, 9), 0, 97, 50, "leakyrelu"),
    ((1, 64), (9, 1), 3, 300, 40, "linear"),
    # 16 features at every layer: no tensor-core plan in bf16
    (FLAGSHIP_KS, (16,) * 7, 1, 256, 200, "silu")])
def test_conv_stack_kernel_matches_plain(dtype, atol, rtol, ks, widths, pad,
                                         length, batch, act):
    """Each stack runs on the kernel ``kernel_for`` names for its batch
    (bf16: where the tensor-core kernel has a plan, the cluster kernel
    for a batch of at most CLUSTER_MAX_CTAS groups of 16 signals, else the
    tensor-core kernel) and equals the plain version."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        CLUSTER_MAX_CTAS,
        conv_stack,
        conv_stack_reference,
        far_signals,
        kernel_for,
        mma_plan,
    )
    from onset_fingerprinting_torch.tools.conv_stack_gate import gate, passes

    ws, bs = _stack(ks, widths)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(batch, length, generator=g).cuda()
    kernel = kernel_for(length, ws, pad, dtype, batch)
    has_plan = mma_plan(length, [tuple(w.shape) for w in ws],
                        pad) is not None
    assert has_plan == (widths[-1] != 16 or length != 256)
    small = -(-batch // 16) <= CLUSTER_MAX_CTAS
    assert kernel is (_cuda.CONV_STACK if dtype != torch.bfloat16
                      or not has_plan else _cuda.CONV_STACK_MMA_CLUSTER
                      if small else _cuda.CONV_STACK_MMA)
    before = kernel.launches
    k = conv_stack(x, ws, bs, pad, act, dtype)
    assert kernel.launches == before + 1
    p = conv_stack_reference(x, ws, bs, pad, act, dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, p, atol=atol, rtol=rtol)
    if dtype == torch.float32:
        assert far_signals(k, p).numel() == 0
    else:
        # the same rounding points: the few signals more than about one
        # bf16 ulp apart are a rounding flipped at a near-tie
        far, unexplained = gate(k, p, x, ws, bs, pad, act)
        assert passes(far, unexplained, batch), (far, unexplained)
    # under autograd the same kernel runs, as the forward of K3's Function
    before = kernel.launches
    kg = conv_stack(x.requires_grad_(), ws, bs, pad, act, dtype)
    assert kernel.launches == before + 1
    assert type(kg.grad_fn).__name__ == "_ConvStackBackward"
    assert torch.equal(kg.detach(), k)


@pytest.mark.parametrize("dtype,batch", [(torch.float32, 1001),
                                         (torch.bfloat16, 1001),
                                         (torch.float32, 37),
                                         (torch.bfloat16, 37)])
def test_conv_stack_grads_match_the_plain_chain(dtype, batch):
    """K3's Function on the card (the routed kernel forward, autograd of
    the plain chain backward) against autograd of the plain chain on the
    card: the forward at phase 1's tolerance, the grads of x, weights and
    biases within 1e-5 of their scale (f32; bf16 at its 3e-2 / 2e-2), TF32
    on in the process flags and off in the recompute.  One launch per
    forward, one recompute per backward, no plain call."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
        kernel_for,
    )

    ws, bs = _stack(FLAGSHIP_KS, (5,) * 7)
    for t in (*ws, *bs):
        t.requires_grad_()
    x = torch.randn(batch, 256, device="cuda", requires_grad=True,
                    generator=torch.Generator("cuda").manual_seed(2))
    kernel = kernel_for(256, ws, 1, dtype, batch)
    assert kernel is (_cuda.CONV_STACK if dtype == torch.float32
                      else _cuda.CONV_STACK_MMA_CLUSTER if batch == 37
                      else _cuda.CONV_STACK_MMA)
    leaves = [x, *ws, *bs]
    out = conv_stack(x, ws, bs, 1, "silu", dtype)
    ct = torch.randn(out.shape, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    counts = (kernel.launches, kernel.plain_calls,
              kernel.backward_recomputes)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = torch.autograd.grad(out, leaves, ct)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert (kernel.launches, kernel.plain_calls,
            kernel.backward_recomputes) == (*counts[:2], counts[2] + 1)
    ref = conv_stack_reference(x, ws, bs, 1, "silu", dtype)
    want = torch.autograd.grad(ref, leaves, ct)
    atol, rtol = (5e-4, 1e-4) if dtype == torch.float32 else (3e-2, 2e-2)
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert float((g - w).abs().max()) <= tol * scale


def test_bf16_dft_head_grads_match_their_emulation():
    """The bf16 head's backward (two transposed bf16 GEMMs) on the card
    against the same products emulated on the CPU, within 1e-3 of each
    gradient's scale."""
    from onset_fingerprinting_torch.ops import xcorr as tx

    a = _features(1, (16, 4, 5, 133))
    ct = _features(2, (16, 4, 265))
    grads = []
    for dev in ("cpu", "cuda"):
        x = a.detach().to(dev).requires_grad_()
        out = tx.batch_self_correlate_dft(x, 2, precision="default")
        out.backward(ct.to(dev))
        grads.append(x.grad.cpu())
    scale = float(grads[0].abs().max())
    assert scale > 0
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-3 * scale


def test_trainer_step_on_the_card_matches_the_cpu():
    """Three full-batch adam steps of the float32 flagship CCCNN from one
    init on the card (K3 forward, recompute backward) and on the CPU: the
    losses within 1e-5 relative, the trained models' predictions within
    1e-4 (a weight whose gradient is rounding residue may take its own
    adam step on each device, on a feature of the same size)."""
    from onset_fingerprinting_torch.core.config import TrainConfig
    from onset_fingerprinting_torch.models.train import (
        Trainer,
        make_optimizer,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools.fingerprint_capability import (
        flagship_f32,
    )

    g = torch.Generator().manual_seed(5)
    x = torch.randn(48, 4, 256, generator=g)
    y = torch.randn(48, 2, generator=g)
    runs = []
    for dev in ("cpu", "cuda"):
        tr = Trainer(flagship_f32(), TrainConfig(loss="l1", seed=0),
                     optimizer=make_optimizer("adam", 3e-3, "cosine", 100),
                     device=dev)
        st = tr.init_state()
        before = _cuda.CONV_STACK.launches
        losses = [float(tr.step(st, x.to(dev), y.to(dev))) for _ in range(3)]
        if dev == "cuda":
            assert _cuda.CONV_STACK.launches == before + 3
        runs.append((losses, tr.predict(st, x)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    np.testing.assert_allclose(runs[1][1], runs[0][1], atol=1e-4)


@pytest.mark.parametrize("ks,widths,pad,length,batch,act", [
    (FLAGSHIP_KS, (5,) * 7, 1, 512, 48, "silu"),
    (FLAGSHIP_KS, (5,) * 7, 1, 512, 3, "silu"),
    (FLAGSHIP_KS, (5,) * 7, 1, 256, 37, "silu"),
    (FLAGSHIP_KS, (5,) * 7, 1, 256, 1000, "silu"),
    ((3, 3), (8, 16), 1, 64, 100, "relu"),
    ((7, 4), (3, 5), 0, 256, 40, "tanh"),
    ((1, 3, 5, 3), (4,) * 4, 1, 64, 20, "elu"),
    ((15, 15), (5, 9), 0, 97, 50, "leakyrelu"),
    ((1, 64), (9, 1), 3, 300, 40, "linear"),
    ((33,), (5,), 3, 100, 17, "sigmoid")])
@pytest.mark.parametrize("ctas", [8, 16])
def test_cluster_kernel_equals_tensor_core_kernel(ks, widths, pad, length,
                                                  batch, act, ctas):
    """``conv_stack_mma_cluster.cu`` (clusters of 8 and of 16 CTAs) against
    ``conv_stack_mma.cu`` on the same inputs: bit for bit, every stack the
    tensor-core kernel has a plan for."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        _launch_cluster,
        _launch_mma,
        cluster_plan,
    )

    ws, bs = _stack(ks, widths, seed=3)
    x = torch.randn(batch, length, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    assert cluster_plan(length, [tuple(w.shape) for w in ws], pad, batch,
                        ctas) is not None
    t_out = length
    for k in ks:
        t_out += 2 * pad - k + 1
    outs = [torch.full((batch, t_out, widths[-1]), float("nan"),
                       device="cuda") for _ in range(2)]
    before = _cuda.CONV_STACK_MMA_CLUSTER.launches
    with torch.inference_mode():
        _launch_cluster(_cuda.CONV_STACK_MMA_CLUSTER, x, ws, bs, pad, act,
                        outs[0], ctas)
        _launch_mma(_cuda.CONV_STACK_MMA, x, ws, bs, pad, act, outs[1])
    torch.cuda.synchronize()
    assert _cuda.CONV_STACK_MMA_CLUSTER.launches == before + 1
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])


def test_flagship_bf16_runs_the_tensor_core_kernel_only():
    """At a batch that fills the card the route keeps the tensor-core
    kernel of a CTA per 16 signals."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        CLUSTER_MAX_CTAS,
        conv_stack,
        conv_stack_reference,
    )

    ws, bs = _stack(FLAGSHIP_KS, (5,) * 7)
    n = max(4096, 16 * CLUSTER_MAX_CTAS + 16)
    x = torch.randn(n, 256, device="cuda")
    mma, simt = _cuda.CONV_STACK_MMA, _cuda.CONV_STACK
    before = (mma.launches, mma.plain_calls, simt.launches, simt.plain_calls)
    with torch.inference_mode():
        out = conv_stack(x, ws, bs, 1, "silu", torch.bfloat16)
    assert (mma.launches, mma.plain_calls, simt.launches,
            simt.plain_calls) == (before[0] + 1, *before[1:])
    torch.cuda.synchronize()
    assert out.shape == (n, 133, 5) and bool(torch.isfinite(out).all())
    want = conv_stack_reference(x, ws, bs, 1, "silu", torch.bfloat16)
    torch.testing.assert_close(out, want, atol=3e-2, rtol=2e-2)


def test_float32_runs_the_cuda_core_kernel():
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import conv_stack

    ws, bs = _stack(FLAGSHIP_KS, (5,) * 7)
    x = torch.randn(100, 256, device="cuda")
    mma, simt = _cuda.CONV_STACK_MMA, _cuda.CONV_STACK
    before = (mma.launches, simt.launches)
    conv_stack(x, ws, bs, 1, "silu", torch.float32)
    assert (mma.launches, simt.launches) == (before[0], before[1] + 1)


def test_conv_stack_weight_update_repacks_on_the_card():
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
    )

    ws, bs = _stack(FLAGSHIP_KS, (5,) * 7)
    x = torch.randn(64, 256, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        conv_stack(x, ws, bs, 1, "silu", dtype)
        ws[2].mul_(0.5)
        bs[6].add_(0.25)
        k = conv_stack(x, ws, bs, 1, "silu", dtype)
        p = conv_stack_reference(x, ws, bs, 1, "silu", dtype)
        torch.testing.assert_close(k, p, atol=3e-2, rtol=2e-2)


def _roll_case(t=1000, c=512, n=999, cps=4, w=256):
    rng = np.random.default_rng(1)
    groups = 128 // cps
    x = torch.randn(t, c, device="cuda")
    row_start = rng.integers(0, t, n).astype(np.int32)
    sids = rng.integers(0, c // cps, n).astype(np.int32)
    # tile-edge streams (the in-tile lane wrap) and starts past T - W
    sids[:3] = [groups - 1, 2 * groups - 1, c // cps - 1]
    row_start[:3] = [t - 1, t - w + 3, 5]
    return (x, torch.as_tensor(row_start, device="cuda"),
            torch.as_tensor(sids, device="cuda"))


@pytest.mark.parametrize("cps", [1, 2, 4, 8])
def test_gather_roll_kernel_matches_plain(cps):
    from onset_fingerprinting_torch.ops.windows import (
        gather_windows_roll,
        gather_windows_roll_reference,
    )

    x, rs, sids = _roll_case(cps=cps)
    k = gather_windows_roll(x, rs, sids, cps, 256)
    p = gather_windows_roll_reference(x, rs, sids, cps, 256)
    torch.cuda.synchronize()
    assert torch.equal(k, p)


def test_gather_roll_counts_launches_and_never_runs_plain():
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.windows import (
        gather_windows_roll,
        roll_kernel_for,
    )

    x, rs, sids = _roll_case()
    kernel = roll_kernel_for(4, 256, x.data_ptr()).kernel
    assert kernel is _cuda.GATHER_ROLL_VEC
    launches = kernel.launches
    plain = _cuda.GATHER_ROLL.plain_calls
    gather_windows_roll(x, rs, sids, 4, 256)
    assert kernel.launches == launches + 1
    assert _cuda.GATHER_ROLL.plain_calls == plain
    # a CUDA tensor the kernel does not take raises; it never goes plain
    with pytest.raises(ValueError, match="int32"):
        gather_windows_roll(x, rs.long(), sids, 4, 256)
    strided = x.t().contiguous().t()  # same shape, column-major
    with pytest.raises(ValueError, match="contiguous float32"):
        gather_windows_roll(strided, rs, sids, 4, 256)
    assert _cuda.GATHER_ROLL.plain_calls == plain


def _gather_hits(kind, t, c, cps, n, seed):
    """Random hits with both clip edges and both end streams, or the fleet
    path's own list for the injected grid (``tools/gather_bench``)."""
    from onset_fingerprinting_torch.tools import gather_bench as gb

    if kind == "grid":
        return gb.fleet_hits(t, c // cps, "cuda")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, t, n).astype(np.int32)
    sids = rng.integers(0, c // cps, n).astype(np.int32)
    edges = [0, 67, t - 1, t - 195, 5][:n]
    starts[:len(edges)] = edges
    sids[:2] = [c // cps - 1, 0][:min(n, 2)]
    return (torch.as_tensor(starts, device="cuda"),
            torch.as_tensor(sids, device="cuda"))


@pytest.mark.parametrize("cps,c,n,kind,routes", [
    (4, 512, 999, "random", {"old", "vec"}),
    (1, 256, 999, "random", {"old", "vec"}),
    (2, 256, 999, "random", {"old", "vec"}),
    (8, 512, 999, "random", {"old", "vec"}),
    (2, 102, 999, "random", {"old", "vec"}),  # ragged C, C % 4 == 2
    (3, 96, 999, "random", {"old"}),  # an odd cps
    (4, 500, 37, "random", {"old", "vec"}),  # C % 128 != 0
    (4, 512, 1, "random", {"old", "vec"}),
    (4, 512, 0, "random", {"old", "vec"}),
    (4, 512, 0, "grid", {"old", "vec"}),  # the fleet path's list
])
def test_gather_routes_match_plain(cps, c, n, kind, routes):
    """Every K2 kernel that takes the shape is bit-exact to plain in both
    contracts and counts its launch under its instantiation; the wrapper
    takes ``gather_kernel_for``'s and never the plain version."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops import windows as ow

    t = 32000 if kind == "grid" else 4096
    x = torch.randn(t, c, device="cuda")
    starts, sids = _gather_hits(kind, t, c, cps, n, seed=cps)
    n = starts.shape[0]
    table = ow.gather_routes(cps, 256, x.data_ptr())
    assert set(table) == routes
    for anchored in (True, False):
        plain = ow.gather_hit_windows_reference(x, starts, sids, cps, 256, 64,
                                                anchored)
        for route in table.values():
            before = (route.kernel.launches,
                      route.kernel.variants[route.variant])
            got = ow._launch_gather(route, x, starts, sids, cps, 256, 64,
                                    anchored)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (route, anchored)
            hit = int(n > 0)
            assert route.kernel.launches == before[0] + hit
            if route.variant:
                assert route.kernel.variants[route.variant] == before[1] + hit
    route = ow.gather_kernel_for(cps, 256, x.data_ptr())
    assert route.kernel is (_cuda.GATHER_VEC if "vec" in routes
                            else _cuda.GATHER)
    counts = [(k.launches, k.plain_calls) for k in _cuda.KERNELS]
    got = ow.gather_hit_windows(x, starts, sids, cps, 256, 64, True)
    torch.cuda.synchronize()
    after = [(k.launches, k.plain_calls) for k in _cuda.KERNELS]
    for k, a, b in zip(_cuda.KERNELS, counts, after):
        assert b == (a[0] + int(k is route.kernel and n > 0), a[1]), k.name
    assert torch.equal(got, ow.gather_hit_windows_reference(
        x, starts, sids, cps, 256, 64, True))


def test_gather_misaligned_x_takes_the_old_kernel():
    """A view 4 bytes into its storage: no 16-byte loads, so gather.cu."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops import windows as ow

    x = torch.randn(4096 * 512 + 1, device="cuda")[1:].view(4096, 512)
    starts, sids = _gather_hits("random", 4096, 512, 4, 999, seed=2)
    assert ow.gather_kernel_for(4, 256, x.data_ptr()).kernel is \
        _cuda.GATHER
    before = _cuda.GATHER.launches
    got = ow.gather_hit_windows(x, starts, sids, 4, 256, 64, True)
    assert _cuda.GATHER.launches == before + 1
    assert torch.equal(got, ow.gather_hit_windows_reference(
        x, starts, sids, 4, 256, 64, True))


@pytest.mark.parametrize("cps,n,kind,routes", [
    (4, 999, "random", {"old", "vec"}),
    (1, 999, "random", {"old", "vec"}),
    (2, 999, "random", {"old", "vec"}),
    (8, 999, "random", {"old", "vec"}),
    (4, 1, "random", {"old", "vec"}),
    (4, 0, "random", {"old", "vec"}),
    (4, 0, "grid", {"old", "vec"}),
])
def test_roll_routes_match_plain(cps, n, kind, routes):
    """Every K4 kernel that takes the shape is bit-exact to plain (the
    in-tile wrap, clamped starts) and to K2's block-aligned windows, and
    counts its launch; the wrapper takes ``roll_kernel_for``'s."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops import windows as ow

    c = 512
    if kind == "grid":
        x = torch.randn(32000, c, device="cuda")
        starts, sids = _gather_hits("grid", 32000, c, cps, 0, 0)
        rs = torch.clamp(starts - 64, 0, 32000 - 256) // 8 * 8
    else:
        x, rs, sids = _roll_case(t=1000, c=c, n=max(n, 3), cps=cps)
        rs, sids = rs[:n].contiguous(), sids[:n].contiguous()
    table = ow.roll_routes(cps, 256, x.data_ptr())
    assert set(table) == routes
    plain = ow.gather_windows_roll_reference(x, rs, sids, cps, 256)
    for route in table.values():
        before = (route.kernel.launches,
                  route.kernel.variants[route.variant])
        got = ow._launch_roll(route, x, rs, sids, cps, 256)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), route
        hit = int(rs.shape[0] > 0)
        assert route.kernel.launches == before[0] + hit
        if route.variant:
            assert route.kernel.variants[route.variant] == before[1] + hit
    if kind == "grid":
        block = ow.gather_hit_windows(x, starts, sids, cps, 256, 64, False)
        assert torch.equal(plain[:, :, :cps].transpose(1, 2), block)
    route = ow.roll_kernel_for(cps, 256, x.data_ptr())
    assert route.kernel is _cuda.GATHER_ROLL_VEC
    before = (route.kernel.launches, _cuda.GATHER_ROLL.plain_calls)
    got = ow.gather_windows_roll(x, rs, sids, cps, 256)
    assert (route.kernel.launches, _cuda.GATHER_ROLL.plain_calls) == (
        before[0] + int(rs.shape[0] > 0), before[1])
    assert torch.equal(got, plain)


# -- slice B: the realtime engine's kernels and the bf16 DFT head -----------

def _engine_stream(seconds=0.6, seed=3):
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    audio, _, hits = sim.synth_stream(seconds, seed=seed)
    return sim, audio, hits


def test_coupled_detector_at_the_engines_shape_matches_plain():
    """K1 as the engine launches it: coupled off-gate, no high-pass, one
    [128, 3] block per launch with the state carried, bit-identical to the
    plain detector block by block (and the warmup)."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        kernel_for,
        make_fused_detector,
    )

    sim, audio, _ = _engine_stream()
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, st, _ = make_fused_detector(cfg, emit_rel=False)
    assert kernel_for(fst.plain) is _cuda.DETECTOR_WARP
    x = torch.as_tensor(audio, device="cuda")
    warm = sim.WARMUP // 128 * 128
    sk = fused_warmup_minmax(fst, params, st, x[:warm])
    sp = warmup_minmax(fst.plain, params, st, x[:warm])
    for name, a, b in zip(sk._fields, sk, sp):
        assert torch.equal(a, b), ("warmup", name)
    fired = 0
    for i in range(0, len(audio) - 127, 128):
        blk = x[i: i + 128]
        sk, (on_k, d_k, _) = fused_detect_offline(fst, params, sk, blk, False)
        sp, (on_p, d_p, _) = detect_offline(fst.plain, params, sp, blk)
        assert torch.equal(on_k, on_p) and torch.equal(d_k, d_p), i
        fired += int(on_p.sum())
    for name, a, b in zip(sk._fields, sk, sp):
        assert torch.equal(a, b), name
    assert fired >= 6, fired


def _features(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16).to(
        torch.float32)


@pytest.mark.parametrize("pairs", [False, True])
def test_bf16_dft_head_matches_its_emulation(pairs):
    """The card's bf16 x bf16 -> f32 GEMMs against the CPU emulation of the
    same rounding points: within 1e-3 of the output's scale (f32 sums in
    another order can flip a bf16 rounding of the spectrum, which moves an
    output by about one bf16 ulp of one term of 137)."""
    from onset_fingerprinting_torch.ops import xcorr as tx

    a = _features(0, (64, 4, 5, 133))
    pi, pj = torch.tensor([0, 0, 1, 2]), torch.tensor([1, 3, 2, 3])
    if pairs:
        want = tx.self_and_pair_correlate_dft(a, pi, pj, precision="default")
        got = tx.self_and_pair_correlate_dft(a.cuda(), pi.cuda(), pj.cuda(),
                                             precision="default")
    else:
        want = (tx.batch_self_correlate_dft(a, 2, precision="default"),)
        got = (tx.batch_self_correlate_dft(a.cuda(), 2, precision="default"),)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale


def _head_inputs(b, c, o, v=133, k=5, layout="k3", seed=0):
    """bf16-valued f32 features as K3 writes them (``[B*C, V, K]`` seen as
    ``[B, C, K, V]``) or contiguous ``[B, C, K, V]``, and a dense layer."""
    g = torch.Generator("cuda").manual_seed(seed)
    if layout == "k3":
        raw = torch.randn((b * c, v, k), device="cuda", generator=g)
        feats = raw.to(torch.bfloat16).float().reshape(b, c, v, k).transpose(
            2, 3)
    else:
        feats = torch.randn((b, c, k, v), device="cuda", generator=g).to(
            torch.bfloat16).float()
    torch.manual_seed(seed + 1)
    return feats, torch.nn.Linear(c * (2 * v - 1) + c, o).cuda()


@pytest.mark.parametrize("b,c,o,v,k,layout", [
    (36480, 4, 2, 133, 5, "k3"),   # fleet4-bf16.hits10's call
    (32768, 3, 3, 133, 5, "k3"),   # drum3-bf16.streams1024's call
    (1, 4, 2, 133, 5, "k3"), (37, 3, 3, 133, 5, "k3"),
    (7, 4, 2, 64, 5, "contiguous"), (5, 2, 8, 20, 3, "k3"),
    (9, 16, 1, 7, 2, "k3"),
])
def test_cccnn_head_kernel_matches_plain(b, c, o, v, k, layout):
    """csrc/cccnn_head.cu against its plain version on the card (f32
    products of bf16-rounded operands, TF32 off) at the benchmark's fleet
    and drum calls, one window, a ragged batch and other widths: within
    1e-3 of the output's scale (f32 sums in another order can round a power
    value to its other bf16 neighbour; measured up to 4e-4), one launch and
    no plain call."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.cccnn_head import (
        self_cc_head,
        self_cc_head_reference,
    )

    feats, fc = _head_inputs(b, c, o, v, k, layout)
    kern = _cuda.CCCNN_HEAD
    before = (kern.launches, kern.plain_calls)
    with torch.inference_mode():
        got = self_cc_head(feats, fc.weight, fc.bias)
        want = self_cc_head_reference(feats, fc.weight, fc.bias)
    assert (kern.launches, kern.plain_calls) == (before[0] + 1, before[1])
    assert got.shape == (b, o) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


@pytest.mark.parametrize("channels,out", [(4, 2), (3, 3)])
def test_bf16_cccnn_runs_the_head_kernel(monkeypatch, channels, out):
    """The bf16 flagship in inference on the card runs its head on the
    kernel, one launch a forward and no plain call, and gives the chain's
    outputs within 1e-3 of their scale; the realtime classifier's 512-sample
    windows keep the chain."""
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.workload import FLAGSHIP

    cfg = {**FLAGSHIP, "channels": channels, "output_size": out}
    torch.manual_seed(7)
    model = CCCNN(input_size=256, dtype=torch.bfloat16, **cfg).cuda().eval()
    x = torch.randn((300, channels, 256), device="cuda")
    kern = _cuda.CCCNN_HEAD
    with torch.inference_mode():
        before = (kern.launches, kern.plain_calls)
        got = model(x)
        assert (kern.launches, kern.plain_calls) == (before[0] + 1,
                                                    before[1])
        monkeypatch.setattr(CCCNN, "head_on_kernel", lambda self, f: False)
        want = model(x)
        monkeypatch.undo()
        sim, _, _ = _engine_stream(0.01)
        classifier = sim.classifier(seed=1).cuda()
        before = kern.launches
        classifier(torch.randn((16, 3, 512), device="cuda"))
        assert kern.launches == before
    assert float((got - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


def test_f32_flagship_holds_f32_with_tf32_on(monkeypatch):
    """The float32 flagship through ``make_detect_fingerprint`` at 384
    streams of hits10's traffic, with TF32 turned on process-wide, is the
    plain reference's forward on the same windows to the CPU test's
    float32 tolerance (``test_torch_port_fleet_f32.F32_TOL``, 1e-5 of the
    outputs' scale), on K3 f32 and the head's chain; with the head's pin
    taken out, its TF32 products are not."""
    import json
    from pathlib import Path

    from portbench import common
    from portbench.reference import cccnn as ref_cccnn
    from portbench.systems import fleet
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops import conv_stack

    root = Path(__file__).resolve().parent.parent / "portbench"
    cfg = dict(json.loads((root / "configs" / "fleet4-cccnn-f32.json")
                          .read_text()), streams=384)
    tr = json.loads((root / "traffic" / "fleet4-bf16.hits10.json")
                    .read_text())
    system = fleet.System(cfg, tr, 2 ** 31 + 11, "cuda")
    run, x = system.run, system.audio.chunk_view(0)
    _, on, deltas = run.detect(system.state, x)
    starts, sids, valid, _ = run.hit_list(on, deltas)
    wins = run.windows(x, starts, sids)
    kernels = (_cuda.CONV_STACK, _cuda.CONV_STACK_MMA, _cuda.CCCNN_HEAD)
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        before = [k.launches for k in kernels]
        got = run.predict(wins, valid)[valid].cpu()
        assert [k.launches for k in kernels] == [before[0] + 1, before[1],
                                                 before[2]]
        monkeypatch.setattr(conv_stack, "exact_f32_matmul",
                            contextlib.nullcontext)
        unpinned = run.predict(wins, valid)[valid].cpu()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
    want = ref_cccnn.forward(wins[valid].cpu(),
                             common.to_cpu(system.weights))
    assert len(want) > 300
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((unpinned - want).abs().max()) > 1e-5 * scale


def test_bf16_cccnn_card_matches_cpu():
    """The classifier as the engine runs it (the flagship bf16 CCCNN, 3
    channels, 512-sample windows) on the card against its plain version on
    the CPU: K3 on the tensor cores (the cluster kernel: 48 signals) and
    the bf16 head, within 2e-2."""
    from onset_fingerprinting_torch.ops import _cuda

    sim, audio, _ = _engine_stream()
    model = sim.classifier(seed=1)
    x = torch.as_tensor(np.stack([audio[s: s + 512].T for s in
                                  range(20000, 20000 + 16 * 700, 700)]))
    with torch.inference_mode():
        want = model(x)
        before = _cuda.CONV_STACK_MMA_CLUSTER.launches
        got = model.cuda()(x.cuda()).cpu()
    assert _cuda.CONV_STACK_MMA_CLUSTER.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-2


def _block_events(seed, n_strikes=40):
    """Per-block (on, deltas) of random strikes with garbage onsets and
    out-of-order channels, as the detector would hand them to the
    locator: ``[(sample_count, on [3], deltas [3])]``."""
    sim, _, _ = _engine_stream(0.01)
    _, _, xyz, c = sim._geometry()
    rng = np.random.default_rng(seed)
    events = []
    t = 20000
    for _ in range(n_strikes):
        r = np.sqrt(rng.uniform(0.01, 0.64)) * sim.DIAM / 2
        ang = rng.uniform(0, 2 * np.pi)
        x, y = r * np.cos(ang), r * np.sin(ang)
        for ch, (sx, sy, _) in enumerate(xyz):
            events.append((t + int(round(np.hypot(x - sx, y - sy) / c
                                         * sim.SR)), ch))
        if rng.random() < 0.4:
            events.append((t - int(rng.integers(20, 150)),
                           int(rng.integers(3))))
        t += 1500 + int(rng.integers(0, 500))
    blocks = {}
    for onset, ch in sorted(events):
        b = onset // 128
        on, d = blocks.setdefault(b, ([False] * 3, [0] * 3))
        if not on[ch]:
            on[ch], d[ch] = True, onset - b * 128
    return [(b * 128, on, d) for b, (on, d) in sorted(blocks.items())]


def test_locate_block_kernel_matches_plain():
    """csrc/locate_block.cu against its plain version on the same blocks:
    the locator state, the queue and the emits exactly, points within
    1e-3 cm."""
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        EventQueue,
        LocateBlock,
        locate_block,
        locate_block_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    lb = LocateBlock(eng.locator, 3, 128, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")

    def queue():
        return EventQueue(torch.zeros((16, 2), device="cuda"),
                          torch.zeros(16, **i32), torch.zeros(16, **i32),
                          torch.zeros((), **i32))

    sk, qk = locator_init(8, "cuda"), queue()
    sp, qp = locator_init(8, "cuda"), queue()
    before = _cuda.LOCATE_BLOCK.launches
    n_emit = 0
    blocks = _block_events(5)
    for count, on, d in blocks:
        args = (torch.tensor(on, device="cuda"), torch.tensor(d, **i32),
                torch.tensor(count, **i32))
        sk, qk, hk, ck = locate_block(lb, sk, qk, *args)
        sp, qp, hp, cp = locate_block_reference(lb, sp, qp, *args)
        assert torch.equal(ck, cp) and int(ck) == count + 128
        for a, b in zip(sk, sp):
            assert torch.equal(a, b), count
        assert torch.equal(hk.emits, hp.emits) and torch.equal(hk.onsets,
                                                               hp.onsets)
        assert float((hk.points - hp.points).abs().max()) <= 1e-3
        for name in ("onsets", "emits", "count"):
            assert torch.equal(getattr(qk, name), getattr(qp, name))
        n_emit += int(hk.emits.sum())
    assert _cuda.LOCATE_BLOCK.launches == before + len(blocks)
    assert n_emit >= 30


def test_engine_graph_replay_equals_eager_and_cpu():
    """The engine's step replayed from its CUDA graph against the same
    step run eagerly on the card (identical state) and the plain engine on
    the CPU (identical onsets and emit stamps, points within 1e-3 cm);
    every replay counts one launch of K1 and one of the locate kernel with
    the ring write (variant "ring"), and no plain version runs; on the CPU
    the plain step writes the ring once a block."""
    from onset_fingerprinting_torch.core.tree import leaves
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.realtime.engine import (
        EngineState,
        _clone,
    )

    sim, audio, hits = _engine_stream()
    blocks = sim.blocks_of(audio)
    eager = sim.build_engine("cuda", ring_seconds=1.0, event_queue=64)
    eager.warmup(audio[: sim.WARMUP])
    st = EngineState(*_clone(eager.state))
    for blk in blocks:
        st, _ = eager._step(st, torch.as_tensor(blk, device="cuda"),
                            eager.params)
    runs = {}
    for device in ("cuda", "cpu"):
        eng = sim.build_engine(device, ring_seconds=1.0, event_queue=64)
        assert (eng._graph is not None) == (device == "cuda")
        _cuda.reset_counts()
        events, _, _ = sim.run(eng, audio, classify=False)
        runs[device] = (eng, events, {k.name: (k.launches, k.plain_calls)
                                      for k in _cuda.KERNELS}, (
            _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants),
            _cuda.LOCATE_BLOCK.plain_variants["ring_write"]))
    g, c = runs["cuda"], runs["cpu"]
    # the steps on the warp kernel; the warmup on the coupled pipe (the
    # route of a coupled call longer than one block)
    assert g[2]["detector_warp"] == (len(blocks), 0)
    assert g[2]["detector_pipe_coupled"] == (1, 0)
    assert g[2]["detector"] == (0, 0)
    assert g[2]["locate_block"] == (len(blocks), 0)
    assert g[3] == (len(blocks), 0)
    assert c[3] == (0, len(blocks))
    for u, v in zip(leaves(g[0].state), leaves(st)):
        assert torch.equal(u, v)
    assert [o for o, _ in g[1]] == [o for o, _ in c[1]]
    assert torch.equal(g[0].state.ev_emits.cpu(), c[0].state.ev_emits)
    for (_, a), (_, b) in zip(g[1], c[1]):
        assert abs(a.x - b.x) <= 1e-3 and abs(a.y - b.y) <= 1e-3
    matched, med, ok = sim.locate_gates(hits, g[1])
    assert ok and matched == len(hits)


# -- the realtime step in place: K1 one warp per channel, the locate
# kernel, the captured graph ---------------------------------------------

def _bursts(t, c, seed):
    """Noise with decaying 5 kHz bursts on every channel every ~1100
    samples, at per-channel offsets: ``[t, c]`` float32 on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-4, (t, c)).astype(np.float32)
    n = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / 96000 * n) * np.exp(-n / 120) * 0.5
             ).astype(np.float32)
    for base in range(300, t - 700, 1100):
        for ch in range(c):
            off = base + int(rng.integers(0, 90))
            x[off: off + 600, ch] += burst
    return torch.as_tensor(x, device="cuda")


def _coupled_matches_plain(c, backtrack, hipass, named, thresholds=()):
    """K1 in the coupled mode against the plain detector bit for bit: the
    multi-block warmup, then detection over 40 blocks functionally and
    again in place (``out`` = the input state); through the wrappers'
    route, or on the ``named`` kernel."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        DetectorState,
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        _launch,
        fused_detect_offline,
        fused_warmup_minmax,
        kernel_for,
        make_fused_detector,
    )

    cfg = DetectorConfig(n_channels=c, backtrack=backtrack,
                         backtrack_buffer_size=256, hipass_freq=hipass,
                         **dict(zip(("on_threshold", "off_threshold"),
                                    thresholds)))
    fst, params, st, _ = make_fused_detector(cfg)
    assert fst.plain.manual == bool(thresholds)
    assert kernel_for(fst.plain) is _cuda.DETECTOR_WARP
    assert kernel_for(fst.plain, 256) is _cuda.DETECTOR_PIPE_COUPLED
    kern = named or _cuda.DETECTOR_PIPE_COUPLED

    def warmup(state, x):
        if named is None:
            return fused_warmup_minmax(fst, params, state, x)
        return _launch(fst, params, state, x, False, True, named)[0]

    def detect(state, x, emit_rel=True, out=None):
        if named is None:
            return fused_detect_offline(fst, params, state, x, emit_rel,
                                        out=out)
        return _launch(fst, params, state, x, emit_rel, False, named, out)

    x = _bursts(128 * 78, c, seed=c)
    ks = (kern, _cuda.DETECTOR)
    before = [(k.launches, k.plain_calls) for k in ks]
    wk = warmup(st, x[: 128 * 38])
    wp = warmup_minmax(fst.plain, params, st, x[: 128 * 38])
    for name, a, b in zip(wk._fields, wk, wp):
        assert torch.equal(a, b), ("warmup", name)
    x = x[128 * 38:]
    sp, (on_p, d_p, r_p) = detect_offline(fst.plain, params, wp, x)
    assert int(on_p.sum()) >= c
    sk, (on_k, d_k, r_k) = detect(wk, x)
    assert torch.equal(on_k, on_p) and torch.equal(d_k, d_p)
    assert torch.equal(r_k, r_p)
    for name, a, b in zip(sk._fields, sk, sp):
        assert torch.equal(a, b), name
    # in place: the same events, the state in wk's tensors
    ptrs = [v.data_ptr() for v in wk]
    si, (on_i, d_i, r_i) = detect(wk, x, False, out=wk)
    assert si is wk and [v.data_ptr() for v in si] == ptrs and r_i is None
    assert torch.equal(on_i, on_p) and torch.equal(d_i, d_p)
    for name, a, b in zip(DetectorState._fields, si, sp):
        assert torch.equal(a, b), ("in place", name)
    assert [(k.launches, k.plain_calls) for k in ks] == [
        (before[0][0] + 3, before[0][1]), before[1]]


@pytest.mark.parametrize("c", [1, 3, 4, 8, 32])
@pytest.mark.parametrize("backtrack,hipass", [(False, 0.0), (True, 2000.0),
                                              (False, 2000.0)])
def test_detector_warp_matches_plain(c, backtrack, hipass):
    """csrc/detector_warp.cu (named: the routes give it one block) against
    the plain detector over many blocks (prefetched stages)."""
    from onset_fingerprinting_torch.ops import _cuda

    _coupled_matches_plain(c, backtrack, hipass, _cuda.DETECTOR_WARP)


@pytest.mark.parametrize("c", [1, 3, 4, 8, 31, 32])
@pytest.mark.parametrize("backtrack,hipass", [(False, 0.0), (True, 2000.0),
                                              (False, 2000.0)])
def test_detector_pipe_coupled_matches_plain(c, backtrack, hipass):
    """The pipe's coupled instantiation, as the wrappers route a multi-block
    coupled call (one recording, one lane group), against the plain
    detector; the launches count under variant "coupled"."""
    from onset_fingerprinting_torch.ops import _cuda

    before = _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"]
    _coupled_matches_plain(c, backtrack, hipass, None)
    assert _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"] == before + 3


@pytest.mark.parametrize("c,backtrack", [(3, False), (8, True)])
def test_detector_pipe_coupled_manual_matches_plain(c, backtrack):
    """The coupled pipe with manual (absolute) thresholds."""
    _coupled_matches_plain(c, backtrack, 2000.0, None, (3.0, 1.0))


def test_locate_block_in_place_matches_plain():
    """The locate kernel updating the locator, the queue and the counter in
    place (``out`` = the inputs) against its plain version, on a fuzz of
    fired blocks with quiet blocks between them: state, queue and counter
    exactly, points within 1e-3 cm; a quiet block leaves the locator and
    the queue bit for bit as they were."""
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        EventQueue,
        LocateBlock,
        locate_block,
        locate_block_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    lb = LocateBlock(eng.locator, 3, 128, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")

    def queue():
        return EventQueue(torch.zeros((16, 2), device="cuda"),
                          torch.zeros(16, **i32), torch.zeros(16, **i32),
                          torch.zeros((), **i32))

    sk, qk, ck = locator_init(8, "cuda"), queue(), torch.zeros((), **i32)
    sp, qp = locator_init(8, "cuda"), queue()
    ptrs = [v.data_ptr() for v in (*sk, *qk, ck)]
    n_emit = n_quiet = 0
    for count, on, d in _block_events(6):
        for quiet in (True, False):
            if quiet:  # a block just before the fired one, nothing fired
                args = (torch.zeros(3, dtype=torch.bool, device="cuda"),
                        torch.zeros(3, **i32))
                blk = count - 128
            else:
                args = (torch.tensor(on, device="cuda"),
                        torch.tensor(d, **i32))
                blk = count
            ck.fill_(blk)
            was = [v.clone() for v in (*sk, *qk)]
            rk = locate_block(lb, sk, qk, *args, ck, out=(sk, qk, ck))
            sp, qp, hp, cp = locate_block_reference(
                lb, sp, qp, *args, torch.tensor(blk, **i32))
            assert rk[0] is sk and rk[1] is qk and rk[3] is ck
            assert [v.data_ptr() for v in (*sk, *qk, ck)] == ptrs
            for a, b in zip((*sk, *qk[1:], ck), (*sp, *qp[1:], cp)):
                assert torch.equal(a, b), (blk, quiet)
            assert float((qk.points - qp.points).abs().max()) <= 1e-3
            hk = rk[2]
            assert torch.equal(hk.emits, hp.emits)
            assert torch.equal(hk.onsets, hp.onsets)
            assert float((hk.points - hp.points).abs().max()) <= 1e-3
            if quiet:
                n_quiet += 1
                for a, b in zip(was, (*sk, *qk)):
                    assert torch.equal(a, b)
            n_emit += int(hk.emits.sum())
    assert n_emit >= 30 and n_quiet >= 40


def test_engine_step_graph_has_no_copy_nodes():
    """The engine's captured step in place: its two kernels (K1; the
    locate kernel with the ring write and the counter) and nothing
    else."""
    from onset_fingerprinting_torch.tools.step_bench import graph_nodes

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cuda", ring_seconds=1.0, event_queue=64)
    types, names = graph_nodes(eng._graph.graph)
    assert types == {"kernel": 2}, (types, names)
    for kernel in ("detector_warp", "locate_block"):
        assert sum(kernel in n for n in names) == 1, (kernel, names)


def _ring_locate(c, b):
    """A locate step of ``c`` channels and ``b``-sample blocks on the card
    (a locator of max(c, 2) sensors on the demo's drum), its empty state
    and queue."""
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
        locator_init,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        EventQueue,
        LocateBlock,
    )

    sim, _, _ = _engine_stream(0.01)
    loc = Multilaterate3D([(0.9, 360.0 * i / max(c, 2), 0.0)
                           for i in range(max(c, 2))],
                          drum_diameter=sim.DIAM, medium="drumhead",
                          sr=sim.SR, feasibility_tols=sim.FEASIBILITY_TOLS)
    i32 = dict(dtype=torch.int32, device="cuda")
    queue = EventQueue(torch.zeros((16, 2), device="cuda"),
                       torch.zeros(16, **i32), torch.zeros(16, **i32),
                       torch.zeros((), **i32))
    return (LocateBlock(loc, c, b, device="cuda"), locator_init(8, "cuda"),
            queue)


@pytest.mark.parametrize("cap,b,c,head", [
    (6000, 128, 3, 0), (6000, 128, 3, 5950), (300, 300, 1, 299),
    (257, 64, 5, 2 ** 31 - 100), (1536000, 128, 3, 1535900)])
def test_ring_write_kernel_matches_plain(cap, b, c, head):
    """The ring write inside the locate launch (``locate_block(block=)``,
    ``csrc/locate_block.cu``) against core/ring_buffer.ring_write, bit for
    bit, data and counter, over 7 quiet blocks from a head ``head`` frames
    along: the head wrapping past the ring's end and the int32 counter
    past its largest value; in place, one launch per block (variant
    "ring"), no plain call; the sample counter advanced as the plain step
    advances it."""
    from onset_fingerprinting_torch.core.ring_buffer import (
        ring_init,
        ring_write,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import locate_block

    lb, lstate, queue = _ring_locate(c, b)
    g = torch.Generator("cuda").manual_seed(cap + b + c)
    ring = ring_init(cap, (c,), device="cuda")
    ring.data.copy_(torch.randn(ring.data.shape, generator=g,
                                device="cuda"))
    ring.counter.fill_(head)
    ring_p = type(ring)(ring.data.clone(), ring.counter.clone())
    ptrs = (ring.data.data_ptr(), ring.counter.data_ptr())
    on = torch.zeros(c, dtype=torch.bool, device="cuda")
    d = torch.zeros(c, dtype=torch.int32, device="cuda")
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    k = _cuda.LOCATE_BLOCK
    before = (k.launches, k.variants["ring"], k.plain_calls)
    for i in range(7):
        blk = torch.randn((b, c), generator=g, device="cuda")
        locate_block(lb, lstate, queue, on, d, count, ring,
                     out=(lstate, queue, count), block=blk)
        ring_p = ring_write(ring_p, blk)
        assert (ring.data.data_ptr(), ring.counter.data_ptr()) == ptrs
        assert torch.equal(ring.data, ring_p.data), i
        assert torch.equal(ring.counter, ring_p.counter), i
        assert int(count) == (i + 1) * b
    assert (k.launches, k.variants["ring"], k.plain_calls) == (
        before[0] + 7, before[1] + 7, before[2])


def test_locate_block_ring_write_matches_plain():
    """The locate launch with the ring write (the engine's call) against
    the plain ring write then the plain step, block by block on quiet and
    fired blocks from the same state, the ring's head wrapping: the ring
    and its counter, the locator state, the queue's onsets, emit stamps
    and count and the sample counter bit for bit, the points within
    1e-3 cm (Newton's sum of three squares may run in another order)."""
    from onset_fingerprinting_torch.core.ring_buffer import (
        ring_init,
        ring_write,
    )
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        EventQueue,
        LocateBlock,
        locate_block,
        locate_block_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    lb = LocateBlock(eng.locator, 3, 128, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")

    def queue():
        return EventQueue(torch.zeros((16, 2), device="cuda"),
                          torch.zeros(16, **i32), torch.zeros(16, **i32),
                          torch.zeros((), **i32))

    g = torch.Generator("cuda").manual_seed(7)
    ring = ring_init(1000, (3,), device="cuda")
    ring.counter.fill_(900)
    ring_p = type(ring)(ring.data.clone(), ring.counter.clone())
    sk, qk, ck = locator_init(8, "cuda"), queue(), torch.zeros((), **i32)
    sp, qp = locator_init(8, "cuda"), queue()
    before = _cuda.LOCATE_BLOCK.variants["ring"]
    n_emit = n_quiet = n = 0
    for count, on, d in _block_events(8):
        for quiet in (True, False):
            if quiet:
                args = (torch.zeros(3, dtype=torch.bool, device="cuda"),
                        torch.zeros(3, **i32))
                blk_start = count - 128
            else:
                args = (torch.tensor(on, device="cuda"),
                        torch.tensor(d, **i32))
                blk_start = count
            blk = torch.randn((128, 3), generator=g, device="cuda")
            ck.fill_(blk_start)
            was = [v.clone() for v in (*sk, *qk)]
            _, _, hk, _ = locate_block(lb, sk, qk, *args, ck, ring,
                                       out=(sk, qk, ck), block=blk)
            ring_p = ring_write(ring_p, blk)
            sp, qp, hp, cp = locate_block_reference(
                lb, sp, qp, *args, torch.tensor(blk_start, **i32))
            n += 1
            assert torch.equal(ring.data, ring_p.data), blk_start
            assert torch.equal(ring.counter, ring_p.counter), blk_start
            for a, b in zip((*sk, *qk[1:], ck), (*sp, *qp[1:], cp)):
                assert torch.equal(a, b), (blk_start, quiet)
            assert float((qk.points - qp.points).abs().max()) <= 1e-3
            assert torch.equal(hk.emits, hp.emits)
            assert torch.equal(hk.onsets, hp.onsets)
            if quiet:
                n_quiet += 1
                for a, b in zip(was, (*sk, *qk)):
                    assert torch.equal(a, b)
            n_emit += int(hk.emits.sum())
    assert _cuda.LOCATE_BLOCK.variants["ring"] == before + n
    assert n_emit >= 30 and n_quiet >= 40


#: the learned locators of the card tests: the plan's old bounds (64 units,
#: 8 hidden layers) and past them
FCNN_HIDDEN = [
    pytest.param("arrival", (32, 32), id="arrival"),
    pytest.param("by_channel", (32, 32), id="by_channel"),
    pytest.param("arrival", (128, 128), id="arrival-wide"),
    pytest.param("by_channel", (16,) * 12, id="by_channel-deep"),
    # past the header's 32 words a warp reads in one load
    pytest.param("arrival", (8,) * 40, id="arrival-deeper"),
]


def _locate_fcnn(hidden, seed=1):
    """A test FCNN on the card: flax's init, the first Dense scaled by
    1/50 and the last by 1/20 (sample lags to points of a few cm)."""
    from onset_fingerprinting_torch.models.fcnn import (
        FCNN,
        FCNNBundle,
        init_module,
    )

    net = init_module(FCNN(2, hidden_layers=hidden), seed, "cpu")
    with torch.no_grad():
        net.layers[0].weight /= 50
        net.out.weight /= 20
        for bn in net.norms:
            bn.running_mean.normal_(0, 0.3)
            bn.running_var.uniform_(0.5, 1.5)
    return FCNNBundle(net.cuda())


@pytest.mark.parametrize("hidden", [(128, 128), (16,) * 12],
                         ids=["wide", "deep"])
def test_engine_serves_a_wide_and_a_deep_fcnn(hidden):
    """The realtime engine on the card with a learned locator past the
    plan's old bounds (64 units, 8 hidden layers): its captured step runs
    the locate kernel with the FCNN and the ring write on every block, no
    plain version, and its events equal the plain engine's on the CPU with
    the same weights over the same stream (points within 1e-3 cm)."""
    import copy

    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )
    from onset_fingerprinting_torch.models.fcnn import FCNNBundle
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.realtime.engine import RealtimeEngine

    sim, audio, _ = _engine_stream()
    _, polar, _, _ = sim._geometry()
    model = _locate_fcnn(hidden)
    runs = {}
    for device in ("cuda", "cpu"):
        net = model if device == "cuda" else FCNNBundle(
            copy.deepcopy(model.model).cpu())
        eng = RealtimeEngine(
            DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                           sr=sim.SR),
            Multilaterate3D(polar, drum_diameter=sim.DIAM, medium="drumhead",
                            sr=sim.SR,
                            feasibility_tols=sim.FEASIBILITY_TOLS),
            ring_seconds=1.0, event_queue=64, model=net, device=device)
        assert (eng._graph is not None) == (device == "cuda")
        _cuda.reset_counts()
        events, _, _ = sim.run(eng, audio, classify=False)
        runs[device] = (eng, events,
                        dict(_cuda.LOCATE_BLOCK.variants),
                        _cuda.LOCATE_BLOCK.plain_calls)
    g, c = runs["cuda"], runs["cpu"]
    n_blocks = len(sim.blocks_of(audio))
    assert g[2] == {"ring+fcnn": n_blocks} and g[3] == 0
    assert len(g[1]) >= 2
    assert [o for o, _ in g[1]] == [o for o, _ in c[1]]
    assert torch.equal(g[0].state.ev_emits.cpu(), c[0].state.ev_emits)
    for (_, a), (_, b) in zip(g[1], c[1]):
        assert abs(a.x - b.x) <= 1e-3 and abs(a.y - b.y) <= 1e-3


@pytest.mark.parametrize("mode,hidden", FCNN_HIDDEN)
def test_locate_block_kernel_with_fcnn_matches_plain(mode, hidden):
    """csrc/locate_block.cu with the learned locator (the packed FCNN)
    against its plain version (the FCNN in torch) on the same blocks: the
    locator state, the queue and the emits exactly, points within 1e-3
    cm; every launch counts under the "fcnn" variant.  Wide and deep nets
    too: the widths travel on the card, the vectors in dynamic shared
    memory."""
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        EventQueue,
        LocateBlock,
        locate_block,
        locate_block_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    model = _locate_fcnn(hidden)
    lb = LocateBlock(eng.locator, 3, 128, model=model, model_input=mode,
                     device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")

    def queue():
        return EventQueue(torch.zeros((16, 2), device="cuda"),
                          torch.zeros(16, **i32), torch.zeros(16, **i32),
                          torch.zeros((), **i32))

    sk, qk = locator_init(8, "cuda"), queue()
    sp, qp = locator_init(8, "cuda"), queue()
    before = _cuda.LOCATE_BLOCK.variants["fcnn"]
    n_emit = 0
    blocks = _block_events(6)
    for count, on, d in blocks:
        args = (torch.tensor(on, device="cuda"), torch.tensor(d, **i32),
                torch.tensor(count, **i32))
        sk, qk, hk, ck = locate_block(lb, sk, qk, *args)
        sp, qp, hp, cp = locate_block_reference(lb, sp, qp, *args)
        assert torch.equal(ck, cp)
        for a, b in zip(sk, sp):
            assert torch.equal(a, b), count
        assert torch.equal(hk.emits, hp.emits)
        assert float((hk.points - hp.points).abs().max()) <= 1e-3
        for name in ("onsets", "emits", "count"):
            assert torch.equal(getattr(qk, name), getattr(qp, name))
        n_emit += int(hk.emits.sum())
    assert _cuda.LOCATE_BLOCK.variants["fcnn"] == before + len(blocks)
    assert n_emit >= 30


def test_mining_detector_matches_plain_on_the_card():
    """detect_onsets_amplitude on the card (K1 as the coupled pipe: one
    warmup launch, one launch over the recording, the 2 kHz high-pass and
    the coupled off-gate) against the plain detector on the card over the
    same recording: channels, onsets and rel bit for bit."""
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        offline_detector,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_onsets_amplitude,
    )
    from onset_fingerprinting_torch.ops import _cuda

    sim, audio, _ = _engine_stream(0.6)  # two strikes, at 0.25 and 0.5 s
    before = _cuda.DETECTOR_PIPE_COUPLED.launches
    ch, on, rel = detect_onsets_amplitude(audio, sr=sim.SR)
    assert _cuda.DETECTOR_PIPE_COUPLED.launches == before + 2
    fst, params, st = offline_detector(3, sr=sim.SR)
    x = torch.as_tensor(audio, device="cuda")
    t = len(audio) // 128 * 128
    w = min(sim.SR // 2, len(audio)) // 128 * 128
    st = warmup_minmax(fst.plain, params, st, x[:w].contiguous())
    _, (on_p, d_p, rel_p) = detect_offline(fst.plain, params, st,
                                           x[:t].contiguous())
    assert np.array_equal(rel, rel_p.cpu().numpy())
    b, c = np.nonzero(on_p.cpu().numpy())
    order = np.argsort(b, kind="stable")
    assert [int(v) for v in ch] == [int(v) for v in c[order]]
    assert [int(v) for v in on] == [
        int(v) for v in b[order] * 128
        + d_p.cpu().numpy()[b[order], c[order]]]
    assert len(on) >= 3


def test_calibration_on_the_card_matches_the_cpu():
    """calibrate (float64 TNC) and optimize_positions (float32 adam) on the
    card against the same calls on the CPU: positions within 1e-4 m."""
    from onset_fingerprinting_torch.core.coords import spherical_to_cartesian
    from onset_fingerprinting_torch.locate.calibration import (
        calibrate,
        calibration_locations,
        optimize_positions,
    )

    radius = 14 * 2.54 / 2 / 100
    true = np.array([[float(v) for v in spherical_to_cartesian(*p)]
                     for p in [(0.8 * radius, 135, 80),
                               (0.8 * radius, 15, 60), (0.15, 100, 20)]])
    sounds = np.asarray([(0.0, 0.0, 0.0)] * 4 + [
        tuple(float(v) for v in spherical_to_cartesian(*p))
        for p in calibration_locations(10, 4, radius * 0.9, 0)])
    d = np.linalg.norm(sounds[:, None, :] - true[None], axis=-1) / 343.0
    onsets = np.cumsum(np.concatenate(
        [np.zeros((len(d), 1)), np.diff(d, axis=1) * 96000], axis=1), axis=1)
    out = {}
    for dev in ("cuda", "cpu"):
        est = calibrate(onsets, norm=2, device=dev)
        sens, snd, c = optimize_positions(
            (d[:, :2] - d[:, 2:]) * 96000, est, sounds, lr=0.05,
            num_epochs=200, C=343.0, device=dev)
        out[dev] = (est, sens, snd, c)
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert abs(out["cuda"][3] - out["cpu"][3]) < 1e-3


def _refine_blocks(seconds=1.6, seed=3):
    """The engine's per-block locate inputs with cc_refine on a synthetic
    stream: K1 one launch per block, warmed as the engine warms; yields
    ``(on, deltas, counter, block)``."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        make_fused_detector,
    )

    sim, audio, _ = _engine_stream(seconds, seed)
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, det, _ = make_fused_detector(cfg, emit_rel=False)
    det = fused_warmup_minmax(fst, params, det, torch.as_tensor(
        audio[: sim.WARMUP // 128 * 128], device="cuda"))
    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    for i, blk in enumerate(blocks):
        det, (on, d, _) = fused_detect_offline(fst, params, det, blk, False,
                                               out=det)
        yield on[0], d[0], torch.tensor(128 * i, dtype=torch.int32,
                                        device="cuda"), blk


def _cc_refine_kernel_matches_plain(model=None, mode="arrival"):
    """The locate kernel with CC refinement (and ``model``, the learned
    locator, if given) and the ring write in place, from the plain
    version's state before every block, against the plain ring write and
    the plain version on ``_refine_blocks``' fired and quiet blocks (the
    ring bit for bit); each refinement's argmax equal to the kernel's
    schedule on the CPU (``cc_schedule_reference``); returns
    ``(refinements checked, ties)``."""
    from onset_fingerprinting_torch.core.ring_buffer import (
        ring_init,
        ring_read_last,
        ring_write,
    )
    from onset_fingerprinting_torch.detect.refine import cc_refine_terms
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        LOG_FIELDS,
        LOG_W,
        EventQueue,
        LocateBlock,
        cc_schedule_reference,
        check_refinements,
        locate_block,
        locate_block_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    lb = LocateBlock(eng.locator, 3, 128, model=model, model_input=mode,
                     cc_refine=True, device="cuda")
    lb.check_kernel_shape()  # takes cc_refine
    variant = "ring+cc_refine" if model is None else "ring+fcnn+cc_refine"
    i32 = dict(dtype=torch.int32, device="cuda")
    sp = locator_init(8, "cuda")
    qp = EventQueue(torch.zeros((16, 2), device="cuda"),
                    torch.zeros(16, **i32), torch.zeros(16, **i32),
                    torch.zeros((), **i32))
    ring = ring_init(sim.SR, (3,), device="cuda")
    ring_p = type(ring)(ring.data.clone(), ring.counter.clone())
    before = _cuda.LOCATE_BLOCK.variants[variant]
    n_fired = n_quiet = n_checked = n_emit = n_sched = 0
    ties = []
    for on, d, count, blk in _refine_blocks():
        fired = bool(on.any())
        ring_p = ring_write(ring_p, blk)
        if not fired and n_quiet >= 20:
            ring = ring_write(ring, blk)
            sp, qp, _, _ = locate_block_reference(lb, sp, qp, on, d, count,
                                                  ring_p)
            continue
        sk = type(sp)(*(v.clone() for v in sp))
        qk = type(qp)(*(v.clone() for v in qp))
        ck = count.clone()
        log = torch.zeros((3, LOG_W), **i32)
        _, _, hk, _ = locate_block(lb, sk, qk, on, d, ck, ring, log,
                                   out=(sk, qk, ck), block=blk)
        assert torch.equal(ring.data, ring_p.data)
        assert torch.equal(ring.counter, ring_p.counter)
        sp, qp, hp, cp = locate_block_reference(lb, sp, qp, on, d, count,
                                                ring_p)
        n, t = check_refinements(lb, log, ring)
        n_checked += n
        ties += t
        window = ring_read_last(ring, lb.window_len).cpu()
        for row in log.cpu().numpy():
            r = dict(zip(LOG_FIELDS, (int(v) for v in row)))
            if not (r["done"] and r["go"]):
                continue
            tm = cc_refine_terms(
                window[:, [r["ch0"], r["ch1"]]],
                torch.tensor(r["pos0"], dtype=torch.int32),
                torch.tensor(r["pos1"], dtype=torch.int32))
            sched = cc_schedule_reference(tm.x.numpy(), tm.y.numpy(),
                                          r["pos0"], r["pos1"])
            assert (sched["arg"], sched["ok"]) == (r["arg"], bool(r["ok"])), (
                r, sched["arg"])
            n_sched += 1
        same = (all(torch.equal(a, b) for a, b in zip(
            (*sk, *qk[1:], ck), (*sp, *qp[1:], cp)))
            and torch.equal(hk.emits, hp.emits))
        assert same or t, f"kernel differs from plain at {int(count)}"
        if same:
            assert float((hk.points - hp.points).abs().max()) <= 1e-3
        n_fired += fired
        n_quiet += not fired
        n_emit += int(hp.emits.sum())
    assert _cuda.LOCATE_BLOCK.variants[variant] - before == \
        n_fired + n_quiet
    assert n_checked >= 5 and n_emit >= 2, (n_checked, n_emit)
    assert n_sched == n_checked
    print(f"{variant}: {n_checked} refinements, {len(ties)} ties: {ties}")
    return n_checked, ties


def test_locate_block_cc_refine_matches_plain():
    """The locate kernel with CC refinement and the ring write in place,
    from the plain version's state before every block, against the plain
    ring write and the plain version (the JAX step's refinement, its CC by
    rFFT) on a synthetic stream's fired and quiet blocks: the ring, state,
    queue, counter and emits exactly, points within 1e-3 cm; each logged
    refinement held to the plain one on its window (an argmax may differ
    only at a float32 tie of the plain CC) and to the kernel's schedule on
    the CPU (the same argmax)."""
    _cc_refine_kernel_matches_plain()


@pytest.mark.parametrize("mode,hidden", FCNN_HIDDEN)
def test_locate_block_fcnn_cc_refine_matches_plain(mode, hidden):
    """The same with the learned locator as well (variant
    "ring+fcnn+cc_refine", JAX's ``make_locate_update(model=, cc_refine=True)``):
    the refinement moves the onsets, the packed FCNN places the hit (its
    vectors after the refinement's sections in the dynamic shared
    memory)."""
    _cc_refine_kernel_matches_plain(_locate_fcnn(hidden), mode)


def test_engine_cc_refine_graph_is_three_kernels():
    """``cc_refine=True`` on the card: the captured step is still K1 and
    the locate kernel, which writes the ring and then reads it itself (two
    kernels, where the step had three before the ring write moved into
    the locate launch)."""
    from onset_fingerprinting_torch.tools.step_bench import graph_nodes

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cuda", ring_seconds=1.0, event_queue=64,
                           cc_refine=True)
    types, names = graph_nodes(eng._graph.graph)
    assert types == {"kernel": 2}, (types, names)


def _streams_match_plain(n, gpc, named, variant, emit_rel):
    """K1's stream-batched launch (each stream from its own state, warmed on
    its own lead) against the plain detector stream by stream: events, rel
    and every state tensor bit for bit."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        DetectorState,
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_streams,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.workload import make_audio

    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=2000.0,
                         backtrack=True, backtrack_buffer_size=256)
    fst, params, st, _ = make_fused_detector(cfg)
    x = torch.stack([make_audio(128 * 30, 3, seed=10 + s) for s in range(n)])
    # each stream's own lead of noise (a few blocks of it shift its state)
    lead = [warmup_minmax(fst.plain, params, st, 1e-3 * torch.randn(
        (128 * 4, 3), generator=torch.Generator("cuda").manual_seed(90 + s),
        device="cuda")) for s in range(n)]
    states = DetectorState(*(torch.stack(f).contiguous()
                             for f in zip(*lead)))
    kern = named.variants
    before = kern[variant]
    new, (on, d, rel) = fused_detect_streams(
        fst, params, states, x, emit_rel=emit_rel, groups_per_cta=gpc,
        kernel=named if variant == "streams" else None)
    assert kern[variant] == before + 1
    assert int(on.sum()) > 0 and (rel is None) == (not emit_rel)
    for s in range(n):
        sp, (on_p, d_p, r_p) = detect_offline(fst.plain, params, lead[s],
                                              x[s])
        assert torch.equal(on[s], on_p) and torch.equal(d[s], d_p)
        if emit_rel:
            assert torch.equal(rel[s], r_p)
        for a, b in zip(new, sp):
            assert torch.equal(a[s], b)


def test_detector_warp_streams_matches_plain():
    """``detector_warp.cu``'s stream batch (one CTA per stream; named: the
    routes give it one block)."""
    from onset_fingerprinting_torch.ops import _cuda

    _streams_match_plain(5, None, _cuda.DETECTOR_WARP, "streams", True)


@pytest.mark.parametrize("n,gpc,emit_rel", [
    (5, None, True), (7, 10, True), (7, 3, False), (64, 10, False),
    (21, 8, True)])
def test_detector_pipe_coupled_streams_matches_plain(n, gpc, emit_rel):
    """The coupled pipe over a batch of streams in lane groups (ragged:
    groups past the last stream, a short last CTA) as the route takes it."""
    from onset_fingerprinting_torch.ops import _cuda

    _streams_match_plain(n, gpc, _cuda.DETECTOR_PIPE_COUPLED,
                         "coupled_streams", emit_rel)


@pytest.mark.parametrize("hidden", [None, (128, 128)],
                         ids=["newton", "fcnn-wide"])
def test_locate_streams_matches_plain(hidden):
    """The stream-batched locate entry (one CTA per stream) against its
    plain version, the JAX function's scan, on the detector's events of a
    few synthetic streams: emits exactly, points within 1e-3 cm; Newton,
    and a wide learned locator in the step's FCNN code."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        EV_BIG,
        LocateBlock,
        locate_streams,
        locate_streams_reference,
    )

    sim, _, _ = _engine_stream(0.01)
    eng = sim.build_engine("cpu", ring_seconds=0.01)
    model = None if hidden is None else _locate_fcnn(hidden)
    variant = "streams" if hidden is None else "streams+fcnn"
    lb = LocateBlock(eng.locator, 3, 128, model=model, device="cuda")
    blocks = _block_events(7, n_strikes=24)
    ev = [(count + int(dd), ch) for count, on, d in blocks
          for ch, (o, dd) in enumerate(zip(on, d)) if o]
    ev.sort()
    rows = [ev[: 40], ev[10: 50], ev[:7], ev[30:]]
    e = 48
    on_t = torch.full((len(rows), e), EV_BIG, dtype=torch.int32)
    ch_t = torch.zeros((len(rows), e), dtype=torch.int32)
    for s, r in enumerate(rows):
        on_t[s, : len(r)] = torch.tensor([o for o, _ in r[:e]])
        ch_t[s, : len(r)] = torch.tensor([c for _, c in r[:e]])
    on_t, ch_t = on_t.cuda(), ch_t.cuda()
    before = _cuda.LOCATE_BLOCK.variants[variant]
    pk, ek = locate_streams(lb, on_t, ch_t)
    assert _cuda.LOCATE_BLOCK.variants[variant] == before + 1
    pp, ep = locate_streams_reference(lb, on_t, ch_t)
    assert torch.equal(ek, ep) and int(ek.sum()) >= 10
    assert float((pk - pp).abs().max()) <= 1e-3
