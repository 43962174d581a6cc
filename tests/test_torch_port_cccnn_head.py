"""The CCCNN's bf16 DFT head kernel on the CPU (``ops/cccnn_head.py``):
its plain version against the chain it replaces (``batch_self_correlate_dft``
at ``"default"`` precision, ``cc_norm``, ``fc``) at the flagship's widths,
the lanes' DFT fragments and the inverse rows it loads, its plan's shared
memory for every tile, and the rule by which ``CCCNN.forward`` takes it.
The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops import cccnn_head as ch
from onset_fingerprinting_torch.ops.xcorr import (
    _dft_matrices,
    batch_self_correlate_dft,
)
from onset_fingerprinting_torch.utils import metrics as pmetrics
from onset_fingerprinting_torch.workload import FLAGSHIP

V, K = 133, 5


def k3_features(b: int, c: int, v: int = V, k: int = K, seed: int = 0):
    """bf16-valued float32 features as K3 writes them, ``[B*C, V, K]``,
    seen as ``[B, C, K, V]``."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((b * c, v, k), generator=g).to(torch.bfloat16)
    return raw.to(torch.float32).reshape(b, c, v, k).transpose(2, 3)


def dense(c: int, o: int, v: int = V, seed: int = 1) -> torch.nn.Linear:
    torch.manual_seed(seed)
    return torch.nn.Linear(c * (2 * v - 1) + c, o)


def chain(feats, fc):
    """The head as ``CCCNN.forward`` runs it without the kernel."""
    b, v = feats.shape[0], feats.shape[-1]
    cc = batch_self_correlate_dft(feats, sum_axis=2, precision="default")
    lag0 = cc[..., v - 1: v] + 1e-6
    probs = torch.cat([(cc / lag0).reshape(b, -1),
                       torch.log(lag0).reshape(b, -1)], dim=-1)
    return fc(probs)


@pytest.mark.parametrize("b", [1, 7, 37])
@pytest.mark.parametrize("c,o", [(4, 2), (3, 3)])
def test_reference_equals_the_chain(c, o, b):
    """Same rounding points, the maps summed in order: the plain version
    and the chain agree to f32 rounding of the output (here bit for bit)."""
    feats, fc = k3_features(b, c, seed=b), dense(c, o)
    with torch.no_grad():
        got = ch.self_cc_head_reference(feats, fc.weight, fc.bias)
        want = chain(feats, fc)
    assert got.shape == (b, o) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def test_reference_matches_a_float64_emulation():
    """The plain version against float64 sums from the same rounding points
    (features, DFT matrices and power in bf16): within 1e-3 of the output's
    scale (an f32 sum may round the power to the other bf16 neighbour)."""
    feats, fc = k3_features(9, 4, seed=3), dense(4, 2)
    re_m, im_m, inv = _dft_matrices(V)
    a = bf16(feats.numpy()).astype(np.float64)
    re = a @ bf16(re_m).astype(np.float64)
    im = a @ bf16(im_m).astype(np.float64)
    power = bf16((re * re + im * im).sum(axis=2).astype(np.float32))
    cc = power.astype(np.float64) @ bf16(inv).astype(np.float64)
    lag0 = cc[..., V - 1: V] + 1e-6
    probs = np.concatenate([(cc / lag0).reshape(9, -1),
                            np.log(lag0).reshape(9, -1)], axis=-1)
    w = fc.weight.detach().double().numpy()
    want = probs @ w.T + fc.bias.detach().double().numpy()
    with torch.no_grad():
        got = ch.self_cc_head_reference(feats, fc.weight, fc.bias).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("v", [133, 64, 20, 1])
def test_forward_fragments_hold_the_bf16_dft_matrices(v):
    """Each lane's B fragments, decoded by the m16n8k16 layout (b0: rows 2t,
    2t + 1 of column g; b1: rows 2t + 8, 2t + 9), give back the bf16 DFT
    matrices, zero past V and past F."""
    frag = ch.forward_fragments(v)
    re_m, im_m, _ = _dft_matrices(v)
    f = re_m.shape[1]
    nf, ks = frag.shape[:2]
    assert (nf, ks) == (-(-f // 8), -(-v // 16)) and frag.shape[2:] == (32, 4)
    got = np.zeros((2, ks * 16, nf * 8), np.float32)
    for j in range(nf):
        for s in range(ks):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for m in range(2):
                    for h in range(2):
                        word = int(frag[j, s, lane, 2 * m + h])
                        r = 16 * s + 2 * t + 8 * h
                        for q in range(2):
                            bits = np.uint32(((word >> (16 * q)) & 0xFFFF)
                                             << 16)
                            got[m, r + q, 8 * j + g] = bits.view(np.float32)
    want = np.zeros_like(got)
    want[0, :v, :f] = bf16(re_m)
    want[1, :v, :f] = bf16(im_m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v", [133, 64, 20, 1])
def test_inverse_rows_hold_the_bf16_inverse(v):
    rows = ch.inverse_rows(v)
    _, _, inv = _dft_matrices(v)
    f, n = inv.shape
    assert rows.shape == (8 * -(-n // 8), ch.PITCH) and rows.dtype == np.uint16
    got = (rows.astype(np.uint32) << 16).view(np.float32)
    want = np.zeros_like(got)
    want[:n, :f] = bf16(inv.T)
    np.testing.assert_array_equal(got, want)


def test_plan_serves_the_256_windows_and_not_the_512():
    """The fleet's and the drum's flagship (V = 133) fit; the realtime
    classifier's 512-sample windows (V = 389) stay on the chain, as do
    V > 136, more than 16 channels and more than 8 outputs."""
    fleet, drum = ch.head_plan(4, K, V, 2), ch.head_plan(3, K, V, 3)
    assert fleet is not None and drum is not None
    assert (fleet.per_tile, drum.per_tile) == (4, 5)
    assert max(fleet.smem, drum.smem) <= ch.SMEM_MAX
    assert (fleet.ks, fleet.n_fwd, fleet.n_lag) == (9, 18, 34)
    assert ch.head_plan(3, K, 389, 3) is None
    assert ch.head_plan(4, K, 136, 2) is not None
    assert ch.head_plan(4, K, 137, 2) is None
    assert ch.head_plan(17, K, V, 2) is None
    assert ch.head_plan(4, K, V, 9) is None
    assert ch.head_plan(4, 64, V, 2) is None  # a tile past shared memory


@pytest.mark.parametrize("b,c,v,k", [
    (36480, 4, 133, 5), (32768, 3, 133, 5), (37, 3, 133, 5), (11, 5, 64, 3),
    (9, 1, 20, 7), (3, 16, 7, 2),
])
def test_every_tile_fits_its_shared_floats(b, c, v, k):
    """The chunks ``load_tile`` copies for each tile (16-byte aligned from
    the tile's first byte rounded down) fit ``raw_floats``, never read past
    the features' end, and hold the tile's last float; a tile holds 16 / C
    whole windows of at most 16 signals."""
    plan = ch.head_plan(c, k, v, 2)
    sig = v * k * 4
    total = b * c * sig
    n_tiles = -(-b // plan.per_tile)
    assert plan.per_tile * c <= ch.ROWS
    for tile in {0, 1, n_tiles // 2, n_tiles - 2, n_tiles - 1} - {-1}:
        b0 = tile * plan.per_tile
        nb = min(plan.per_tile, b - b0)
        start, end = b0 * c * sig, (b0 + nb) * c * sig
        lo = start & ~15
        chunks = (end - lo + 15) >> 4
        assert 4 * chunks <= plan.raw_floats
        assert lo + 16 * (chunks - 1) < total
        assert (start - lo) // 4 + nb * c * v * k <= 4 * chunks


class _Feats:
    """Stands for features on the card: the rule reads only these."""

    def __init__(self, shape, device="cuda", requires_grad=False):
        self.shape = shape
        self.device = torch.device(device)
        self.requires_grad = requires_grad


def _model(window=256, channels=4, out=2, **kw):
    cfg = {**FLAGSHIP, "channels": channels, "output_size": out,
           "dtype": torch.bfloat16, **kw}
    return CCCNN(input_size=window, **cfg).eval()


@pytest.mark.parametrize("case,engages", [
    ("bf16_eval_cuda", True), ("drum", True), ("no_grad", True),
    ("f32", False), ("training", False), ("grad", False),
    ("feats_grad", False), ("cc_pairs", False), ("cpu", False),
    ("softmax", False), ("fft", False), ("window512", False),
    ("f64_fc", False),
])
def test_selection_rule(case, engages):
    """bf16 in eval on the card with no gradient takes the kernel; f32, a
    training model, a gradient, the pair head, the CPU, the softmax head,
    the FFT head, a shape the plan does not serve or a non-f32 fc keep the
    chain."""
    kw, feats = {}, _Feats((5, 4, K, V))
    grad = False
    if case == "drum":
        kw, feats = dict(channels=3, out=3), _Feats((5, 3, K, V))
    elif case == "f32":
        kw = dict(dtype=torch.float32)
    elif case == "cc_pairs":
        kw = dict(cc_pairs="adjacent")
    elif case == "softmax":
        kw = dict(cc_norm=False)
    elif case == "fft":
        kw = dict(cc_impl="fft")
    elif case == "window512":
        kw, feats = dict(window=512, channels=3, out=3), _Feats(
            (5, 3, K, 389))
    elif case == "cpu":
        feats = _Feats((5, 4, K, V), device="cpu")
    elif case == "feats_grad":
        feats, grad = _Feats((5, 4, K, V), requires_grad=True), True
    elif case == "grad":
        grad = True
    model = _model(**kw)
    if case == "training":
        model.train()
    if case == "f64_fc":
        model.fc.double()
    if case == "no_grad":
        for p in model.parameters():
            p.requires_grad_(False)
        grad = True
    with torch.set_grad_enabled(grad):
        assert model.head_on_kernel(feats) is engages


@pytest.fixture
def recording(monkeypatch):
    """Counters kept as while a profiler records."""
    pmetrics.reset_counters()
    monkeypatch.setattr(pmetrics, "_recording", lambda: True)
    yield pmetrics
    pmetrics.reset_counters()


def test_forward_on_the_cpu_keeps_the_chain(recording):
    model = _model()
    x = torch.randn((6, 4, 256), generator=torch.Generator().manual_seed(2))
    before = (_cuda.CCCNN_HEAD.launches, _cuda.CCCNN_HEAD.plain_calls)
    with torch.inference_mode():
        model(x)
    assert (_cuda.CCCNN_HEAD.launches, _cuda.CCCNN_HEAD.plain_calls) == before
    assert recording.counters() == {"model_rows": 6}


@pytest.mark.parametrize("channels,out", [(4, 2), (3, 3)])
def test_forward_through_the_kernel_branch(recording, monkeypatch, channels,
                                           out):
    """The kernel's branch of ``CCCNN.forward``, taken on the CPU (the rule
    forced), runs the plain version once, counts its rows and gives the
    chain's outputs."""
    model = _model(channels=channels, out=out)
    x = torch.randn((7, channels, 256),
                    generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        monkeypatch.setattr(CCCNN, "head_on_kernel", lambda self, f: True)
        plain = _cuda.CCCNN_HEAD.plain_calls
        got = model(x)
    assert _cuda.CCCNN_HEAD.plain_calls == plain + 1
    assert recording.counters() == {"model_rows": 14, "head_kernel_rows": 7}
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_layouts_k3_view_without_a_copy_and_contiguous():
    """K3's ``[B*C, V, K]`` seen as ``[B, C, K, V]`` goes in as it is (v
    stride K, k stride 1); a contiguous ``[B, C, K, V]`` with v stride 1;
    any other layout as a contiguous copy.  All give the same head."""
    feats, fc = k3_features(5, 4, seed=4), dense(4, 2)
    x, sv, sk = ch._layout(feats)
    assert (sv, sk) == (K, 1) and x.data_ptr() == feats.data_ptr()
    cont = feats.contiguous()
    x, sv, sk = ch._layout(cont)
    assert (sv, sk) == (1, V) and x.data_ptr() == cont.data_ptr()
    x, sv, sk = ch._layout(feats.permute(1, 0, 2, 3).transpose(0, 1))
    assert (sv, sk) == (K, 1) or x.is_contiguous()
    with torch.no_grad():
        a = ch.self_cc_head(feats, fc.weight, fc.bias)
        b = ch.self_cc_head(cont, fc.weight, fc.bias)
    assert torch.equal(a, b)


def _fma(a, b, c):
    """a * b + c in numpy's long double, then rounded to double (near a
    fused multiply-add: enough for the refinement to converge)."""
    return (a.astype(np.longdouble) * b + c).astype(np.float64)


def test_double_reciprocal_product_rounds_as_the_division():
    """The kernel divides cc by lag 0 as (float)(cc * recip(lag 0)), recip
    a reciprocal refined twice in double: within 2^-51 of x / y, which lies
    at least 2^-49 from a midpoint between floats, so it rounds to the float
    that IEEE division gives.  Here on random and near-midpoint quotients,
    the refinement started from a float reciprocal as rcp.approx starts."""
    rng = np.random.default_rng(0)
    n = 200_000
    y = (10.0 ** rng.uniform(-6, 4, n)).astype(np.float32)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 3, n)).astype(
        np.float32)
    # x / y close to a midpoint: x = fl(m * y) for m halfway between floats
    m = rng.uniform(-1, 1, n).astype(np.float32)
    mid = m.astype(np.float64) + np.spacing(np.abs(m)).astype(np.float64) / 2
    x_mid = (mid * y.astype(np.float64)).astype(np.float32)
    yd = y.astype(np.float64)
    r = (1.0 / y).astype(np.float64)
    for _ in range(2):
        r = _fma(_fma(-yd, r, np.ones_like(r)), r, r)
    for xs in (x, x_mid):
        got = (xs.astype(np.float64) * r).astype(np.float32)
        np.testing.assert_array_equal(got, xs / y)


def test_head_kernel_share_reads_the_counters(monkeypatch):
    """The benchmark's ``head_kernel_share``: head-kernel rows over model
    rows, in %; nothing to read from a program that keeps no
    ``head_kernel_rows`` (the parent of the kernel) or outside a trace."""
    from pathlib import Path
    from types import SimpleNamespace

    from portbench.run import load_reader

    read = load_reader(Path(__file__).resolve().parents[1],
                       "head_kernel_share")
    ctx = SimpleNamespace(calls=10, items_per_call=24.5, trace=object())
    monkeypatch.setattr(pmetrics, "counters", lambda: {
        "model_rows": 320, "head_kernel_rows": 320})
    assert read(ctx) == pytest.approx(100.0)
    monkeypatch.setattr(pmetrics, "counters", lambda: {
        "model_rows": 320, "head_kernel_rows": 80})
    assert read(ctx) == pytest.approx(25.0)
    monkeypatch.setattr(pmetrics, "counters", lambda: {"model_rows": 320})
    assert read(ctx) is None
    monkeypatch.setattr(pmetrics, "counters", lambda: {})
    assert read(ctx) is None
    monkeypatch.setattr(pmetrics, "counters", lambda: {
        "model_rows": 320, "head_kernel_rows": 320})
    ctx.trace = None
    assert read(ctx) is None
