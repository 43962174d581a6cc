"""The float32 flagship on the fleet path (the benchmark's
``fleet4-cccnn-f32`` configuration, cell ``fleet4-f32.hits10``), on the
CPU: a tiny cell of it through the harness, the port's float32 CCCNN
against the plain reference, the head's products held in full float32
whatever the process's TF32 settings, the head's spans and the cell's
metric readers."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import common
from portbench.reference import cccnn as ref_cccnn
from portbench.run import load_reader, run_cell
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.utils import metrics as pmetrics

REPO = Path(__file__).resolve().parent.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "fleet4-f32.hits10"
CONFIG = "fleet4-cccnn-f32"
SEED = 2 ** 31 + 3
#: the port's float32 CCCNN against the plain reference, largest gap over
#: the reference's largest magnitude: float32 rounding (K3's sums against
#: the reference's F.conv1d, the DFT's products against direct sums)
#: leaves 4e-7 - 8e-7 of scale on these windows; a bf16 forward leaves
#: 3e-3 - 6e-3 (bf16 keeps 8 bits, 4e-3 a rounding) and a TF32 head
#: (10 bits) about 1e-3 a product
F32_TOL = 1e-5


def _file(kind, name):
    return json.loads((REPO / "portbench" / kind / f"{name}.json")
                      .read_text())


def _cell(name):
    return next(w for w in BENCH["workloads"] if w["name"] == name)


def _model_cfg():
    return _file("configs", CONFIG)["model"]


def _model(w, dtype=torch.float32):
    m = _model_cfg()
    model = CCCNN(input_size=256, dtype=dtype,
                  **{k: v for k, v in m.items() if k != "padding"})
    model.load_state_dict(common.state_dict_of(w))
    return model.eval()


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark of one tiny f32 fleet cell in a temporary directory:
    the new configuration at 6 streams and chunks of 3840, hits10's
    traffic at a hit every 1920 samples, held to ``fleet4-f32.hits10``'s
    limits, the metric readers copied beside it."""
    root = tmp_path_factory.mktemp("bench")
    base = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True)
    shutil.copytree(REPO / "portbench" / "metrics", base / "metrics")
    cell = _cell(CELL)
    cfg = dict(_file("configs", CONFIG), streams=6, chunk_samples=3840)
    tr = dict(_file("traffic", cell["traffic"]), hit_period=1920,
              check_streams=4, keep_every=1, check_calls=2)
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny.json").write_text(json.dumps(tr))
    shutil.copy(REPO / "portbench" / "limits" / f"{CELL}.json",
                base / "limits" / "tiny.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] = [dict(name="tiny", source="x", reduced=[],
                             file="portbench/configs/tiny.json",
                             why="tiny")]
    bench["workloads"] = [dict(name="tiny", config="tiny", traffic="tiny",
                               chips=1, why="tiny")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _bf16_model(system):
    """The CCCNN switched to bf16 after the system is built."""
    system.run.model.dtype = torch.bfloat16


def test_config_is_the_bf16_flagship_in_float32():
    """Every key of the bf16 flagship's configuration but ``dtype`` (and
    the words that name the deployment); nothing reduced; one chip, on
    hits10's traffic."""
    f32, bf16 = _file("configs", CONFIG), _file("configs",
                                                 "fleet4-cccnn-bf16")
    words = ("source", "deployment", "assumed", "dtype")
    assert {k: v for k, v in f32.items() if k not in words} == \
        {k: v for k, v in bf16.items() if k not in words}
    assert f32["dtype"] == "float32"
    assert f32["assumed"] == [a for a in bf16["assumed"] if a != "dtype"]
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == []
    cell = _cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "fleet4-bf16.hits10", 1)


def test_tiny_f32_cell_is_correct(tiny_root):
    res, lines = run_cell(tiny_root, "tiny", SEED, 0.3, False,
                          device="cpu")
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"throughput", "batch_ms.p95", "setup_s"}
    assert res["check"]["exact_off"]["value"] == 0
    assert res["check"]["pred_gap"]["value"] < \
        res["check"]["pred_gap"]["limit"]


def test_tiny_cell_with_a_bf16_model_is_not_correct(tiny_root):
    """The same cell with the CCCNN computing in bf16 fails the f32 cell's
    ``pred_gap`` and ``pred_rms``: the limits tell the precisions apart."""
    res, lines = run_cell(tiny_root, "tiny", SEED, 0.3, False,
                          device="cpu", faults=(_bf16_model,))
    assert not res["correct"], lines
    assert res["check"]["pred_gap"]["value"] > \
        res["check"]["pred_gap"]["limit"]
    assert res["check"]["pred_rms"]["value"] > \
        res["check"]["pred_rms"]["limit"]


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_f32_cccnn_matches_reference_and_bf16_does_not(seed):
    """At the configuration's widths on seeded weights the port's float32
    CCCNN is the reference's forward to ``F32_TOL`` of its scale; the same
    weights in bf16 are not."""
    m = _model_cfg()
    w = common.cccnn_weights(m, 256, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(64, m["channels"], 256, generator=g) * 0.3
    ref = ref_cccnn.forward(x, w)
    scale = float(ref.abs().max())
    with torch.no_grad():
        f32 = _model(w)(x)
        bf16 = _model(w, torch.bfloat16)(x)
    assert float((f32 - ref).abs().max()) < F32_TOL * scale
    assert float((bf16 - ref).abs().max()) > 10 * F32_TOL * scale


def _settings():
    """The float32 matmul settings as the public attributes read them (a
    read that the process's mix of settings refuses reads None)."""
    def read(fn):
        try:
            return fn()
        except RuntimeError:
            return None
    be = torch.backends
    return dict(
        precision=read(torch.get_float32_matmul_precision),
        allow_tf32=read(lambda: be.cuda.matmul.allow_tf32),
        generic=read(lambda: be.fp32_precision),
        cuda=read(lambda: be.cuda.matmul.fp32_precision),
        cpu=read(lambda: be.mkldnn.matmul.fp32_precision))


@pytest.fixture
def process_settings():
    """Puts the process's float32 matmul settings back after the test."""
    before = _settings()
    yield
    be = torch.backends
    torch.set_float32_matmul_precision(before["precision"])
    be.fp32_precision = before["generic"]
    be.cuda.matmul.fp32_precision = before["cuda"]
    be.mkldnn.matmul.fp32_precision = before["cpu"]
    assert _settings() == before


def _lightning():
    torch.set_float32_matmul_precision("high")


def _allow_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True


def _both():
    torch.set_float32_matmul_precision("medium")
    torch.backends.cuda.matmul.allow_tf32 = True


def _new_api():
    torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.mark.parametrize("turn_on", [_lightning, _allow_tf32, _both,
                                     _new_api],
                         ids=["set_float32_matmul_precision", "allow_tf32",
                              "both", "fp32_precision"])
def test_f32_head_holds_full_f32_whatever_the_process_set(
        turn_on, process_settings, monkeypatch):
    """With TF32 turned on process-wide, the float32 head's three DFT
    products and its dense layer run with cuBLAS's TF32 off and the
    precision "highest"; the process's settings are as they were after."""
    w = common.cccnn_weights(_model_cfg(), 256, 3, "cpu")
    model = _model(w)
    x = torch.randn(4, 4, 256) * 0.3
    turn_on()
    before = _settings()
    assert before["allow_tf32"] is not False
    seen = []

    def spy(fn, name):
        def wrapped(*a, **k):
            s = _settings()
            seen.append((name, s["allow_tf32"], s["precision"]))
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(torch, "matmul", spy(torch.matmul, "matmul"))
    monkeypatch.setattr(torch.nn.functional, "linear",
                        spy(torch.nn.functional.linear, "linear"))
    with torch.no_grad():
        model(x)
    assert [n for n, *_ in seen] == ["matmul"] * 3 + ["linear"]
    assert all(a is False for _, a, _ in seen), seen
    # where the process's settings leave the precision readable
    assert all(p in ("highest", None) for *_, p in seen), seen
    if before["precision"] is not None:
        assert all(p == "highest" for *_, p in seen), seen
    assert _settings() == before


def test_f32_forward_opens_the_head_spans_inside_the_head():
    """Under a profiler, the float32 forward opens ``cccnn.head_spectrum``,
    ``cccnn.head_inverse`` and ``cccnn.head_dense`` once each, in that
    order, inside ``cccnn.head``."""
    w = common.cccnn_weights(_model_cfg(), 256, 4, "cpu")
    model = _model(w)
    x = torch.randn(3, 4, 256) * 0.3
    with torch.no_grad():
        model(x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model(x)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in pmetrics.SPANS)
    names = [n for *_, n in spans]
    assert names == ["cccnn.features", "cccnn.head", "cccnn.head_spectrum",
                     "cccnn.head_inverse", "cccnn.head_dense"]
    (_, _, _), (h0, h1, _), *inner = spans
    assert all(h0 <= s and t <= h1 for s, t, _ in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_seconds(self, pattern):
        hits = [v for k, v in self.kernels.items() if pattern in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)


#: a small model whose work is counted by hand below: 2 channels, a window
#: of 8, two layers of 2 and 3 maps with kernels of 3 (V stays 8)
SMALL = dict(channels=2, window=8, layer_sizes=[2, 3], kernel_sizes=[3, 3],
             padding=1, output_size=2)
#: per signal: layer 1 2·1·2·3·8 + 5·2·8 = 176, layer 2 2·2·3·3·8 + 5·3·8 =
#: 408; bytes 8·4 in, 8·3·4 out
CONV_OPS, CONV_BYTES = 584, 128
#: per window: the correlation 2·(2·3·8·8) = 768, the normalisation
#: 2·(15 + 1) = 32, the dense layer 2·(2·15 + 2)·2 = 128; features 2·8·3·4
HEAD_OPS, HEAD_BYTES = 928, 192


def _ctx(trace):
    return SimpleNamespace(
        calls=10, items_per_call=1000.0, window_s=2.0,
        spans={"predict": 1.2}, shapes={"model": SMALL}, trace=trace)


def test_f32_readers_count_by_hand():
    """``k3_f32_roofline``, ``head_f32_roofline``, ``step_mfu.f32`` and
    ``model_ms.fleet_f32`` on a hand-built run: 10 calls of 1000 real
    hits, K3 f32 0.2 ms a call of the predict span's 1.2 (the tensor-core
    kernels' names do not count)."""
    ctx = _ctx(_Trace({"void conv_stack_kernel<5>(StackDesc)": [0.002, 10],
                       "conv_stack_mma_kernel(MmaDesc)": [5.0, 10],
                       "conv_stack_cluster_kernel": [5.0, 10]}))
    signals = 1000 * 2
    k3_ms = 1e3 * max(signals * CONV_OPS / 67e12,
                      signals * CONV_BYTES / 3.35e12)  # bytes
    assert load_reader(REPO, "k3_f32_roofline")(ctx) == pytest.approx(
        100 * k3_ms / 0.2)
    head_ms = 1e3 * max(1000 * HEAD_OPS / 67e12,
                        1000 * HEAD_BYTES / 3.35e12)  # bytes
    assert load_reader(REPO, "head_f32_roofline")(ctx) == pytest.approx(
        100 * head_ms / (1.2 - 0.2))
    per_window = 2 * CONV_OPS + HEAD_OPS
    assert load_reader(REPO, "step_mfu.f32")(ctx) == pytest.approx(
        100 * per_window * 1000 * 10 / 2.0 / 67e12)
    assert load_reader(REPO, "model_ms.fleet_f32")(ctx) == 1.2


def test_f32_readers_read_nothing_without_a_trace_or_the_kernel():
    ctx = _ctx(None)
    assert load_reader(REPO, "k3_f32_roofline")(ctx) is None
    assert load_reader(REPO, "head_f32_roofline")(ctx) is None
    ctx = _ctx(_Trace({"conv_stack_mma_kernel(MmaDesc)": [5.0, 10]}))
    assert load_reader(REPO, "k3_f32_roofline")(ctx) is None
    assert load_reader(REPO, "head_f32_roofline")(ctx) is None
    ctx = _ctx(None)
    ctx.spans, ctx.calls = {}, 0
    assert load_reader(REPO, "model_ms.fleet_f32")(ctx) is None
    assert load_reader(REPO, "step_mfu.f32")(ctx) is None
