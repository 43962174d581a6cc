"""CPU tests of the benchmark: the generator, the gate, the operation and
byte counts, BENCHMARK.json's names, the plain reference against the
port's CPU plain paths, the import guard, a cell defined only in a
temporary directory, the control and the planted faults.  The cell on the
card is marked ``cuda`` and skips without one.

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import common, flops, generate, readers
from portbench.reference import cccnn as ref_cccnn
from portbench.reference import detector as ref_det
from portbench.reference import hits as ref_hits
from portbench.reference.locator import Locator
from portbench.run import FORBIDDEN, run_cell
from portbench.systems import fleet

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _traffic(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


# -- the tiny cells: a benchmark defined only in a temporary directory ----

TINY = {
    "fleet-tiny": ("fleet4-cccnn-bf16", "fleet4-bf16.hits10",
                   dict(streams=6, chunk_samples=3840),
                   dict(hit_period=1920, check_streams=4, keep_every=1,
                        check_calls=2)),
    "drum-tiny": ("drum3-cccnn-bf16", "drum3-bf16.streams1024",
                  dict(streams=2, seconds=0.125),
                  dict(strike_period=4000, tail_guard=1500, batches=2,
                       check_streams=2, keep_every=1, check_calls=2,
                       lead_in_blocks=40)),
}
#: each tiny cell is held to the limits of the cell it shrinks
LIMITS_OF = {"fleet-tiny": "fleet4-bf16.hits10",
             "drum-tiny": "drum3-bf16.streams1024"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """BENCHMARK.json and the files of two tiny cells in a temporary
    directory, the metric readers copied beside them."""
    root = tmp_path_factory.mktemp("bench")
    base = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True)
    shutil.copytree(ROOT / "portbench" / "metrics", base / "metrics")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"], bench["workloads"] = [], []
    for name, (cfg, tr, cov, tov) in TINY.items():
        c = dict(_cfg(cfg), **cov)
        (base / "configs" / f"{name}.json").write_text(json.dumps(c))
        (base / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(_traffic(tr), **tov)))
        shutil.copy(ROOT / "portbench" / "limits"
                    / f"{LIMITS_OF[name]}.json",
                    base / "limits" / f"{name}.json")
        bench["configs"].append(dict(name=name, source="x", reduced=[],
                                     file=f"portbench/configs/{name}.json",
                                     why="tiny"))
        bench["workloads"].append(dict(name=name, config=name, traffic=name,
                                       chips=1, why="tiny"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# -- the generator ------------------------------------------------------------

def test_fleet_hit_grid_phases_and_capacity():
    cfg = dict(_cfg("fleet4-cccnn-bf16"), streams=5, chunk_samples=3840)
    tr = dict(_traffic("fleet4-bf16.hits10"), hit_period=1920)
    a = generate.fleet_hits(tr, cfg, 2 ** 31 + 11, "cpu")
    b = generate.fleet_hits(tr, cfg, 2 ** 31 + 11, "cpu")
    assert torch.equal(a.ring, b.ring)
    assert len(set(a.phases.tolist())) > 1
    # every seed sends the same arrivals, dealt to the streams in its order
    c = generate.fleet_hits(tr, cfg, 7, "cpu")
    assert sorted(c.phases) == sorted(a.phases)
    assert np.array_equal(c.counts.sum(axis=1), a.counts.sum(axis=1))
    assert not np.array_equal(c.phases, a.phases)
    x = a.ring.view(a.ring.shape[0], 5, 4)
    for s in range(5):
        onsets = np.arange(a.phases[s], a.ring.shape[0], 1920)
        pos = onsets % 3840
        inside = (pos >= tr["lead"]) & (pos <= 3840 - 700)
        for j in range(3):
            want = int(np.sum(inside & (onsets // 3840 == j)))
            assert a.counts[j, s] == want
        for o, keep in zip(onsets, inside):
            peak = float(x[o:o + 150, s].abs().max())
            assert (peak > 0.02) == bool(keep)
            # the same burst on every channel: they differ by noise alone
            spread = x[o:o + 600, s] - x[o:o + 600, s].mean(-1, keepdim=True)
            assert float(spread.abs().max()) < 10 * tr["noise"]
    # the port's sizing rule at both rates
    full = _cfg("fleet4-cccnn-bf16")
    assert fleet.capacity(full, _traffic("fleet4-bf16.hits10")) == 36480
    assert fleet.capacity(full, _traffic("fleet4-bf16.hits1")) == 3712
    assert fleet.max_hits(full) == 6


def test_drum_strikes_per_stream_phase():
    cfg = dict(_cfg("drum3-cccnn-bf16"), streams=3, seconds=0.25)
    tr = dict(_traffic("drum3-bf16.streams1024"), strike_period=6000,
              tail_guard=1500, batches=2)
    a = generate.drum_strikes(tr, cfg, 5, "cpu")
    assert tuple(a.batches.shape) == (2, 3, 23936, 3)
    firsts = {st[0][0] for b in a.strikes for st in b}
    assert len(firsts) > 1
    radius = cfg["diameter_cm"] / 2
    for b in a.strikes:
        for st in b:
            assert [o for o, _, _ in st] == list(
                range(st[0][0], 23936 - 1500, 6000))
            for _, x, y in st:
                assert 0.2 * radius <= math.hypot(x, y) <= 0.7417 * radius


# -- the gate and the counts ----------------------------------------------------

def test_gaps():
    assert common.rel_gap([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert common.rel_gap([1.0, 2.5], [1.0, 2.0]) == 0.25
    assert common.yard_gap([[3.0], [4.0]], [[3.0], [5.0]],
                           [[3.5], [3.0]]) == 0.5
    assert common.yard_gap([[3.0], [4.0]], [[3.0], [5.0]], [[3.0], [3.0]],
                           rms=True) == 0.5
    assert common.rel_gap([np.nan], [1.0]) == float("inf")
    plan = common.KeepPlan(7, 4, 3)
    assert plan.kept(0)
    picked = plan.choose([0, 5, 9, 12])
    assert picked[0] == 0 and len(picked) == 3


def test_counts_against_hand_counts():
    # 2 channels, 256 samples (2 blocks) with the high-pass: per sample
    # 17 + 5 + 11 + 5 + 9 + 3 = 50, per block and channel 4
    w = flops.detector_work(2, 256, 128, True)
    assert w["flops"] == 2 * (256 * 50 + 2 * 4)
    assert w["bytes"] == 2 * (256 * 4 + 2 * 5)
    assert flops.detector_work(1, 128, 128, False)["flops"] == 128 * 33 + 4
    # one layer 1 -> 2 maps, kernel 3, padding 1 on 8 samples: 8 outputs
    # of 2 maps, 3 multiply-adds each, plus 5 for bias and SiLU
    c = flops.conv_stack_work(4, 8, [2], [3])
    assert c["flops"] == 4 * (2 * 1 * 2 * 3 * 8 + 5 * 2 * 8)
    assert c["bytes"] == 4 * (8 * 4 + 8 * 2 * 4)
    m = dict(channels=1, window=8, layer_sizes=[2], kernel_sizes=[3],
             output_size=2)
    v = 8
    assert flops.cccnn_forward_flops(m) == (
        c["flops"] / 4 + 2 * 2 * v * v + (2 * v) + 2 * (2 * v - 1 + 1) * 2)
    ms, bound = flops.roofline_ms(dict(flops=67e9, bytes=1.0),
                                  flops.F32_FLOPS)
    assert ms == pytest.approx(1.0) and bound == "operations"


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_seconds(self, pattern):
        hits = [v for k, v in self.kernels.items() if pattern in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)


def test_readers_count_the_work_the_inputs_need():
    """The rooflines count a call's real items, not the capacity the
    kernels run over, and the metrics' data entries load their shared
    readers."""
    from portbench.run import load_reader

    model = dict(channels=3, window=256, layer_sizes=[5] * 7,
                 kernel_sizes=[1, 33, 64, 15, 15, 15, 1], padding=1)
    ctx = SimpleNamespace(
        calls=10, items_per_call=7.5 * 1024, spans={"detect": 2.5},
        shapes={"model": model, "detector": dict(
            channels=3072, samples=192000, block=128, hipass=False)},
        trace=_Trace({"conv_stack_mma_kernel<5>": [0.01, 10],
                      "detector_pipe_kernel<x>": [0.08, 10],
                      "locate_streams_kernel": [0.001, 10]}))
    work = flops.conv_stack_work(7.5 * 1024 * 3, 256, [5] * 7,
                                 model["kernel_sizes"])
    k3 = load_reader(ROOT, "k3_mma_roofline")(ctx)
    assert k3 == pytest.approx(100 * flops.roofline_ms(
        work, flops.BF16_FLOPS)[0] / 1.0)
    k1 = load_reader(ROOT, "k1_coupled_roofline")(ctx)
    assert k1 == pytest.approx(100 * flops.roofline_ms(flops.detector_work(
        3072, 192000, 128, False), flops.F32_FLOPS)[0] / 8.0)
    assert load_reader(ROOT, "locate_ms.drum3")(ctx) == pytest.approx(0.1)
    assert load_reader(ROOT, "detect_ms.fleet")(ctx) == 2.5
    assert load_reader(ROOT, "gather_ms.fleet")(ctx) is None
    ctx.trace = None
    assert load_reader(ROOT, "k3_mma_roofline")(ctx) is None
    assert load_reader(ROOT, "k1_pipe_roofline")(ctx) is None


def test_benchmark_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    base = ROOT / "portbench"
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (base / "traffic" / f"{w['traffic']}.json").is_file()
        assert (base / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200 and w["chips"] == 1
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        data = base / "metrics" / f"{m['name']}.json"
        if data.is_file():  # a data entry that names a shared reader
            assert callable(getattr(readers, json.loads(
                data.read_text())["reader"]))
        else:
            assert (base / "metrics" / f"{m['name']}.py").is_file()
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


# -- the plain reference against the port's plain paths on the CPU ----------

def test_reference_detector_matches_port_plain():
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        detector_init,
        warmup_minmax,
    )

    for name, group in (("fleet4-cccnn-bf16", 1), ("drum3-cccnn-bf16", 3)):
        d = _cfg(name)["detector"]
        c = 6
        cfg = DetectorConfig(n_channels=c, sr=96000, **d)
        static, params, state = detector_init(cfg, "cpu")
        g = torch.Generator().manual_seed(3)
        x = torch.randn((2560, c), generator=g) * 1e-3
        x[900:1500] += torch.sin(torch.arange(600) * 0.3)[:, None] * 0.5 \
            * torch.exp(-torch.arange(600) / 150.0)[:, None]
        lead = torch.randn((512, c), generator=g) * 1e-3
        state = warmup_minmax(static, params, state, lead)
        new, (on, deltas, _) = detect_offline(static, params, state, x)
        det = ref_det.Detector.from_config(dict(d, sr=96000))
        st = ref_det.warmup(det, ref_det.init_state(det, c), lead.numpy())
        rnew, ron, rd = ref_det.detect(det, st, x.numpy(), group=group)
        assert ron.any()
        assert np.array_equal(on.numpy(), ron)
        assert np.array_equal(deltas.numpy(), rd)
        for f in ("fast", "slow", "min_val", "max_val", "prev_rel"):
            assert common.rel_gap(getattr(new, f).numpy(), rnew[f]) < 1e-5
        assert np.array_equal(new.gate.numpy(), rnew["gate"])
        assert np.array_equal(new.debounce.numpy(), rnew["debounce"])


def test_reference_windows_and_hits_match_port_plain():
    from onset_fingerprinting_torch.ops.windows import (
        compact_hit_list,
        gather_hit_windows_reference,
        top_hit_blocks,
    )

    rng = np.random.default_rng(0)
    on = rng.random((20, 8)) < 0.1
    deltas = rng.integers(0, 128, (20, 8)).astype(np.int32)
    st, v = top_hit_blocks(torch.as_tensor(on), 128, 2, 6,
                           torch.as_tensor(deltas))
    starts, sids, valid, _ = compact_hit_list(st, v, 64)
    for s in range(2):
        want = ref_hits.stream_hit_starts(on[:, s * 4:(s + 1) * 4],
                                          deltas[:, s * 4:(s + 1) * 4], 128,
                                          6)
        got = starts[valid & (sids == s)].tolist()
        assert got == want
    x = torch.randn(2560, 8)
    s = torch.tensor([0, 100, 2500], dtype=torch.int32)
    i = torch.tensor([0, 1, 1], dtype=torch.int32)
    w = gather_hit_windows_reference(x, s, i, 4, 256, pre=64, anchored=True)
    for k in range(3):
        ref = ref_hits.anchored_window(
            x.numpy()[:, i[k] * 4:(i[k] + 1) * 4], int(s[k]), 256, 64)
        assert np.array_equal(w[k].numpy(), ref)


def test_reference_cccnn_matches_port_f32():
    from onset_fingerprinting_torch.models.cccnn import CCCNN

    for name in ("fleet4-cccnn-bf16", "drum3-cccnn-bf16"):
        m = _cfg(name)["model"]
        w = common.cccnn_weights(m, 256, 9, "cpu")
        model = CCCNN(input_size=256, dtype=torch.float32,
                      **{k: v for k, v in m.items() if k != "padding"})
        model.load_state_dict(common.state_dict_of(w))
        x = torch.randn(5, m["channels"], 256) * 0.3
        with torch.no_grad():
            port = model.eval()(x)
        ref = ref_cccnn.forward(x, w)
        ctl = ref_cccnn.forward(x, w, fp8=True)
        assert common.yard_gap(port.numpy(), ref.numpy(), ctl.numpy()) \
            < 1e-2


def test_reference_locator_matches_port_plain():
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        LocateBlock,
        locate_streams_reference,
    )

    cfg = _cfg("drum3-cccnn-bf16")
    polar = [tuple(p) for p in cfg["sensors_polar"]]
    m = Multilaterate3D(polar, drum_diameter=cfg["diameter_cm"],
                        medium="drumhead", sr=96000, c=82.0,
                        feasibility_tols=(1.0, 2.0))
    lb = LocateBlock(m, 3, 128, device="cpu")
    loc = Locator(polar, cfg["diameter_cm"], 96000, 8200.0, (1.0, 2.0))
    xyz = generate.sensor_xyz(polar, cfg["diameter_cm"] / 2)
    rng = np.random.default_rng(1)
    ons, chs = [], []
    for k in range(4):
        r = math.sqrt(rng.uniform(0.04, 0.55)) * cfg["diameter_cm"] / 2
        a = rng.uniform(0, 2 * math.pi)
        d = np.hypot(r * math.cos(a) - xyz[:, 0], r * math.sin(a) - xyz[:, 1])
        ev = sorted((3000 * k + int(round(v / 8200 * 96000)), c)
                    for c, v in enumerate(d))
        ons += [o for o, _ in ev]
        chs += [c for _, c in ev]
    e = 16
    ev_on = torch.full((1, e), common.EV_BIG, dtype=torch.int32)
    ev_ch = torch.zeros((1, e), dtype=torch.int32)
    ev_on[0, :len(ons)] = torch.tensor(ons)
    ev_ch[0, :len(chs)] = torch.tensor(chs)
    pts, ems = locate_streams_reference(lb, ev_on, ev_ch)
    rp, re_ = loc.run(ons, chs)
    assert ems[0, :len(ons)].sum() == 4
    assert np.array_equal(ems[0, :len(ons)].numpy(), re_)
    assert np.max(np.abs(pts[0, :len(ons)].numpy() - rp)) < 1e-3


# -- the import guard -----------------------------------------------------------

def test_no_jax_in_the_measured_process():
    code = (
        "import sys; import portbench.run, portbench.calibrate;"
        "import portbench.systems.fleet, portbench.systems.drum;"
        "import onset_fingerprinting_torch.pipeline;"
        "import onset_fingerprinting_torch.parallel;"
        "import onset_fingerprinting_torch.ops.locate_block;"
        "bad = {m.split('.')[0] for m in sys.modules} & set(%r);"
        "print(sorted(bad)); sys.exit(1 if bad else 0)" % (FORBIDDEN,))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    for f in (ROOT / "portbench").rglob("*.py"):
        src = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|jaxlib|"
                             r"onset_fingerprinting_tpu|bench)\b", src,
                             re.M), f
        if f.parent.name == "reference":
            assert "onset_fingerprinting_torch" not in src, f


# -- whole runs of the tiny cells -----------------------------------------------

def _run(root, name, faults=(), control=False):
    return run_cell(root, name, 2 ** 31 + 3, 0.3, False, device="cpu",
                    faults=faults, control=control)


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cell_from_temporary_files_is_correct(tiny_root, name):
    res, lines = _run(tiny_root, name)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"throughput", "batch_ms.p95", "setup_s"}
    assert list(res)[-1] == "check"
    assert res["built_kernels"] == 0  # the CPU builds no kernel
    assert res["check"]["exact_off"]["value"] == 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(tiny_root, name):
    """The reference one precision lower (the detector and the locator in
    bfloat16, the CCCNN in float8) in the program's place fails one of the
    cell's limits."""
    res, _ = _run(tiny_root, name, control=True)
    limits = json.loads((tiny_root / "portbench" / "limits"
                         / f"{name}.json").read_text())
    ctl = res["control"]
    assert any(ctl[k] > v for k, v in limits.items() if k in ctl), ctl


def _patch_drum(system, fn):
    run = system.run

    def wrapped(x):
        return fn(*run(x))
    system.run = wrapped


def _half_batch(system):
    if hasattr(system.run, "predict"):
        orig = system.run.predict

        def predict(windows, valid):
            p = orig(windows, valid).clone()
            n = int(valid.sum())
            p[n // 2:n] = p[:n // 2].mean(dim=0)
            return p
        system.run.predict = predict
    else:
        def fn(points, onsets, emits, preds):
            h = preds.shape[0] // 2
            preds = preds.clone()
            preds[h:] = torch.where(emits[h:, :, None],
                                    preds[:h][emits[:h]].mean(dim=0), 0.0)
            return points, onsets, emits, preds
        _patch_drum(system, fn)


def _answer_altered(system):
    if hasattr(system.run, "predict"):
        orig = system.run.predict

        def predict(windows, valid):
            p = orig(windows, valid)
            spread = (p[valid] - p[valid].mean(0)).pow(2).mean().sqrt()
            return torch.where(valid[:, None], p + 0.5 * spread, p)
        system.run.predict = predict
    else:
        def fn(points, onsets, emits, preds):
            p = preds[emits]
            spread = (p - p.mean(0)).pow(2).mean().sqrt()
            return points, onsets, emits, torch.where(
                emits[..., None], preds + 0.5 * spread, preds)
        _patch_drum(system, fn)


def _state_unchanged(system):
    """The fleet's detector hands back the state it was given; the drum's
    locator never leaves its empty slot table (nothing is located)."""
    if hasattr(system.run, "detect"):
        orig = system.run.detect

        def detect(state, x):
            _, on, d = orig(state, x)
            return state, on, d
        system.run.detect = detect
    else:
        def fn(points, onsets, emits, preds):
            return (torch.zeros_like(points), onsets,
                    torch.zeros_like(emits), torch.zeros_like(preds))
        _patch_drum(system, fn)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(TINY))
def test_planted_fault_is_not_correct(tiny_root, name, fault):
    """A run with the timed path broken underneath comes out not correct
    (one chip: no exchange between chips to leave out)."""
    res, lines = _run(tiny_root, name, faults=(FAULTS[fault],))
    assert not res["correct"], lines


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(card, cell):
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], r.stderr[-4000:]
