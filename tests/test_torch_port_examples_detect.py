"""The twins of the examples that detect on a recording, against the JAX
examples on the CPU: ``tools/e2e_locate.py`` (examples/e2e_locate_demo.py),
``tools/fleet_detect.py`` (examples/fleet_detect_demo.py) and the anchored
serving windows of ``tools/serving_window_accuracy.py``
(examples/serving_window_accuracy.py).

Each example is loaded from its file.  The synthesized fixtures are the
examples' bit for bit, except the drum's true hit positions, which come
from float32 cos/sin: XLA's and PyTorch's differ in the last bit on a few
percent of arguments, so those are held within one float32 ulp.  The
events (onsets and channels, groups, the sharded detector's dense
``on``/deltas on JAX's CPU mesh, the anchors) are JAX's exactly, the
located points within 1e-3 cm.  The plain detector on the CPU takes ~0.27
ms per sample, so the drum runs at 12 kHz over 3 hits, the fleet at 2
streams of 0.28 s (a hit each), and the anchors over the session's first
9216 samples (two hits)."""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from onset_fingerprinting_tpu.core.audio_io import read_wav as jread_wav
from onset_fingerprinting_tpu.data.synth import (
    synth_location_session as jsynth,
)
from onset_fingerprinting_tpu.detect import (
    detect_onsets_amplitude as jdetect,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.tools import e2e_locate
from onset_fingerprinting_torch.tools import fleet_detect
from onset_fingerprinting_torch.tools import serving_window_accuracy as swa

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the drum's size here (the demo's: 8 hits at 96 kHz)
E2E_HITS, E2E_SR = 3, 12000
#: the fleet's size here (the demo's: 8 streams of 1 s)
FLEET_STREAMS, FLEET_SECONDS = 2, 0.28
#: the serving session's hits, and the samples the anchors are taken over
SWA_HITS, SWA_CUT = 16, 9216
POINT_TOL = 1e-3  # cm


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    argv, sys.argv = sys.argv, [name]  # the fleet demo reads sys.argv
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def quiet(*a):
    pass


def assert_within_ulp(port, ref):
    port, ref = np.float32(port), np.float32(ref)
    assert np.all(np.abs(port - ref) <= np.spacing(np.abs(ref))), (port, ref)


def assert_truths_match(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p[0] == r[0]
        assert_within_ulp(p[1:], r[1:])


def jax_locate(locator, onsets, channels):
    """The demos' locate loop over JAX's ``Multilaterate3D``."""
    out = []
    for onset, ch in sorted(zip(onsets, channels)):
        res = locator.locate(int(ch), int(onset))
        if res is not None:
            out.append((int(onset), (float(res[0]), float(res[1]))))
    return out


def assert_points_match(port, ref):
    assert [o for o, _ in port] == [o for o, _ in ref]
    for (_, p), (_, r) in zip(port, ref):
        np.testing.assert_allclose(p, r, atol=POINT_TOL, rtol=0)


# -- e2e_locate --------------------------------------------------------------

@pytest.fixture(scope="module")
def e2e():
    return (load_example("e2e_locate_demo"),
            e2e_locate.run(E2E_HITS, sr=E2E_SR, device="cpu", log=quiet))


@pytest.mark.parametrize("hits,sr", [(8, 96000), (E2E_HITS, E2E_SR)])
def test_e2e_fixture_matches_the_demo(e2e, hits, sr):
    demo = e2e[0]
    audio, polar, truths, sr_, diam = e2e_locate.synth_drum(hits, sr)
    jaudio, jpolar, jtruths, jsr, jdiam = demo.synth_drum(hits, sr)
    np.testing.assert_array_equal(audio, jaudio)
    assert (polar, sr_, diam) == (jpolar, jsr, jdiam)
    assert_truths_match(truths, jtruths)


def test_e2e_events_groups_and_points_match_jax(e2e):
    demo, res = e2e
    ch, on, _ = demo.detect_onsets_amplitude(res["audio"], sr=E2E_SR,
                                             **e2e_locate.DETECT)
    assert [int(c) for c in res["channels"]] == [int(c) for c in ch]
    assert [int(o) for o in res["onsets"]] == [int(o) for o in on]
    assert len(on) == 3 * E2E_HITS
    groups = demo.find_onset_groups(on, ch, max_distance=200,
                                    min_channels=3)
    np.testing.assert_array_equal(res["groups"], groups)
    locator = demo.Multilaterate3D(
        sensor_locations=[(0.9, 0.0, 0.0), (0.9, 120.0, 0.0),
                          (0.9, 240.0, 0.0)],
        drum_diameter=e2e_locate.DIAMETER, medium="drumhead", sr=E2E_SR)
    assert_points_match(res["results"], jax_locate(locator, on, ch))


def test_e2e_gate_on_the_cpu(e2e):
    res = e2e[1]
    assert len(res["errs"]) >= 3 and e2e_locate.gate(res)
    assert not e2e_locate.gate(dict(res, errs=res["errs"] + 3.0))
    assert not e2e_locate.gate(dict(res, errs=res["errs"][:2]))


# -- fleet_detect ------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    """The demo, the twin's run and the plain calls it made, by kernel."""
    demo = load_example("fleet_detect_demo")
    _cuda.reset_counts()
    res = fleet_detect.run(FLEET_STREAMS, FLEET_SECONDS, device="cpu",
                           log=quiet)
    plain = {k.name: k.plain_calls for k in _cuda.KERNELS if k.plain_calls}
    return demo, dict(res, plain=plain)


@pytest.mark.parametrize("streams,seconds",
                         [(8, 1.0), (FLEET_STREAMS, FLEET_SECONDS)])
def test_fleet_fixture_matches_the_demo(fleet, streams, seconds):
    audio, polar, truths = fleet_detect.synth_fleet(streams, seconds)
    jaudio, jpolar, jtruths = fleet[0].synth_fleet(streams, seconds)
    np.testing.assert_array_equal(audio, jaudio)
    assert polar == jpolar and truths == jtruths


def test_fleet_events_and_points_match_jax_on_its_mesh(fleet):
    """JAX's sharded detector over a 2-device CPU mesh (the demo's mesh
    at 2 streams), then each stream through JAX's locator."""
    demo, res = fleet
    mesh = demo.make_mesh((FLEET_STREAMS,), ("data",))
    static, params, state = demo.detector_init(demo.DetectorConfig(
        n_channels=3, block_size=128, hipass_freq=0.0, sr=demo.SR))
    on, deltas, _ = demo.detect_offline_sharded(
        static, params, state, jnp.asarray(res["audio"]), mesh)
    np.testing.assert_array_equal(res["on"], np.asarray(on))
    np.testing.assert_array_equal(res["deltas"], np.asarray(deltas))
    assert res["on"].sum() == 3 * FLEET_STREAMS
    locator = demo.Multilaterate3D(
        [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)],
        drum_diameter=demo.DIAM, medium="drumhead", sr=demo.SR)
    for s in range(FLEET_STREAMS):
        ch, ons = demo.events_from_dense(np.asarray(on[s]),
                                         np.asarray(deltas[s]), 128)
        assert fleet_detect.events_from_dense(
            res["on"][s], res["deltas"][s], 128) == (list(ch), list(ons))
        locator.ongoing = []
        ref = jax_locate(locator, ons, ch)
        assert_points_match([(h[0], h[1:3]) for h in res["located"][s]],
                            ref)


def test_fleet_gate_sessions_and_route(fleet):
    res = fleet[1]
    assert fleet_detect.gate(res)
    assert res["sessions"] == FLEET_STREAMS
    assert res["matched"] == res["n_hits"] == FLEET_STREAMS
    # the streams folded into 6 channels of one per-channel detector: one
    # plain call of the pipe's plain version, nothing else
    assert res["plain"] == {"detector_pipe": 1}
    assert not fleet_detect.gate(dict(res, sessions=FLEET_STREAMS - 1))


# -- the anchored serving windows --------------------------------------------

@pytest.fixture(scope="module")
def session(tmp_path_factory):
    folder = tmp_path_factory.mktemp("swa")
    onsets, locs = jsynth(folder, n_hits=SWA_HITS, sr=swa.SR, seed=0)
    audio, _ = jread_wav(folder / "combined0.wav")
    return dict(demo=load_example("serving_window_accuracy"),
                audio=np.asarray(audio), onsets=np.asarray(onsets),
                locs=np.asarray(locs),
                fix=swa.make_fixture(SWA_HITS, device="cpu"))


def test_swa_session_split_and_block_windows_match_the_demo(session):
    demo, fix = session["demo"], session["fix"]
    np.testing.assert_array_equal(fix.audio, session["audio"])
    np.testing.assert_array_equal(fix.onsets, session["onsets"])
    np.testing.assert_array_equal(fix.locs, session["locs"])
    # the demo's split (serving_window_accuracy.py:163-170)
    rng = np.random.default_rng(1)
    held = rng.permutation(SWA_HITS)[: SWA_HITS // 4]
    half = len(held) // 2
    assert set(np.flatnonzero(fix.val_mask)) == set(held[:half])
    assert set(np.flatnonzero(fix.test_mask)) == set(held[half:])
    on, audio = fix.onsets, fix.audio
    np.testing.assert_array_equal(
        fix.x_serv, demo.serving_windows(audio, on[fix.test_mask]))
    np.testing.assert_array_equal(
        fix.val_b[0], demo.serving_windows(audio, on[fix.val_mask]))
    np.testing.assert_array_equal(fix.val_b[1], fix.locs[fix.val_mask])
    n_train = SWA_HITS - fix.val_mask.sum() - fix.test_mask.sum()
    for x, y in (fix.train_a, fix.train_b):
        assert x.shape == (4 * n_train, 4, swa.W) and y.shape == (
            4 * n_train, 2)


def exact_windows(audio, anchors, pre):
    rows = np.clip(anchors - pre, 0, audio.shape[0] - swa.W - 8)
    idx = rows[:, None] + np.arange(swa.W)
    return np.transpose(audio[idx], (0, 2, 1))


def test_swa_anchors_match_jax(session):
    """The detector's onsets and the anchors equal JAX's over the
    session's first SWA_CUT samples; the port's windows are exact slices
    at them, JAX's within its bf16 lane select of them."""
    demo = session["demo"]
    audio = np.ascontiguousarray(session["audio"][:SWA_CUT])
    hits = session["onsets"][session["onsets"] < SWA_CUT - 1024]
    got = swa.anchored_serving_windows(audio, hits, swa.PRE, device="cpu")
    jch, jon, _ = jdetect(audio, sr=swa.SR)
    np.testing.assert_array_equal(got["onsets"], np.sort(np.asarray(jon)))
    np.testing.assert_array_equal(got["detected"]["channels"],
                                  np.asarray(jch))
    np.testing.assert_array_equal(got["detected"]["onsets"], np.asarray(jon))
    anchors, missed = swa.anchors_from_onsets(np.asarray(jon), hits)
    np.testing.assert_array_equal(got["anchors"], anchors)
    assert got["missed"] == missed == 0 and len(hits) >= 2
    assert np.all(np.abs(anchors - hits) <= 64)
    want = exact_windows(audio, got["anchors"], swa.PRE)
    assert got["route"] is None
    np.testing.assert_array_equal(got["windows"].numpy(), want)
    jwins, jmissed = demo.anchored_serving_windows(audio, hits, swa.PRE)
    assert jmissed == missed
    np.testing.assert_allclose(np.asarray(jwins), want, rtol=2 ** -8,
                               atol=0)


def test_swa_anchor_fallback_counts_misses():
    anchors, missed = swa.anchors_from_onsets(
        np.array([5000, 1000, 1010]), np.array([1020, 3000, 5200]))
    np.testing.assert_array_equal(anchors, [1000, 3000, 5000])
    assert missed == 1


# -- every twin --------------------------------------------------------------

TWINS = ("serving_window_accuracy", "location_hpo", "fleet_detect",
         "e2e_locate", "calibration_run", "cc_bench")


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_examples(name):
    """Each twin keeps its own copy of its example's synthesizer."""
    import ast

    path = REPO / "onset_fingerprinting_torch" / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert mods and not [m for m in mods if m.split(".")[0] in (
        "jax", "flax", "optax", "onset_fingerprinting_tpu", "examples")]
    assert "def main(argv=None)" in path.read_text()


def test_cc_bench_cli_on_the_cpu(capsys):
    from onset_fingerprinting_torch.tools import cc_bench

    assert cc_bench.main(["--cpu", "--blocks", "200", "--pairs", "4"]) == 0
    assert "OK @ 0.001" in capsys.readouterr().out
