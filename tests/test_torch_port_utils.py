"""The port's ``utils`` (metrics and tracing, eval, plots) against the JAX
package's, on the CPU: the same calls on the same seeded inputs give the
same summaries, JSONL lines, numbers and figure data (lines, images,
scatter offsets, bar geometry and labels; not pixels).  pyplot's state is
global, so each package's figures are read and closed before the other's
are drawn."""

import json
import sys
import time

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest
import torch

from onset_fingerprinting_tpu.locate import Multilaterate3D as JMultilaterate3D
from onset_fingerprinting_tpu.utils import eval as jeval
from onset_fingerprinting_tpu.utils import metrics as jmetrics
from onset_fingerprinting_tpu.utils import plots as jplots
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.utils import eval as peval
from onset_fingerprinting_torch.utils import metrics as pmetrics
from onset_fingerprinting_torch.utils import plots as pplots

SENSORS = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]


# -- metrics -------------------------------------------------------------------

def _drive(m):
    m.count("detections", 5)
    m.count("detections")
    m.count("hits", 2.5)
    for v in (0.2, 1.7, 0.9, 3.1, 0.05):
        m.observe("step", v)
    for v in (0.5, 1.5, 1.2, 0.1):
        m.observe_deadline("block", v, 1.0)
    return m


def test_metrics_summary_equals_jax():
    p, j = _drive(pmetrics.Metrics()), _drive(jmetrics.Metrics())
    assert p.summary() == j.summary()
    assert p.misses("block") == j.misses("block") == 2
    assert p.misses("step") == j.misses("step") == 0
    # the latency lines of the report (the counter lines carry a rate per
    # wall-clock second since creation)
    lat = [ln for ln in p.report().splitlines() if "p50" in ln]
    assert lat == [ln for ln in j.report().splitlines() if "p50" in ln]
    assert p.rate("detections") > 0


def test_trace_observes_into_metrics():
    m = pmetrics.Metrics()
    with pmetrics.trace("detect", m):
        time.sleep(0.002)
    with pmetrics.trace("detect", m):
        pass
    with pmetrics.trace("untimed"):
        pass
    s = m.summary()["latency"]
    assert s["detect"]["count"] == 2 and s["detect"]["max_ms"] >= 1.0
    assert "untimed" not in s


def test_profile_trace_cpu_names_the_span(tmp_path):
    m = pmetrics.Metrics()
    with pmetrics.profile_trace(tmp_path / "tr", device="cpu"):
        with pmetrics.trace("port.span", m):
            torch.ones(8).add_(1)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "port.span"]
    # an op-scope range: a user annotation would be copied onto the card's
    # timeline as if it were device work
    assert spans and spans[0]["cat"] == "cpu_op"
    assert m.summary()["latency"]["port.span"]["count"] == 1


def test_tb_writer_jsonl_equals_jax(tmp_path, monkeypatch):
    """Without tensorboard both writers fall back to the same JSONL."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for mod, d in ((pmetrics, "p"), (jmetrics, "j")):
        w = mod.TBWriter(tmp_path / d)
        assert w._tb is None
        for step, v in enumerate((0.5, 0.25, np.float32(0.125))):
            w.add_scalar("loss", v, step)
        w.add_figure("fig", None, 0)
        w.close()
    text = (tmp_path / "p" / "events.jsonl").read_text()
    assert text == (tmp_path / "j" / "events.jsonl").read_text()
    assert [json.loads(ln)["value"] for ln in text.splitlines()] == [
        0.5, 0.25, 0.125]


def test_tb_writer_summary_writer(tmp_path):
    pytest.importorskip("tensorboard")
    w = pmetrics.TBWriter(tmp_path / "tb")
    assert w._tb is not None
    w.add_scalar("loss", 0.5, 0)
    w.close()
    assert any((tmp_path / "tb").iterdir())


# -- eval ----------------------------------------------------------------------

def test_butter_bit_for_bit(rng):
    for cutoff, fs, order in ((2000.0, 96000, 5), (150.0, 48000, 3)):
        pb, pa = peval.butter_highpass(cutoff, fs, order)
        jb, ja = jeval.butter_highpass(cutoff, fs, order)
        assert np.array_equal(pb, jb) and np.array_equal(pa, ja)
        x = rng.normal(size=(2, 4000))
        assert np.array_equal(peval.butter_highpass_filter(x, cutoff, fs,
                                                           order),
                              jeval.butter_highpass_filter(x, cutoff, fs,
                                                           order))


def test_membrane_physics_equal():
    assert peval.wave_speed(351.0, 0.05) == jeval.wave_speed(351.0, 0.05)
    for m, n in ((0, 1), (1, 1), (2, 3)):
        assert (peval.drum_frequency(0.32, 351.0, 0.05, m, n)
                == jeval.drum_frequency(0.32, 351.0, 0.05, m, n))


def test_clipping_audio_equal(rng):
    x = rng.uniform(-0.9, 0.9, 1000)
    x[[40, 333, 334, 910]] = [1.0, -1.0, 1.0, -1.0]
    labels = pd.DataFrame({"start": [0, 300, 600, 900],
                           "end": [100, 400, 700, 1000]})
    got = peval.clipping_audio(x, labels)
    assert got == jeval.clipping_audio(x, labels) == {0, 1, 3}


def _knn(rng):
    neighbors = pytest.importorskip("sklearn.neighbors")
    x = np.concatenate([rng.normal(0, 1, (20, 4)),
                        rng.normal(3, 1, (20, 4))])
    y = np.array([0] * 20 + [1] * 20)
    return x, y, neighbors.KNeighborsClassifier(3).fit(x, y)


def test_knn_metrics_equal(rng):
    x, y, knn = _knn(rng)
    got, want = (peval.knn_metrics(x, y, y, knn),
                 jeval.knn_metrics(x, y, y, knn))
    assert set(got) == set(want) == {0, 1}
    for c in want:
        for a, b in zip(got[c], want[c]):
            assert np.array_equal(a, b)


# -- figure data -----------------------------------------------------------------

def _color(c):
    return np.asarray(matplotlib.colors.to_rgba_array(c), np.float64)


def _artist_data(a):
    kind = type(a).__name__
    if hasattr(a, "get_data_3d"):
        return kind, [np.asarray(v, np.float64) for v in a.get_data_3d()]
    if isinstance(a, matplotlib.lines.Line2D):
        return kind, [np.asarray(a.get_xydata(), np.float64),
                      _color(a.get_color()), a.get_linestyle(),
                      a.get_marker()]
    if isinstance(a, matplotlib.image.AxesImage):
        return kind, [np.ma.filled(np.ma.asarray(a.get_array(), np.float64),
                                   np.nan), np.asarray(a.get_extent())]
    if hasattr(a, "_offsets3d"):
        return kind, [np.asarray(v, np.float64) for v in a._offsets3d]
    if isinstance(a, matplotlib.collections.Collection):
        arr = a.get_array()
        return kind, [np.asarray(a.get_offsets(), np.float64),
                      None if arr is None else np.ma.filled(
                          np.ma.asarray(arr, np.float64), np.nan),
                      [np.asarray(p.vertices, np.float64)
                       for p in a.get_paths()][:64]]
    if isinstance(a, matplotlib.patches.Rectangle):
        return kind, [np.array([a.get_x(), a.get_y(), a.get_width(),
                                a.get_height()]), _color(a.get_facecolor())]
    if isinstance(a, matplotlib.text.Text):
        return kind, [a.get_text()]
    return kind, []


def fig_data(fig):
    """Per axes: its title and labels, limits, and the data of its lines,
    images, collections, patches and texts."""
    out = []
    for ax in fig.axes:
        arts = [*ax.lines, *ax.images, *ax.collections, *ax.patches,
                *ax.texts]
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    np.asarray(ax.get_xlim()), np.asarray(ax.get_ylim()),
                    [_artist_data(a) for a in arts]))
    out.append([t.get_text() for lg in fig.legends for t in lg.get_texts()])
    return out


def assert_same(a, b):
    """Equal nested figure data, arrays exactly (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for u, v in zip(a, b):
            assert_same(u, v)
    else:
        assert a == b


def _result_fig(r):
    return r if isinstance(r, matplotlib.figure.Figure) else r.figure


def _locator(jax):
    cls = JMultilaterate3D if jax else Multilaterate3D
    return cls(SENSORS, medium="drumhead", sr=96000)


def _inputs(rng):
    audio = rng.normal(size=(2000, 3)).astype(np.float32)
    true = rng.uniform(-1, 1, (50, 2))
    labels = rng.integers(0, 3, 60)
    preds = [np.where(rng.random(60) < 0.8, labels, (labels + 1) % 3)
             for _ in range(2)]
    lm = rng.normal(size=(20, 20)).astype(np.float32)
    return dict(
        audio=audio, true=true, pred=true + rng.normal(0, 0.1, (50, 2)),
        labels=labels, preds=preds, lm=lm, pts=rng.normal(size=(20, 2)),
        r=rng.random(10), phi=rng.random(10) * 360,
        cc=np.correlate(audio[:256, 0], audio[:256, 1], "full")[196:316],
        knn_res={c: (rng.random((5, 5)), rng.random((5, 5)))
                 for c in (0, 1)},
        heat=rng.normal(size=(8, 8)), sensors=rng.normal(size=(3, 3)),
        sounds=rng.normal(size=(5, 3)))


#: each plots function called as tests/test_tools_utils.py calls it (the
#: legality view at lags that a cell of the lag maps has); ``j`` says which
#: package's locator it takes
CASES = {
    "plot_group": lambda P, d, j: P.plot_group(
        d["audio"], np.array([500, 520, -1])),
    "plot_cc": lambda P, d, j: P.plot_cc(d["cc"], 256, 256, 60, n_peaks=3),
    "plot_cc_signals": lambda P, d, j: P.plot_cc_signals(
        d["audio"][:256, 0], d["audio"][:256, 1]),
    "plot_3d_scene": lambda P, d, j: P.plot_3d_scene(d["sensors"],
                                                     d["sounds"]),
    "cartesian_circle": lambda P, d, j: P.cartesian_circle(
        d["pts"], radius=2.0, labels=d["labels"][:20]),
    "polar_circle": lambda P, d, j: P.polar_circle(d["r"], d["phi"],
                                                   radius=1.5),
    "error_heatmap": lambda P, d, j: P.error_heatmap(
        d["true"], d["pred"], radius=1.0, grid=4),
    "is_legal_3d_plot": lambda P, d, j: P.is_legal_3d_plot(
        _locator(j), ([0, 1, 2], [1000, 1094, 1094])),
    "plot_onsets": lambda P, d, j: P.plot_onsets(d["audio"], [100, 900],
                                                 [0, 2]),
    "plot_around": lambda P, d, j: P.plot_around(d["audio"][:, 0], 1000),
    "plot_heatmap": lambda P, d, j: P.plot_heatmap(d["heat"]),
    "plot_lags_2d": lambda P, d, j: P.plot_lags_2d(d["lm"]),
    "plot_lags_3d": lambda P, d, j: P.plot_lags_3d(
        [{1: d["lm"]}, {0: d["lm"].T}]),
    "compare_model_confusion": lambda P, d, j: P.compare_model_confusion(
        d["labels"], d["preds"]),
    "plot_disagreements": lambda P, d, j: P.plot_disagreements(
        d["labels"], d["preds"]),
    "plot_misclf": lambda P, d, j: P.plot_misclf(d["labels"], d["preds"]),
    "plot_knn_metrics": lambda P, d, j: P.plot_knn_metrics(d["knn_res"]),
}
#: the cases' imports beyond matplotlib
NEEDS = {"compare_model_confusion": ("sklearn",),
         "plot_disagreements": ("seaborn",),
         "plot_misclf": ("sklearn", "seaborn")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plots_figure_data_equal(name):
    for mod in NEEDS.get(name, ()):
        pytest.importorskip(mod)
    fn = CASES[name]
    data = []
    for pkg, is_jax in ((pplots, False), (jplots, True)):
        plt.close("all")
        d = _inputs(np.random.default_rng(7))
        data.append(fig_data(_result_fig(fn(pkg, d, is_jax))))
        plt.close("all")
    assert_same(data[0], data[1])
    assert any(ax[5] for ax in data[0][:-1]), "the figure drew nothing"


def test_color_from_cmap_and_drum_circle_equal():
    for v in (0.0, 0.3, 1.0, 1.7):
        assert (pplots.get_color_from_cmap("Reds", 0.0, 2.0, v)
                == jplots.get_color_from_cmap("Reds", 0.0, 2.0, v))
    data = []
    for pkg in (pplots, jplots):
        fig, ax = plt.subplots()
        pkg._drum_circle(ax, 3.0, color="b")
        data.append(fig_data(fig))
        plt.close("all")
    assert_same(data[0], data[1])


def test_plot_res_equal(rng):
    x, y, knn = _knn(rng)
    data = []
    for mod in (peval, jeval):
        ax = mod.plot_res(x[:1], knn, y, 0)
        data.append(fig_data(ax.figure))
        plt.close("all")
    assert_same(data[0], data[1])
