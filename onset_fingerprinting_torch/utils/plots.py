"""Plotting library: onset/CC/lag-map debugging and evaluation views (port
of ``onset_fingerprinting_tpu.utils.plots``).

Re-designs of the reference's plot library and eval plots (reference:
plots.py:36-593; utils.py:54-270) — the project's de-facto observability
layer.  All matplotlib; figures are returned so callers can log them (e.g.
TensorBoard ``add_figure``).  The polar view converts through the port's
``core.coords`` in float32, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

import torch

from onset_fingerprinting_torch.core.coords import polar_to_cartesian


def _drum_circle(ax, radius: float, **kwargs):
    theta = np.linspace(0, 2 * np.pi, 256)
    ax.plot(radius * np.cos(theta), radius * np.sin(theta),
            color=kwargs.pop("color", "k"), lw=1, **kwargs)
    ax.set_aspect("equal")


def plot_group(
    audio: np.ndarray, group: np.ndarray, lookaround: int = 60, ax=None
):
    """Per-channel waveforms around one onset group with onset markers
    (plots.py:36-70)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    valid = group >= 0
    a = group[valid].min() - lookaround
    b = group[valid].max() + lookaround
    seg = audio[max(a, 0) : b]
    for ch in range(audio.shape[1]):
        ax.plot(np.arange(max(a, 0), b), seg[:, ch], label=f"ch {ch}",
                alpha=0.7)
        if group[ch] >= 0:
            ax.axvline(group[ch], color=f"C{ch}", ls="--")
    ax.legend()
    return ax


def get_color_from_cmap(
    cmap_name: str, min_val: float, max_val: float, value: float
) -> tuple:
    """RGBA color for ``value`` normalized into [min_val, max_val] on the
    named colormap (reference plots.py:11-33)."""
    cmap = plt.get_cmap(cmap_name)
    return cmap((value - min_val) / (max_val - min_val))


def plot_cc(
    cc: np.ndarray,
    n: int,
    lag_center: int,
    onset_tolerance: int,
    n_peaks: int = 0,
    ax=None,
):
    """Plot an already-computed windowed cross-correlation on its true lag
    axis, as produced by the locator's CC refinement (reference
    plots.py:73-97): ``cc`` is the slice of the full ``2n``-lag CC covering
    ``lag_center ± onset_tolerance``.  Optionally marks the top ``n_peaks``
    peaks colored by height."""
    from scipy.signal import find_peaks

    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
        fig.suptitle(
            "Cross-correlation"
            + (f" with top {n_peaks} peaks" if n_peaks > 0 else "")
        )
    cc = np.asarray(cc)
    lags = np.arange(-n, n)
    lags = lags[lag_center - onset_tolerance : lag_center + onset_tolerance]
    lags = lags[: len(cc)]
    ax.plot(lags, cc[: len(lags)])
    ax.set_xlabel("Lag")
    ax.set_ylabel("Correlation")
    if n_peaks > 0:
        peaks, _ = find_peaks(cc)
        if len(peaks):
            peak_values = cc[peaks]
            pmin, pmax = peak_values.min(), peak_values.max()
            picks = peak_values.argsort()[-n_peaks:]
            peaks, peak_values = peaks[picks], peak_values[picks]
            colors = [
                get_color_from_cmap("Reds", pmin, max(pmax, pmin + 1e-12), p)
                for p in peak_values
            ]
            ax.vlines(lags[peaks], cc.min(), cc.max(), colors=colors)
    return ax


def plot_cc_signals(a: np.ndarray, b: np.ndarray, top_n: int = 3, ax=None):
    """Convenience: compute the full CC of two raw signals and plot it with
    its top-n peaks marked."""
    from scipy.signal import find_peaks

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    cc = np.correlate(a, b, "full")
    lags = np.arange(-len(a) + 1, len(a))
    ax.plot(lags, cc)
    peaks, _ = find_peaks(cc)
    peaks = peaks[np.argsort(-cc[peaks])][:top_n]
    ax.plot(lags[peaks], cc[peaks], "rx")
    ax.set_xlabel("lag [samples]")
    return ax


def plot_3d_scene(
    sensor_positions: np.ndarray,
    sound_positions: Optional[np.ndarray] = None,
    radius: float = 17.78,
    ax=None,
):
    """Drum surface + sensors (+hits) in 3D (plots.py:100-175)."""
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    theta = np.linspace(0, 2 * np.pi, 128)
    ax.plot(radius * np.cos(theta), radius * np.sin(theta), 0, color="k")
    sp = np.asarray(sensor_positions)
    ax.scatter(sp[:, 0], sp[:, 1], sp[:, 2], marker="^", s=60, label="sensors")
    if sound_positions is not None:
        hp = np.asarray(sound_positions)
        ax.scatter(hp[:, 0], hp[:, 1], np.zeros(len(hp)), marker="o",
                   alpha=0.5, label="hits")
    ax.legend()
    return ax


def cartesian_circle(
    points: np.ndarray, radius: float = 1.0, labels=None, ax=None
):
    """Predictions scattered on the drum outline (plots.py:178-225); used by
    model test steps (model.py:141)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    _drum_circle(ax, radius)
    pts = np.asarray(points)
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=labels, s=12, alpha=0.7)
    if labels is not None:
        plt.colorbar(sc, ax=ax)
    return ax


def polar_circle(r: np.ndarray, phi: np.ndarray, radius: float = 1.0, ax=None):
    """Polar-coordinate predictions on the drum outline (plots.py:228-276)."""
    x, y = polar_to_cartesian(
        torch.as_tensor(np.asarray(r) * radius, dtype=torch.float32),
        np.asarray(phi))
    return cartesian_circle(torch.stack([x, y], dim=1).numpy(), radius,
                            ax=ax)


def error_heatmap(
    true_xy: np.ndarray,
    pred_xy: np.ndarray,
    radius: float = 1.0,
    grid: int = 12,
    outlier_factor: float = 3.0,
    ax=None,
):
    """Mean localization error binned over drum-surface grid cells, with
    outlier corner marks (plots.py:279-356)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    true_xy = np.asarray(true_xy)
    err = np.linalg.norm(np.asarray(pred_xy) - true_xy, axis=1)
    edges = np.linspace(-radius, radius, grid + 1)
    mean_err = np.full((grid, grid), np.nan)
    outliers = np.zeros((grid, grid), bool)
    med = np.median(err) if len(err) else 0.0
    ix = np.clip(np.digitize(true_xy[:, 0], edges) - 1, 0, grid - 1)
    iy = np.clip(np.digitize(true_xy[:, 1], edges) - 1, 0, grid - 1)
    for gx in range(grid):
        for gy in range(grid):
            sel = (ix == gx) & (iy == gy)
            if sel.any():
                mean_err[gy, gx] = err[sel].mean()
                outliers[gy, gx] = (err[sel] > outlier_factor * med).any()
    im = ax.imshow(
        mean_err, origin="lower", extent=(-radius, radius, -radius, radius),
        cmap="viridis",
    )
    plt.colorbar(im, ax=ax, label="mean error")
    oy, ox = np.nonzero(outliers)
    cell = 2 * radius / grid
    ax.plot(
        edges[ox] + 0.15 * cell, edges[oy] + 0.15 * cell, "r^", ms=4,
        label="outliers",
    )
    _drum_circle(ax, radius, color="w")
    return ax


def is_legal_3d_plot(locator, group, tolerance: float = 1.0, ax=None):
    """Visualize the joint lag-map legality region for a candidate group —
    the locator debugging view (plots.py:359-390)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    tol = tolerance * locator.samples_per_cm
    sensors, onsets = group[0], group[1]
    lm1 = locator.lag_maps[sensors[0]][sensors[1]]
    lm2 = locator.lag_maps[sensors[0]][sensors[2]]
    lag1 = onsets[1] - onsets[0]
    lag2 = onsets[2] - onsets[0]
    with np.errstate(invalid="ignore"):
        legal = (
            (lm1 < lag1 + tol)
            & (lm1 > lag1 - tol)
            & (lm2 < lag2 + tol)
            & (lm2 > lag2 - tol)
        )
    ax.imshow(legal, origin="lower", cmap="Reds")
    ax.set_title(f"legal cells for lags ({lag1}, {lag2})")
    return ax


def plot_onsets(
    audio: np.ndarray, onsets: Sequence[int], channels: Sequence[int],
    sr: int = 96000, ax=None,
):
    """Waveforms with detected-onset markers (plots.py:393-424)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    n_ch = audio.shape[1] if audio.ndim == 2 else 1
    t = np.arange(len(audio)) / sr
    for ch in range(n_ch):
        y = audio[:, ch] if audio.ndim == 2 else audio
        ax.plot(t, y + 2 * ch, lw=0.5, color=f"C{ch}")
    for o, c in zip(onsets, channels):
        ax.axvline(o / sr, color=f"C{c}", ls=":", alpha=0.7)
    return ax


def plot_around(
    audio: np.ndarray, index: int, pre: int = 256, post: int = 256, ax=None
):
    """Zoomed view around one sample index (plots.py:427-456)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    lo, hi = max(index - pre, 0), min(index + post, len(audio))
    ax.plot(np.arange(lo, hi), audio[lo:hi])
    ax.axvline(index, color="r", ls="--")
    return ax


def plot_heatmap(m: np.ndarray, ax=None, **imshow_kwargs):
    """Generic annotated heatmap (plots.py:563-593)."""
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(m, origin="lower", **imshow_kwargs)
    plt.colorbar(im, ax=ax)
    return ax


def plot_lags_2d(lag_map: np.ndarray, ax=None):
    """Contour view of one pairwise lag map (plots.py:459-510)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(lag_map, origin="lower", cmap="coolwarm")
    cs = ax.contour(lag_map, colors="k", linewidths=0.5)
    ax.clabel(cs, inline=True, fontsize=7)
    plt.colorbar(im, ax=ax, label="lag [samples]")
    return ax


def plot_lags_3d(lag_maps: dict, ax=None):
    """Grid of pairwise lag maps for all sensor pairs (plots.py:513-560)."""
    pairs = [
        (i, j) for i, d in enumerate(lag_maps) for j in d
    ]
    n = len(pairs)
    cols = min(n, 3)
    rows = -(-n // cols)
    fig, axs = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                            squeeze=False)
    for ax_, (i, j) in zip(axs.flat, pairs):
        im = ax_.imshow(lag_maps[i][j], origin="lower", cmap="coolwarm")
        ax_.set_title(f"{i} → {j}")
        fig.colorbar(im, ax=ax_)
    return fig


# -- model comparison views (utils.py:126-270) -------------------------------

def compare_model_confusion(test_labels, pred_labels: list, psize: int = 4):
    """Side-by-side confusion matrices for several models
    (utils.py:126-137)."""
    from sklearn.metrics import ConfusionMatrixDisplay

    n = len(pred_labels)
    fig, axs = plt.subplots(1, n, figsize=(n * psize, psize), squeeze=False)
    labels = sorted(set(test_labels) | set().union(*map(set, pred_labels)))
    for pred, ax in zip(pred_labels, axs[0]):
        ConfusionMatrixDisplay.from_predictions(
            test_labels, pred, labels=labels, ax=ax,
            xticks_rotation="vertical",
        )
    fig.tight_layout()
    return fig


def plot_disagreements(test_labels, predicted_labels_list):
    """Lexsorted heatmap of model disagreements on misclassified examples
    (utils.py:140-196)."""
    import seaborn as sns
    from matplotlib.colors import ListedColormap

    n_models = len(predicted_labels_list)
    labels = sorted(
        set(test_labels) | set().union(*map(set, predicted_labels_list))
    )
    ld = {l: i for i, l in enumerate(labels)}
    arr = np.empty((n_models + 1, len(test_labels)))
    arr[0] = np.vectorize(ld.get)(test_labels)
    misclf = np.zeros(len(test_labels), bool)
    for i, preds in enumerate(predicted_labels_list):
        misclf |= np.asarray(preds) != np.asarray(test_labels)
        arr[i + 1] = np.vectorize(ld.get)(preds)
    order = np.lexsort(arr[::-1])
    arr = arr[:, order]
    misclf = misclf[order]
    cmap = ListedColormap(sns.color_palette(n_colors=len(labels)))
    fig = plt.figure(figsize=(10, n_models))
    plt.imshow(arr[:, misclf], aspect="auto", cmap=cmap)
    plt.yticks(
        np.arange(n_models + 1),
        ["True"] + [f"Model {i + 1}" for i in range(n_models)],
    )
    plt.xticks([])
    handles = [
        plt.Rectangle((0, 0), 1, 1, color=cmap.colors[i])
        for i in range(len(labels))
    ]
    fig.legend(handles, labels, ncols=len(labels), fontsize="small",
               loc="upper center", bbox_to_anchor=(0.44, 0.1))
    fig.tight_layout()
    return fig


def plot_misclf(true_labels, pred_labels: list, psize: float = 1.2,
                model_names=None, normalize: bool = False):
    """Per-(true, pred) cell bar chart of misclassification counts across
    models (utils.py:199-270)."""
    import pandas as pd
    import seaborn as sns
    from sklearn.metrics import confusion_matrix

    n = len(pred_labels)
    model_names = model_names or [str(i) for i in range(n)]
    labels = sorted(set(true_labels) | set().union(*map(set, pred_labels)))
    cms = np.stack(
        [confusion_matrix(true_labels, p, labels=labels) for p in pred_labels]
    )
    rows = []
    for m in range(n):
        for i, t in enumerate(labels):
            for j, p in enumerate(labels):
                if i != j and cms[m, i, j]:
                    rows.append((t, p, m, cms[m, i, j]))
    df = pd.DataFrame(rows, columns=["true", "pred", "model", "count"])
    if normalize and len(df):
        df["count"] /= df.groupby("model")["count"].transform("sum")
    trues = df["true"].unique()
    preds = df["pred"].unique()
    fig, axs = plt.subplots(
        max(len(preds), 1), max(len(trues), 1),
        figsize=(max(len(trues), 1) * psize, max(len(preds), 1) * psize),
        sharex=True, sharey=True, squeeze=False,
    )
    cp = np.array(sns.color_palette(n_colors=n))
    for i, p in enumerate(preds):
        for j, t in enumerate(trues):
            sel = df[(df.true == t) & (df.pred == p)]
            ax = axs[i][j]
            if len(sel):
                ax.bar(sel["model"], sel["count"], 1,
                       color=cp[sel["model"].to_numpy()])
            if i == len(preds) - 1:
                ax.set_xlabel(t)
            if j == 0:
                ax.set_ylabel(p)
            ax.set_xticks([])
    handles = [plt.Rectangle((0, 0), 1, 1, color=cp[i]) for i in range(n)]
    fig.legend(handles, model_names, title="Model")
    return fig


def plot_knn_metrics(results: dict, labels=None, plot_size: int = 3):
    """Distance vs cumulative-accuracy per class (utils.py:76-123)."""
    labels = labels or list(results.keys())
    n = len(labels)
    fig, axs = plt.subplots(1, n, sharey=True,
                            figsize=(plot_size * n, plot_size), squeeze=False)
    for (c, label, ax) in zip(results, labels, axs[0]):
        dist, correct = results[c]
        ax.plot(dist.mean(axis=0), label="distance")
        ax2 = ax.twinx()
        ax2.plot(correct.mean(axis=0), color="orange", label="cum. accuracy")
        ax2.set_ylim(0, 1)
        ax.set_title(f"Class {label}")
    fig.tight_layout()
    return fig
