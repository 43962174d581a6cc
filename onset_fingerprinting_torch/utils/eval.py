"""Evaluation utilities: data QA, kNN diagnostics, membrane physics (a
copy of ``onset_fingerprinting_tpu.utils.eval``: numpy and scipy).

Re-designs of the reference's eval helpers (reference: utils.py:11-327).
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sig


def clipping_audio(x: np.ndarray, labels) -> set:
    """Indices of labelled examples whose audio clips at ±1 (utils.py:11-21).

    ``labels`` is a DataFrame with ``start``/``end`` sample columns.
    """
    import pandas as pd

    bad_idx = np.where((x == 1) | (x == -1))[0]
    intervals = pd.IntervalIndex.from_arrays(labels.start, labels.end)
    return set(intervals.get_indexer(bad_idx))


def knn_metrics(X_test, y_train, y_test, knn):
    """Per-class kNN distance / cumulative-accuracy curves (utils.py:24-51).

    For each class c with n_c test examples: distances to the n_c nearest
    training neighbors, and the cumulative fraction of those neighbors whose
    class is c.
    """
    classes = np.unique(y_test)
    res = {}
    for c in classes:
        idx = y_test == c
        n_c = int(idx.sum())
        dist, neigh = knn.kneighbors(X_test[idx], n_c)
        correct = np.cumsum(y_train[neigh] == c, axis=1) / (
            np.arange(n_c) + 1
        )
        res[c] = (dist, correct)
    return res


def plot_res(x, knn, labels, c):
    """Neighbor-distance vs cumulative-accuracy diagnostic for one example
    (utils.py:54-73): plots the distance of the n-th neighbor of ``x`` and
    the running fraction of neighbors whose training label equals ``c``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dist, neigh = knn.kneighbors(x, knn.n_samples_fit_)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot()
    ax.plot(dist[0], label="Distance of nth neighbor")
    ax2 = ax.twinx()
    ax2.plot(
        np.cumsum(labels[neigh[0]] == c) / (np.arange(knn.n_samples_fit_) + 1),
        color="orange",
        label="Correct classification (cumulative)",
    )
    fig.legend()
    return ax


def butter_highpass(cutoff: float, fs: int, order: int = 5):
    """High-pass Butterworth design (utils.py:274-278)."""
    return sig.butter(order, cutoff / (0.5 * fs), btype="high", analog=False)


def butter_highpass_filter(data, cutoff: float, fs: int, order: int = 5):
    """Zero-phase high-pass filtering (utils.py:281-284)."""
    b, a = butter_highpass(cutoff, fs, order=order)
    return sig.filtfilt(b, a, data)


def wave_speed(T0: float, rho0: float) -> float:
    """Membrane wave speed sqrt(T/ρ) in m/s (utils.py:287-299; Fletcher &
    Rossing, The Physics of Musical Instruments)."""
    return float(np.sqrt(T0 / rho0))


def drum_frequency(
    diameter_m: float, T0: float, rho0: float, m: int, n: int
) -> float:
    """Modal frequency of a circular membrane (utils.py:302-327)."""
    v = wave_speed(T0, rho0)
    k = np.sqrt(m**2 + n**2) * np.pi / diameter_m
    return float(v * k / (2 * np.pi))
