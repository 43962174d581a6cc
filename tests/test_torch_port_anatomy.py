"""The fingerprint-stage anatomy tool (port of
``examples/fingerprint_anatomy.py``) on the CPU at 32 streams: every row is
timed, the pair head's predictions are finite, and the built-in check that
the roll gather (K4) equals the block-aligned gather (K2) holds — and
fires when it does not."""

import math

import pytest
import torch

from onset_fingerprinting_torch.tools import fingerprint_anatomy as fa

# a chunk of 20480 samples holds 2 grid hits per stream (the grid starts at
# sample 5000): 64 hits in 128 slots
SMALL = dict(device="cpu", n_streams=32, chunk=20480, capacity=128, iters=1)


def test_anatomy_runs_every_row_on_cpu():
    outputs = {}
    rows = fa.main(**SMALL, outputs=outputs)
    assert tuple(rows) == fa.ROWS
    assert all(math.isfinite(ms) and ms >= 0 for ms in rows.values())
    for name in ("preds", "preds_pairs"):
        assert outputs[name].shape == (128, 2)
        assert bool(torch.isfinite(outputs[name]).all())


def test_anatomy_cross_check_fires(monkeypatch):
    real = fa.gather_windows_roll

    def off_by_one_stream(x, row_start, stream_ids, cps, window):
        return real(x, row_start, stream_ids + 1, cps, window)

    monkeypatch.setattr(fa, "gather_windows_roll", off_by_one_stream)
    with pytest.raises(RuntimeError, match="block-aligned"):
        fa.main(**SMALL)
