"""Hit lists, event lists and window cuts, written plainly in NumPy."""

from __future__ import annotations

import numpy as np


def stream_hit_starts(on: np.ndarray, deltas: np.ndarray, block: int,
                      capacity: int) -> list[int]:
    """One stream's hit list from its per-block events ``on, deltas [nb,
    cps]``: every block in which any channel fired is a hit, in time order,
    at most ``capacity``; a hit starts at its block's first sample plus
    the earliest firing channel's offset."""
    out = []
    for k in range(on.shape[0]):
        if on[k].any():
            out.append(k * block + int(deltas[k][on[k]].min()))
            if len(out) == capacity:
                break
    return out


def anchored_window(x: np.ndarray, start: int, window: int, pre: int
                    ) -> np.ndarray:
    """``[cps, window]`` of one stream's audio ``x [T, cps]`` with the
    onset ``pre`` samples in, the read kept 8 samples inside the chunk's
    end (the fleet path's anchored rule)."""
    row = min(max(start - pre, 0), x.shape[0] - window - 8)
    return np.ascontiguousarray(x[row:row + window].T)


def stream_events(on: np.ndarray, deltas: np.ndarray, block: int,
                  capacity: int) -> tuple[list[int], list[int]]:
    """One stream's first ``capacity`` onset events ``(onsets, channels)``
    in onset order, equal onsets in block then channel order."""
    ev = [(k * block + int(deltas[k, c]), k, c)
          for k in range(on.shape[0]) for c in range(on.shape[1])
          if on[k, c]]
    ev.sort()
    ev = ev[:capacity]
    return [e[0] for e in ev], [e[2] for e in ev]


def event_window(x: np.ndarray, onset: int, window: int, pre: int
                 ) -> np.ndarray:
    """``[C, window]`` of one stream's audio ``x [T, C]`` around an event
    (the serve path's rule: clipped to the recording)."""
    row = min(max(onset - pre, 0), x.shape[0] - window)
    return np.ascontiguousarray(x[row:row + window].T)
