"""Onset-group clustering across channels (a copy of
``onset_fingerprinting_tpu.detect.grouping``, which is numpy).

Equivalent of the reference's ``find_onset_groups`` (reference:
detection.py:131-189): greedily clusters a time-ordered (onset, channel)
event stream into per-hit groups -- a group collects every onset within
``max_distance`` samples of its seed, survives if it spans at least
``min_channels`` distinct channels, and is emitted as a dense row with -1
sentinels for channels that did not fire.

Events are sparse (a few per hit), so this stays a host-side pass; the dense
detector outputs it consumes come straight off the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def find_onset_groups(
    onsets: list[int],
    channels: list[int],
    max_distance: int = 1000,
    min_channels: int = 3,
    close_channel: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Cluster onset events into per-hit groups.

    :param onsets: onset sample indices (time-ordered event stream)
    :param channels: channel index per onset
    :param max_distance: max distance in samples from a group's seed onset
    :param min_channels: minimum distinct channels for a group to be kept
    :param close_channel: if given, drop groups whose earliest onset is not
        on this channel
    :returns: ``[n_groups, max_channel + 1]`` int array with -1 sentinels, or
        None if no group qualifies
    """
    if len(onsets) == 0:
        return None
    max_channel = max(channels)
    width = max_channel + 1

    groups: list[np.ndarray] = []
    current: list[tuple[int, int]] = []

    def flush():
        if len({ch for _, ch in current}) >= min_channels:
            row = np.full((width,), -1, dtype=int)
            for s, ch in current:
                row[ch] = s
            groups.append(row)

    for sample, channel in zip(onsets, channels):
        if current and abs(sample - current[0][0]) > max_distance:
            flush()
            current = []
        current.append((int(sample), int(channel)))
    if current:
        flush()

    if close_channel is not None:
        groups = [g for g in groups if all(g[close_channel] <= g)]
    return np.array(groups, dtype=int) if groups else None
