"""Ring buffers (port of ``onset_fingerprinting_tpu.core.ring_buffer``).

- :class:`RingBuffer`: a fixed ring of frames on the device plus a write
  counter (a 0-d int32 tensor).  :func:`ring_write` writes the ring IN
  PLACE and returns a ring with the same storage and the new counter,
  where the JAX function returns a new array: the realtime engine keeps a
  16 s ring on the card and captures its step in a CUDA graph, so the
  ring must stay at one address and must not be copied per block.  Reads
  (:func:`ring_read_last`, :func:`ring_slice`) gather, with no host read.
- :class:`CircularArray`: the host (numpy) ring with the same relative
  indexing, copied.

Indexing convention (both): index ``-k`` is the ``k``-th most recently
written frame; slices are relative to ``counter``, the number of frames
ever written, as loopmate's ``query_circular``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RingBuffer(NamedTuple):
    """``data [N, ...]`` (axis 0 is the ring axis) and ``counter``, a 0-d
    int32 tensor: the frames written since creation."""

    data: torch.Tensor
    counter: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def ring_init(capacity: int, shape: tuple = (), dtype=torch.float32,
              device=None) -> RingBuffer:
    """An empty ring of ``capacity`` frames of ``shape``, zero-filled."""
    return RingBuffer(
        torch.zeros((capacity,) + tuple(shape), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def _positions(rb: RingBuffer, start, n: int) -> torch.Tensor:
    """Ring indices of the ``n`` frames from relative ``start`` (counted
    from the write head), as int64 on the ring's device."""
    steps = torch.arange(n, dtype=torch.int32, device=rb.data.device)
    return torch.remainder(rb.counter + start + steps, rb.capacity).long()


def ring_write(rb: RingBuffer, block: torch.Tensor) -> RingBuffer:
    """Write a ``[B, ...]`` block of frames at the head, wrapping around
    (circular_array.h:52-69 of the reference), in place.  Frame t goes to
    ``(counter mod N + t) mod N``, as the JAX function places it: the head
    is taken modulo the ring before the frame index is added, so a counter
    that passes the largest int32 does not move the slots."""
    steps = torch.arange(block.shape[0], dtype=torch.int32,
                         device=rb.data.device)
    idx = torch.remainder(torch.remainder(rb.counter, rb.capacity) + steps,
                          rb.capacity).long()
    rb.data.index_copy_(0, idx, block.to(rb.data.dtype))
    return RingBuffer(rb.data, rb.counter + block.shape[0])


def ring_read_last(rb: RingBuffer, n: int) -> torch.Tensor:
    """The last ``n`` frames in chronological order (``n`` ≤ capacity);
    frames never written read as zeros."""
    return rb.data[_positions(rb, -n, n)]


def ring_slice(rb: RingBuffer, start: int, stop: int) -> torch.Tensor:
    """Relative slice ``[start:stop]``, negative values counting back from
    the write head."""
    return rb.data[_positions(rb, start, stop - start)]


def query_circular(
    data: np.ndarray, key: slice, counter: int, axis: int = 0
) -> np.ndarray:
    """Host relative slice into raw circular storage (loopmate's
    ``query_circular``, realtime/recording.py:7, 410-411 of the
    reference): ``key`` has negative (relative-to-now) bounds, ``counter``
    is the write cursor."""
    n = data.shape[axis]
    start = key.start if key.start is not None else -n
    stop = key.stop if key.stop is not None else 0
    idx = (np.arange(start, stop) + counter) % n
    return np.take(data, idx, axis=axis)


class CircularArray:
    """Host (numpy) circular array with relative indexing: ``write``
    advances the counter, ``arr[-k:]`` reads the latest ``k`` frames.
    ``data`` may be external shared storage; it is never reallocated."""

    def __init__(self, data: np.ndarray, axis: int = 0):
        self.data = data
        self.axis = axis
        self.N = data.shape[axis]
        self.counter = 0
        self.write_counter = 0

    def write(self, block: np.ndarray) -> None:
        b = block.shape[self.axis]
        start = self.write_counter % self.N
        idx = (start + np.arange(b)) % self.N
        if self.axis == 0:
            self.data[idx] = block
        else:
            np.put_along_axis(
                self.data,
                np.expand_dims(
                    idx,
                    tuple(i for i in range(self.data.ndim) if i != self.axis)
                ),
                block,
                axis=self.axis,
            )
        self.write_counter += b
        self.counter += b

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, slice):
            return query_circular(self.data, key, self.counter, self.axis)
        if isinstance(key, int):
            return query_circular(
                self.data, slice(key, key + 1 if key != -1 else None),
                self.counter, self.axis,
            ).squeeze(self.axis)
        raise TypeError(f"Unsupported index {key!r}")

    def elements_since(self, abs_counter: int) -> int:
        """Frames written since an absolute counter snapshot."""
        return self.counter - abs_counter

    def index_offset(self, offset: int) -> int:
        """Physical index of the frame ``offset`` frames from the cursor."""
        return (self.counter + offset) % self.N

    def rearrange(self) -> np.ndarray:
        """The contents in chronological order (a copy)."""
        return self[-self.N:]
