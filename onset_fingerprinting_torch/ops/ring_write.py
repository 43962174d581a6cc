"""The realtime engine's audio-ring write: the wrapper of
``csrc/ring_write.cu``.

The JAX engine's step writes each block to its device ring with
``core/ring_buffer.ring_write`` inside the block's XLA program.  Here the
plain version is the port's ``core/ring_buffer.ring_write`` (six small
PyTorch kernels); on the card :func:`write_block` is one launch of
``csrc/ring_write.cu`` (counter ``_cuda.RING_WRITE``), the same for every
detector route the step takes.

Dispatch is by device, as for the other kernels: a CPU tensor runs the
plain version (counted in ``plain_calls``), a CUDA tensor launches the
kernel or raises.  Both write in place, data and counter.
"""

from __future__ import annotations

import torch

from onset_fingerprinting_torch.core.ring_buffer import RingBuffer, ring_write
from onset_fingerprinting_torch.ops import _cuda


def _check(rb: RingBuffer, block: torch.Tensor) -> None:
    data, counter = rb.data, rb.counter
    if (data.dtype != torch.float32 or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError("the ring must be contiguous float32 [N, C]")
    if counter.dtype != torch.int32 or counter.dim() != 0:
        raise ValueError("the ring's counter must be a 0-d int32 tensor")
    if (block.dtype != torch.float32 or block.dim() != 2
            or block.shape[1] != data.shape[1] or not block.is_contiguous()):
        raise ValueError(f"the block must be contiguous float32 "
                         f"[B, {data.shape[1]}]")
    if not 1 <= block.shape[0] <= rb.capacity:
        raise ValueError(f"a block of {block.shape[0]} frames does not fit "
                         f"a ring of {rb.capacity} once")
    if block.device != data.device or counter.device != data.device:
        raise ValueError("ring, counter and block must be on one device")


def write_block(rb: RingBuffer, block: torch.Tensor) -> RingBuffer:
    """Write ``block [B, C]`` (B at most the ring's capacity) at the ring's
    head, wrapping, and advance its counter by B, in place; returns
    ``rb``."""
    _check(rb, block)
    if block.device.type == "cpu":
        _cuda.RING_WRITE.plain_calls += 1
        rb.counter.copy_(ring_write(rb, block).counter)
        return rb
    _cuda.RING_WRITE.launch(
        "ofpt_ring_write", block.data_ptr(), rb.data.data_ptr(),
        rb.counter.data_ptr(), block.shape[0], block.shape[1], rb.capacity,
        _cuda.stream())
    return rb
