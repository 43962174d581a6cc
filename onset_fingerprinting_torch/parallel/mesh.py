"""Device meshes over the processes of a ``torch.distributed`` run (port of
``onset_fingerprinting_tpu.parallel.mesh``).

The JAX package expresses scale-out once, as a ``jax.sharding.Mesh`` over
devices: batches shard over the ``data`` axis, XLA inserts the
collectives.  Here a device of the mesh is a process (a rank) with its
card: :class:`Mesh` lays the ranks out in the axis shape, row-major, and
holds for each axis the process group of the ranks that differ only along
it, so that a collective "over ``data``" is a ``torch.distributed`` call on
that group.  Without an initialised process group there is one device,
this process, and no collective runs.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from onset_fingerprinting_torch.device import resolve_device


def _world() -> tuple[int, int]:
    """``(world size, rank)``, ``(1, 0)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_device(device=None) -> torch.device:
    """This process's device: its card (``LOCAL_RANK``, else the rank,
    modulo the cards it sees) unless ``device`` names the CPU.  ``None``
    means the card and raises without CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        _, rank = _world()
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


class Mesh:
    """Ranks laid out in a named axis shape.

    ``devices`` (the ranks, an array of the axis shape), ``axis_names``,
    ``shape`` (axis name → size, as ``jax.sharding.Mesh.shape``),
    ``device`` (this process's torch device), ``rank``, :meth:`index` (this
    rank's coordinate along an axis) and :meth:`group` (the process group
    of an axis; None without a process group)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim} axes but names {axis_names}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = device
        world, self.rank = _world()
        self._groups = {}
        if not dist.is_initialized():
            return
        # every rank creates every group, in the same order
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, a, -1).reshape(-1, ranks.shape[a])
            for line in lines:
                members = [int(r) for r in line]
                if len(members) == world:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(members)
                if self.rank in members:
                    self._groups[name] = g

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh")
        return int(where[0][self.axis_names.index(axis)])

    def group(self, axis: str):
        """The process group of ``axis`` (None: a single process)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, device "
                f"{self.device})")


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Mesh:
    """A mesh of the given shape over the ranks ``devices`` (default all of
    the run's, in order); ``device`` None means each rank's card."""
    world, _ = _world()
    ranks = list(devices if devices is not None else range(world))
    n = int(np.prod(axis_shapes))
    if n > len(ranks):
        raise ValueError(
            f"mesh needs {n} devices, only {len(ranks)} available"
        )
    arr = np.array(ranks[:n]).reshape(tuple(axis_shapes))
    return Mesh(arr, axis_names, local_device(device))


def default_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1, device=None
) -> Mesh:
    """(data, model) mesh over all the run's ranks by default."""
    world, _ = _world()
    n = n_devices or world
    return make_mesh(
        (n // model_parallel, model_parallel), ("data", "model"),
        list(range(world))[:n], device,
    )
