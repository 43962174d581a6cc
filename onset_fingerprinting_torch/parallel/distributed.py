"""Multi-process initialisation and global meshes (port of
``onset_fingerprinting_tpu.parallel.distributed``).

The JAX package initialises ``jax.distributed`` and builds one global mesh
over every process's devices.  Here a run is a ``torch.distributed``
process group: NCCL between the cards, or gloo when the caller asks for
the CPU.  :func:`init_distributed` is called once at process start;
for one process it is a no-op, so the same entry points work on one card
or many.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.parallel.mesh import Mesh, _world, make_mesh

#: set by ``torchrun`` and other launchers of a multi-process run
_LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def pod_env_detected() -> bool:
    """True when a launcher's environment names a run of more than one
    process (``WORLD_SIZE`` > 1, or ``RANK`` and ``MASTER_ADDR`` set)."""
    world = os.environ.get("WORLD_SIZE")
    if world is not None:
        try:
            return int(world) > 1
        except ValueError:
            return False
    return bool(os.environ.get("RANK")) and bool(os.environ.get("MASTER_ADDR"))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    **kwargs,
) -> bool:
    """Initialise the process group of a multi-process run.

    - With a ``coordinator_address`` (``host:port`` or a ``tcp://`` /
      ``file://`` URL) it joins ``num_processes`` processes as
      ``process_id``.
    - Without one it initialises only where :func:`pod_env_detected`
      (from the launcher's environment, ``env://``); otherwise it is a
      no-op.
    - One process is a no-op too: nothing to coordinate.

    The backend is NCCL on the cards, gloo only when ``device="cpu"``
    (``device`` None means the card, and raises without CUDA).  Returns
    True iff the process is part of a multi-process run afterwards.
    Idempotent: safe to call from every entry point."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None
    if not explicit and not pod_env_detected():
        return False
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if explicit:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=process_id, **kwargs)
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dist.get_world_size() > 1


def global_mesh(
    axis_shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Mesh:
    """Mesh over all ranks of the (possibly multi-process) run: one flat
    ``data`` axis by default; multi-axis shapes must fit the rank count."""
    world, _ = _world()
    if devices is None:
        devices = list(range(world))
    if axis_shape is None:
        axis_shape = (len(devices),)
    n = int(np.prod(axis_shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(axis_shape)} needs {n} devices, "
            f"have {len(devices)}"
        )
    return make_mesh(axis_shape, axis_names, devices, device)
