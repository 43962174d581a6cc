"""Carry JAX-package parameters (CCCNN, FCNN, CNN) and detector state into
the port.

The reverse direction of ``onset_fingerprinting_tpu.models.torch_import``.
Inputs are plain numpy: flax variables as nested dicts of arrays, detector
state and params as dicts of arrays (``NamedTuple._asdict()`` of the JAX
tuples, each leaf passed through ``np.asarray``).  Nothing here imports
jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from onset_fingerprinting_torch.detect.amplitude import (
    DetectorParams,
    DetectorState,
)
from onset_fingerprinting_torch.device import resolve_device


def cccnn_state_dict_from_flax(variables: Mapping) -> dict:
    """Flax CCCNN params → the port's ``state_dict``.

    ``_ConvStack_0/Conv_i/kernel [K, I/groups, O]`` → ``convs.i.weight [O,
    I/groups, K]`` (shared or grouped), ``_ConvStack_0/GroupNorm_i/{scale,
    bias}`` → ``norms.i.{weight,bias}``, ``Dense_0/kernel [in, out]`` →
    ``fc.weight [out, in]``; biases as they are.  Accepts ``{"params":
    ...}`` or the params dict itself.
    """
    params = variables.get("params", variables)
    stack = params["_ConvStack_0"]
    n = len([k for k in stack if k.startswith("Conv_")])
    n_norm = len([k for k in stack if k.startswith("GroupNorm_")])
    expected = ({f"Conv_{i}" for i in range(n)}
                | {f"GroupNorm_{i}" for i in range(n_norm)})
    if set(stack) != expected or n_norm not in (0, n):
        raise ValueError(
            f"unsupported conv stack entries {sorted(stack)} (expected "
            "Conv_0..n-1 and, with batch_norm, GroupNorm_0..n-1)"
        )

    sd = {}
    for i in range(n):
        conv = stack[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = _t(conv["kernel"], 2, 1, 0)
        sd[f"convs.{i}.bias"] = _t(conv["bias"])
    for i in range(n_norm):
        norm = stack[f"GroupNorm_{i}"]
        sd[f"norms.{i}.weight"] = _t(norm["scale"])
        sd[f"norms.{i}.bias"] = _t(norm["bias"])
    dense = params["Dense_0"]
    sd["fc.weight"] = _t(dense["kernel"], 1, 0)
    sd["fc.bias"] = _t(dense["bias"])
    return sd


def _t(a, *perm):
    """A flax leaf as a float32 tensor, its axes permuted by ``perm``."""
    a = np.asarray(a, np.float32)
    return torch.tensor(a.transpose(*perm) if perm else a)


def _batch_norms(params: Mapping, stats: Mapping, prefix: str) -> dict:
    """flax ``BatchNorm_i/{scale, bias}`` and ``batch_stats/BatchNorm_i/
    {mean, var}`` → ``{prefix}.i.{weight, bias, running_mean,
    running_var}``."""
    sd = {}
    for i in range(len([k for k in params if k.startswith("BatchNorm_")])):
        p, st = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
        sd[f"{prefix}.{i}.weight"] = _t(p["scale"])
        sd[f"{prefix}.{i}.bias"] = _t(p["bias"])
        sd[f"{prefix}.{i}.running_mean"] = _t(st["mean"])
        sd[f"{prefix}.{i}.running_var"] = _t(st["var"])
    return sd


def fcnn_state_dict_from_flax(variables: Mapping) -> dict:
    """Flax FCNN variables → the port's ``FCNN`` ``state_dict``: hidden
    ``Dense_i/kernel [in, out]`` → ``layers.i.weight [out, in]``, the last
    ``Dense_n`` → ``out``, BatchNorm as :func:`_batch_norms`."""
    params = variables["params"]
    n = len([k for k in params if k.startswith("Dense_")]) - 1
    sd = _batch_norms(params, variables.get("batch_stats", {}), "norms")
    for i in range(n + 1):
        dense = params[f"Dense_{i}"]
        name = "out" if i == n else f"layers.{i}"
        sd[f"{name}.weight"] = _t(dense["kernel"], 1, 0)
        if "bias" in dense:
            sd[f"{name}.bias"] = _t(dense["bias"])
    return sd


def cnn_state_dict_from_flax(variables: Mapping) -> dict:
    """Flax CNN variables → the port's ``CNN`` ``state_dict``:
    ``Conv_i/kernel [K, I, O]`` → ``convs.i.weight [O, I, K]``,
    ``Dense_0`` → ``fc``, BatchNorm as :func:`_batch_norms`."""
    params = variables["params"]
    sd = _batch_norms(params, variables.get("batch_stats", {}), "norms")
    for i in range(len([k for k in params if k.startswith("Conv_")])):
        conv = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = _t(conv["kernel"], 2, 1, 0)
        sd[f"convs.{i}.bias"] = _t(conv["bias"])
    sd["fc.weight"] = _t(params["Dense_0"]["kernel"], 1, 0)
    sd["fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd


_STATE_DTYPES = {"gate": torch.bool, "debounce": torch.int32,
                 "bt_pos": torch.int32}


def detector_state_from_numpy(arrays: Mapping, device=None) -> DetectorState:
    """Dict of numpy arrays (JAX ``DetectorState._asdict()``) → the port's
    ``DetectorState`` on ``device`` (None = the card)."""
    dev = resolve_device(device)
    return DetectorState(**{
        name: torch.as_tensor(
            np.array(arrays[name]),
            dtype=_STATE_DTYPES.get(name, torch.float32), device=dev,
        )
        for name in DetectorState._fields
    })


def detector_state_to_numpy(state: DetectorState) -> dict:
    """The port's ``DetectorState`` → dict of numpy arrays."""
    return {name: getattr(state, name).cpu().numpy()
            for name in DetectorState._fields}


def detector_params_from_numpy(arrays: Mapping, device=None
                               ) -> DetectorParams:
    """Dict of numpy arrays (JAX ``DetectorParams._asdict()``) → the port's
    ``DetectorParams`` (all float32)."""
    dev = resolve_device(device)
    return DetectorParams(**{
        name: torch.as_tensor(np.array(arrays[name], np.float32), device=dev)
        for name in DetectorParams._fields
    })


def detector_params_to_numpy(params: DetectorParams) -> dict:
    return {name: getattr(params, name).cpu().numpy()
            for name in DetectorParams._fields}
