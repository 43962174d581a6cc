"""Carry JAX-package parameters and detector state into the port.

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

    def t(a, *perm):
        a = np.asarray(a, np.float32)
        return torch.tensor(a.transpose(*perm) if perm else a)

    sd = {}
    for i in range(n):
        conv = stack[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = t(conv["kernel"], 2, 1, 0)
        sd[f"convs.{i}.bias"] = t(conv["bias"])
    for i in range(n_norm):
        norm = stack[f"GroupNorm_{i}"]
        sd[f"norms.{i}.weight"] = t(norm["scale"])
        sd[f"norms.{i}.bias"] = t(norm["bias"])
    dense = params["Dense_0"]
    sd["fc.weight"] = t(dense["kernel"], 1, 0)
    sd["fc.bias"] = t(dense["bias"])
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
