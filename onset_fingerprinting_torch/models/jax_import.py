"""Carry JAX-package parameters (CCCNN, FCNN, CNN, RNN, CNNRNN) and
detector state into the port.

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


#: flax's gate blocks in torch's order of fused gate rows
_CELL_GATES = {"GRUCell": ("r", "z", "n"),
               "OptimizedLSTMCell": ("i", "f", "g", "o"),
               "SimpleCell": ("",)}


def _cell_state_dict(cell_name: str, p: Mapping, suffix: str) -> dict:
    """One flax cell → one direction of a torch recurrent layer
    (``weight_ih_l0{suffix}`` ...).  flax keeps one bias per gate: the GRU's
    r and z biases and the LSTM's biases (on its hidden kernels) become
    torch's input-side biases with zero hidden-side ones; the GRU's
    candidate gate keeps both, as torch does; the tanh cell's input bias
    goes to the input side."""
    gates = _CELL_GATES[cell_name]
    w_ih = torch.cat([_t(p[f"i{g}"]["kernel"], 1, 0) for g in gates])
    w_hh = torch.cat([_t(p[f"h{g}"]["kernel"], 1, 0) for g in gates])
    h = w_hh.shape[1]
    zeros = torch.zeros(h)
    if cell_name == "GRUCell":
        b_ih = torch.cat([_t(p[f"i{g}"]["bias"]) for g in gates])
        b_hh = torch.cat([zeros, zeros, _t(p["hn"]["bias"])])
    elif cell_name == "OptimizedLSTMCell":
        b_ih = torch.cat([_t(p[f"h{g}"]["bias"]) for g in gates])
        b_hh = torch.zeros(4 * h)
    else:
        b_ih = _t(p["i"]["bias"])
        b_hh = zeros
    return {f"weight_ih_l0{suffix}": w_ih, f"weight_hh_l0{suffix}": w_hh,
            f"bias_ih_l0{suffix}": b_ih, f"bias_hh_l0{suffix}": b_hh}


def _attention_state_dict(p: Mapping) -> dict:
    """flax ``MultiHeadDotProductAttention`` (per-projection ``[E, heads,
    head_dim]`` kernels) → ``nn.MultiheadAttention``'s packed tensors
    (head-major features)."""
    e = np.asarray(p["out"]["bias"]).shape[0]
    qkv = ("query", "key", "value")
    return {
        "attention.in_proj_weight": torch.cat(
            [_t(np.asarray(p[n]["kernel"]).reshape(e, e), 1, 0)
             for n in qkv]),
        "attention.in_proj_bias": torch.cat(
            [_t(np.asarray(p[n]["bias"]).reshape(e)) for n in qkv]),
        "attention.out_proj.weight": _t(
            np.asarray(p["out"]["kernel"]).reshape(e, e), 1, 0),
        "attention.out_proj.bias": _t(p["out"]["bias"]),
    }


def _cells(params: Mapping) -> tuple[str, list]:
    names = [k for k in params if k.rsplit("_", 1)[0] in _CELL_GATES]
    if not names:
        raise ValueError(f"no recurrent cell among {sorted(params)}")
    kind = names[0].rsplit("_", 1)[0]
    return kind, [params[f"{kind}_{i}"] for i in range(len(names))]


def rnn_state_dict_from_flax(variables: Mapping, bidirectional: bool = False
                             ) -> dict:
    """Flax RNN params → the port's ``RNN`` ``state_dict``: the cells in
    flax's order (layer 0 forward, layer 0 reverse, layer 1 ...) →
    ``rnn.{layer}``, ``LayerNorm_0`` → ``layer_norm``, the attention,
    ``Dense_0`` → ``fc``."""
    params = variables.get("params", variables)
    kind, cells = _cells(params)
    dirs = ("", "_reverse") if bidirectional else ("",)
    sd = {}
    for i, cell in enumerate(cells):
        layer, d = divmod(i, len(dirs))
        sd.update({f"rnn.{layer}.{k}": v for k, v in
                   _cell_state_dict(kind, cell, dirs[d]).items()})
    sd["layer_norm.weight"] = _t(params["LayerNorm_0"]["scale"])
    sd["layer_norm.bias"] = _t(params["LayerNorm_0"]["bias"])
    sd.update(_attention_state_dict(params["MultiHeadDotProductAttention_0"]))
    sd["fc.weight"] = _t(params["Dense_0"]["kernel"], 1, 0)
    sd["fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def cnnrnn_state_dict_from_flax(variables: Mapping) -> dict:
    """Flax CNNRNN variables → the port's ``CNNRNN`` ``state_dict``: the
    conv stack as :func:`cnn_state_dict_from_flax`, ``GRUCell_i`` →
    ``rnn.i``, the attention, ``Dense_0`` → ``fc``."""
    params = variables["params"]
    sd = _batch_norms(params, variables.get("batch_stats", {}), "norms")
    for i in range(len([k for k in params if k.startswith("Conv_")])):
        conv = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = _t(conv["kernel"], 2, 1, 0)
        sd[f"convs.{i}.bias"] = _t(conv["bias"])
    _, cells = _cells(params)
    for i, cell in enumerate(cells):
        sd.update({f"rnn.{i}.{k}": v for k, v in
                   _cell_state_dict("GRUCell", cell, "").items()})
    sd.update(_attention_state_dict(params["MultiHeadDotProductAttention_0"]))
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
