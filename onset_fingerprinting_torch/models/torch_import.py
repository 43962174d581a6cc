"""Reference setup checkpoints into the port's FCNN (the FCNN part of
``onset_fingerprinting_tpu.models.torch_import``).

The reference persists its serve setup as ``ml_conf.json`` plus a torch
``model.pt`` ``state_dict`` (realtime/config.py:63-108, the FCNN at
calibration.py:463-560 there): one ``nn.Sequential`` named ``network`` of,
per hidden layer, a Linear, optionally a BatchNorm1d, an activation and
optionally a Dropout, then a final Linear.  This module maps that layout
onto :class:`~onset_fingerprinting_torch.models.fcnn.FCNN` (``layers.i``,
``norms.i``, ``out``), so a reference user's calibrated setup serves
without retraining.  The CNN, CCCNN and RNN maps of the JAX module wait
for ``models/rnn.py``'s port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional

import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.fcnn import (
    ACTIVATIONS,
    FCNN,
    FCNNBundle,
)


def fcnn_from_model_args(model_args: Mapping,
                         input_size: Optional[int] = None) -> FCNN:
    """The port's FCNN for a reference ``model_args`` dict (the torch
    constructor's kwargs, realtime/config.py:74-82 there), ``activation`` a
    lowercase string or a class whose name is one.  ``input_size`` comes
    from ``model_args`` or the argument; an unknown key raises, as the
    reference's ``FCNN(**model_args)`` would."""
    args = dict(model_args)
    size = args.pop("input_size", input_size)
    if size is None:
        raise ValueError("model_args has no input_size and none was given")
    act = args.pop("activation", "relu")
    if not isinstance(act, str):
        act = getattr(act, "__name__", str(act))
    act = act.lower()
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act!r} in model_args; "
                         f"known: {sorted(ACTIVATIONS)}")
    if "hidden_layers" in args:
        args["hidden_layers"] = tuple(args["hidden_layers"])
    return FCNN(int(size), activation=act, **args)


def fcnn_state_dict_from_reference(state_dict: Mapping,
                                   model: FCNN) -> dict:
    """A reference FCNN ``state_dict`` → ``model``'s.  Only Linear and
    BatchNorm1d carry tensors, so the map ignores the sequential indices
    and pairs them up in order of appearance: the i-th BatchNorm1d →
    ``norms.i`` (``num_batches_tracked`` dropped), the Linears → ``layers.
    i`` and the last one → ``out``.  Raises where the layer counts or a
    Linear's bias disagree with ``model``."""
    slots: dict[str, dict[str, torch.Tensor]] = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        slots.setdefault(".".join(parts[:-1]), {})[parts[-1]] = \
            torch.as_tensor(tensor, dtype=torch.float32)
    linears, norms = [], []
    for slot in slots.values():
        (norms if "running_mean" in slot else linears).append(slot)
    n_hidden = len(model.layers)
    want_bn = len(model.norms)
    if len(linears) != n_hidden + 1 or len(norms) != want_bn:
        raise ValueError(
            f"state_dict has {len(linears)} Linear / {len(norms)} BatchNorm "
            f"layers; the model expects {n_hidden + 1} / {want_bn}")
    has_bias = model.out.bias is not None
    sd = {}
    for i, slot in enumerate(linears):
        if ("bias" in slot) != has_bias:
            raise ValueError(
                f"Linear layer {i} {'has' if 'bias' in slot else 'lacks'} "
                f"a bias tensor but model_args says bias={has_bias}")
        name = "out" if i == n_hidden else f"layers.{i}"
        sd[f"{name}.weight"] = slot["weight"]
        if has_bias:
            sd[f"{name}.bias"] = slot["bias"]
    for i, slot in enumerate(norms):
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"norms.{i}.{k}"] = slot[k]
    return sd


def load_reference_setup(path: str | Path, json_name: str = "ml_conf.json",
                         c: Optional[float] = None,
                         model_file: str = "model.pt", device=None):
    """A setup directory saved by the reference, as it is: ``(conf,
    FCNNBundle or None)``, the model on ``device`` (None = the card), the
    contract of ``realtime.setup_io.load_setup`` (which calls this when it
    finds ``model.pt``).  Raises ``FileNotFoundError`` where ``model_args``
    names a model and ``model_file`` is missing."""
    from onset_fingerprinting_torch.realtime.setup_io import read_conf

    path = Path(path)
    conf = read_conf(path, json_name=json_name, c=c)
    model = None
    model_args = conf.get("model_args")
    if model_args:
        if not (path / model_file).exists():
            raise FileNotFoundError(
                f"{path / model_file} not found but model_args is set: the "
                "setup's calibrated location model is missing")
        state_dict = torch.load(path / model_file, map_location="cpu",
                                weights_only=True)
        fcnn = fcnn_from_model_args(
            model_args, len(conf["sensor_locations"]) - 1)
        fcnn.load_state_dict(fcnn_state_dict_from_reference(state_dict,
                                                            fcnn))
        model = FCNNBundle(fcnn.to(resolve_device(device)))
    return conf, model
