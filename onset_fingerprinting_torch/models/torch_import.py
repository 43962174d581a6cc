"""Reference checkpoints into the port's models (port of
``onset_fingerprinting_tpu.models.torch_import``).

The reference persists torch ``state_dict``s: its serve setup as
``ml_conf.json`` plus ``model.pt`` (realtime/config.py:63-108, the FCNN at
calibration.py:463-560 there) and its trained CNN, CCCNN (or the ``LCCCNN``
Lightning wrapper, keys prefixed ``model.``), RNN and CNNRNN
(model.py:52-629 there).  For each family ``*_from_model_args`` builds the
port's model from the reference's constructor kwargs and
``*_state_dict_from_reference`` maps the reference's tensors onto it, the
twins of the JAX module's ``*_variables_from_state_dict``, with the same
refusals (unknown keys, layer counts, widths, the head's shape).  Both
sides are torch, so the maps rename and, where the port's layout differs,
permute:

- FCNN: the Linears and BatchNorm1ds in order → ``layers.i``/``norms.i``,
  the last Linear → ``out``;
- CNN: ``conv_layers.conv{i}`` → ``convs.{i-1}``, ``conv_layers.bn{i}`` →
  ``norms.{i-1}``, ``fc``'s columns from torch's channel-major flatten to
  the port's position-major one (flax's);
- CCCNN: the same conv and norm renames (GroupNorm, grouped convs as they
  are), ``fc`` as it is;
- RNN/CNNRNN: the fused ``rnn.*_l{k}[_reverse]`` → one module per layer
  ``rnn.{k}.*_l0[_reverse]`` (absent biases as zeros), ``layer_norm``,
  ``attention`` and ``fc`` as they are.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional

import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.cnn import CNN
from onset_fingerprinting_torch.models.fcnn import (
    ACTIVATIONS,
    FCNN,
    FCNNBundle,
)
from onset_fingerprinting_torch.models.rnn import CNNRNN, RNN

__all__ = [
    "cccnn_from_model_args",
    "cccnn_state_dict_from_reference",
    "cnn_from_model_args",
    "cnn_state_dict_from_reference",
    "cnnrnn_from_model_args",
    "cnnrnn_state_dict_from_reference",
    "fcnn_from_model_args",
    "fcnn_state_dict_from_reference",
    "load_reference_setup",
    "rnn_from_model_args",
    "rnn_state_dict_from_reference",
]


def _activation(args: dict, default: str) -> str:
    """Pop ``activation`` (a lowercase string or a class whose name is one)
    and check it."""
    act = args.pop("activation", default)
    if not isinstance(act, str):
        act = getattr(act, "__name__", str(act))
    act = act.lower()
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act!r} in model_args; "
                         f"known: {sorted(ACTIVATIONS)}")
    return act


def _size(args: dict, key: str, given):
    size = args.pop(key, given)
    if size is None:
        raise ValueError(f"model_args has no {key} and none was given")
    return int(size)


def _tensors(state_dict: Mapping) -> dict:
    """The state_dict's tensors as float32 by key, ``model.`` (the LCCCNN
    wrapper's prefix) and ``num_batches_tracked`` dropped."""
    out = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if parts[-1] == "num_batches_tracked":
            continue
        out[".".join(parts)] = torch.as_tensor(tensor, dtype=torch.float32)
    return out


def _conv_layers(sd: dict, keep_other: bool = False):
    """Split ``conv_layers.conv{i}`` / ``conv_layers.bn{i}`` (1-based) from
    the rest: ``(convs {i: {name: t}}, norms {i: ...}, rest)``.  Without
    ``keep_other`` only ``fc.*`` may remain."""
    convs: dict[int, dict] = {}
    norms: dict[int, dict] = {}
    rest = {}
    for key, t in sd.items():
        parts = key.split(".")
        if parts[0] == "conv_layers" and parts[1].startswith("conv"):
            convs.setdefault(int(parts[1][4:]), {})[parts[-1]] = t
        elif parts[0] == "conv_layers" and parts[1].startswith("bn"):
            norms.setdefault(int(parts[1][2:]), {})[parts[-1]] = t
        elif keep_other or parts[0] == "fc":
            rest[key] = t
        else:
            raise ValueError(f"unrecognized state_dict key {key!r}")
    return convs, norms, rest


def _check_counts(convs, norms, n_layers: int, want_norms: int,
                  fc: bool = True) -> None:
    if len(convs) != n_layers or len(norms) != want_norms or not fc:
        raise ValueError(
            f"state_dict has {len(convs)} conv / {len(norms)} norm layers "
            f"and {'a' if fc else 'no'} fc head; the model expects "
            f"{n_layers} / {want_norms}")


def _convs_and_norms(convs, norms, model, bn_stats: bool) -> dict:
    """``convs.{i-1}`` / ``norms.{i-1}`` of the port's model; a conv whose
    shape is not the model's raises."""
    sd = {}
    for i in sorted(convs):
        w = convs[i]["weight"]
        want = tuple(model.convs[i - 1].weight.shape)
        if tuple(w.shape) != want:
            raise ValueError(
                f"conv{i} has weight {tuple(w.shape)}; model_args give "
                f"{want} (layer_sizes, kernel sizes, group)")
        sd[f"convs.{i - 1}.weight"] = w
        sd[f"convs.{i - 1}.bias"] = convs[i]["bias"]
    for i in sorted(norms):
        keys = ("weight", "bias") + (
            ("running_mean", "running_var") if bn_stats else ())
        for k in keys:
            sd[f"norms.{i - 1}.{k}"] = norms[i][k]
    return sd


def fcnn_from_model_args(model_args: Mapping,
                         input_size: Optional[int] = None) -> FCNN:
    """The port's FCNN for a reference ``model_args`` dict (the torch
    constructor's kwargs, realtime/config.py:74-82 there), ``activation`` a
    lowercase string or a class whose name is one.  ``input_size`` comes
    from ``model_args`` or the argument; an unknown key raises, as the
    reference's ``FCNN(**model_args)`` would."""
    args = dict(model_args)
    size = _size(args, "input_size", input_size)
    act = _activation(args, "relu")
    if "hidden_layers" in args:
        args["hidden_layers"] = tuple(args["hidden_layers"])
    return FCNN(size, activation=act, **args)


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


def cnn_from_model_args(model_args: Mapping,
                        input_size: Optional[int] = None,
                        channels: Optional[int] = None) -> CNN:
    """The port's CNN for a reference ``model_args`` dict (the reference CNN
    constructor, model.py:58-75 there).  ``input_size`` and ``channels``
    come from ``model_args`` or the arguments (a torch module sizes its
    dense layer up front); ``loss`` and ``lr`` are training settings and
    dropped."""
    args = dict(model_args)
    size = _size(args, "input_size", input_size)
    chans = _size(args, "channels", channels)
    for k in ("loss", "lr"):
        args.pop(k, None)
    act = _activation(args, "silu")
    if "layer_sizes" in args:
        args["layer_sizes"] = tuple(args["layer_sizes"])
    return CNN(size, chans, activation=act, **args)


def cnn_state_dict_from_reference(state_dict: Mapping, model: CNN) -> dict:
    """A reference CNN ``state_dict`` (model.py:85-113 there:
    ``conv_layers.conv{i}``, optional ``conv_layers.bn{i}`` BatchNorm1d,
    the flat ``fc``) → ``model``'s.  torch flattens the last feature maps
    channel-major (``[C, V]``) and the port position-major (``[V, C]``, as
    flax), so ``fc.weight`` is permuted ``[out, C, V] → [out, V, C]``.
    Raises on unknown keys, layer counts, conv shapes and an ``fc`` that
    does not fit the conv arithmetic."""
    convs, norms, rest = _conv_layers(_tensors(state_dict))
    _check_counts(convs, norms, len(model.convs), len(model.norms),
                  bool(rest))
    sd = _convs_and_norms(convs, norms, model, bn_stats=True)
    w = rest["fc.weight"]
    c_last = model.convs[-1].out_channels
    if tuple(w.shape) != tuple(model.fc.weight.shape):
        raise ValueError(
            f"fc expects {w.shape[1]} inputs but the conv arithmetic gives "
            f"{model.fc.in_features} (C_last {c_last}): wrong input_size/"
            "padding/pool in model_args?")
    v = w.shape[1] // c_last
    sd["fc.weight"] = w.reshape(-1, c_last, v).transpose(1, 2).reshape(
        w.shape[0], -1).contiguous()
    sd["fc.bias"] = rest["fc.bias"]
    return sd


def cccnn_from_model_args(model_args: Mapping,
                          input_size: Optional[int] = None) -> CCCNN:
    """The port's CCCNN for a reference ``model_args`` dict (the reference
    CCCNN constructor, model.py:445-459 there); every other key goes to the
    constructor as it is (``conv_impl``, ``cc_impl`` ... too, as the JAX
    package's ``CCCNN(activation=act, **args)``)."""
    args = dict(model_args)
    size = _size(args, "input_size", input_size)
    act = _activation(args, "silu")
    for key in ("layer_sizes", "kernel_sizes", "strides"):
        if key in args and not isinstance(args[key], int):
            args[key] = tuple(args[key])
    return CCCNN(size, activation=act, **args)


def cccnn_state_dict_from_reference(state_dict: Mapping, model: CCCNN
                                    ) -> dict:
    """A reference CCCNN or LCCCNN ``state_dict`` (model.py:475-513 there:
    ``conv_layers.conv{i}``, optional ``conv_layers.bn{i}`` GroupNorm(1,
    ·), ``fc``) → ``model``'s.  Grouped checkpoints map the same way (the
    port's grouped convs keep torch's channel-major features and one
    GroupNorm over all of them); ``fc`` carries over as it is, since the
    self-correlation is even in the lag.  Raises on ``cc_norm`` models
    (their head is wider by construction), unknown keys, layer counts and
    conv shapes."""
    if model.cc_norm:
        raise ValueError(
            "cc_norm=True changes the dense-head input layout; reference "
            "checkpoints only fit cc_norm=False models")
    convs, norms, rest = _conv_layers(_tensors(state_dict))
    _check_counts(convs, norms, len(model.convs), len(model.norms),
                  bool(rest))
    sd = _convs_and_norms(convs, norms, model, bn_stats=False)
    sd["fc.weight"] = rest["fc.weight"]
    sd["fc.bias"] = rest["fc.bias"]
    return sd


def rnn_from_model_args(model_args: Mapping,
                        channels: Optional[int] = None) -> RNN:
    """The port's RNN for a reference ``model_args`` dict (the reference
    RNN constructor, model.py:169-188 there).  ``channels`` (the input's
    features) comes from ``model_args`` or the argument; ``input_size``,
    ``loss``, ``lr``, ``bias`` (the state_dict carries it) and
    ``activation`` (unused by the reference's forward) are dropped;
    ``batch_first=False`` raises."""
    args = dict(model_args)
    chans = _size(args, "channels", channels)
    for k in ("input_size", "loss", "lr", "bias", "activation"):
        args.pop(k, None)
    if not args.pop("batch_first", True):
        raise ValueError("batch_first=False checkpoints are not supported")
    return RNN(chans, **args)


def _rnn_layers(sd: dict, layers: int, directions) -> dict:
    """Fused ``rnn.{w}_l{k}{d}`` → ``rnn.{k}.{w}_l0{d}``; absent biases
    (``bias=False``) as zeros.  Raises on a missing or an unconsumed
    layer."""
    out = {}
    for k in range(layers):
        for d in directions:
            w_ih = sd.pop(f"rnn.weight_ih_l{k}{d}", None)
            if w_ih is None:
                raise ValueError(
                    f"state_dict lacks rnn layer {k}{d}: the model expects "
                    f"{layers} layers in {len(directions)} directions")
            w_hh = sd.pop(f"rnn.weight_hh_l{k}{d}")
            out[f"rnn.{k}.weight_ih_l0{d}"] = w_ih
            out[f"rnn.{k}.weight_hh_l0{d}"] = w_hh
            for side, n in (("ih", w_ih.shape[0]), ("hh", w_hh.shape[0])):
                b = sd.pop(f"rnn.bias_{side}_l{k}{d}", None)
                out[f"rnn.{k}.bias_{side}_l0{d}"] = (
                    torch.zeros(n) if b is None else b)
    extra = sorted(k for k in sd if k.startswith("rnn."))
    if extra:
        raise ValueError(f"unconsumed rnn tensors {extra}: model_args' "
                         "layer count or bidirectional disagree with the "
                         "checkpoint")
    return out


_ATTENTION = ("attention.in_proj_weight", "attention.in_proj_bias",
              "attention.out_proj.weight", "attention.out_proj.bias")
_LAYER_NORM = ("layer_norm.weight", "layer_norm.bias")
_FC = ("fc.weight", "fc.bias")


def _head(sd: dict, keys) -> dict:
    """Pop ``keys`` (a missing one raises ``KeyError``, as in the JAX
    module); anything left raises."""
    out = {k: sd.pop(k) for k in keys}
    if sd:
        raise ValueError(f"unrecognized state_dict keys {sorted(sd)}")
    return out


def rnn_state_dict_from_reference(state_dict: Mapping, model: RNN) -> dict:
    """A reference RNN ``state_dict`` (model.py:216-238 there: a fused
    multi-layer ``rnn``, ``layer_norm``, a ``MultiheadAttention`` named
    ``attention``, ``fc``) → ``model``'s: the fused layers split per layer,
    the rest as it is.  Raises on missing, unconsumed or unknown
    tensors."""
    sd = _tensors(state_dict)
    dirs = ("", "_reverse") if model.bidirectional else ("",)
    out = _rnn_layers(sd, model.num_layers, dirs)
    out.update(_head(sd, _LAYER_NORM + _ATTENTION + _FC))
    return out


def cnnrnn_from_model_args(model_args: Mapping,
                           input_size: Optional[int] = None,
                           channels: Optional[int] = None) -> CNNRNN:
    """The port's CNNRNN for a reference ``model_args`` dict (the reference
    CNNRNN constructor, model.py:311-329 there); ``input_size`` and
    ``channels`` from ``model_args`` or the arguments."""
    args = dict(model_args)
    size = _size(args, "input_size", input_size)
    chans = _size(args, "channels", channels)
    for k in ("loss", "lr"):
        args.pop(k, None)
    act = _activation(args, "silu")
    if "layer_sizes" in args:
        args["layer_sizes"] = tuple(args["layer_sizes"])
    return CNNRNN(size, chans, activation=act, **args)


def cnnrnn_state_dict_from_reference(state_dict: Mapping, model: CNNRNN
                                     ) -> dict:
    """A reference CNNRNN ``state_dict`` → ``model``'s: the conv stack as
    :func:`cnn_state_dict_from_reference` (no flatten: the maps feed the
    GRU as a sequence), the GRU layers as :func:`rnn_state_dict_from_
    reference`, ``attention`` and ``fc`` as they are."""
    convs, norms, rest = _conv_layers(_tensors(state_dict), keep_other=True)
    _check_counts(convs, norms, len(model.convs), len(model.norms))
    out = _convs_and_norms(convs, norms, model, bn_stats=True)
    out.update(_rnn_layers(rest, model.n_rnn_layers, ("",)))
    out.update(_head(rest, _ATTENTION + _FC))
    return out


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
