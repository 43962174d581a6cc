"""Reference checkpoints into the port (``models/torch_import.py``) against
the JAX package's maps, on the CPU.

The reference's models are absent here, so each test writes a
reference-layout ``state_dict`` itself (the key layouts the JAX module
documents: ``conv_layers.conv{i}``/``bn{i}`` and ``fc``, the fused
``rnn.*_l{k}[_reverse]``, ``layer_norm``, ``attention.in_proj_*``), its
values drawn from a seeded generator, and sends it through the port's
``*_from_model_args`` + ``*_state_dict_from_reference`` and through JAX's
``*_from_model_args`` + ``*_variables_from_state_dict``: the two models'
eval outputs on the same input within atol 1e-5, rtol 1e-4 (float32).
Mismatched checkpoints raise the same error type on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from onset_fingerprinting_tpu.models import torch_import as J
from onset_fingerprinting_torch.models import torch_import as P

KW = dict(atol=1e-5, rtol=1e-4)


def randomise(module: nn.Module, seed: int) -> dict:
    """``module``'s state_dict with every float tensor drawn from a seeded
    generator (variances positive)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.is_floating_point():
            v = 0.3 * torch.randn(v.shape, generator=g)
            if k.endswith("running_var"):
                v = 0.5 + v.abs()
        sd[k] = v
    return sd


def conv_layers(channels, layer_sizes, kernels, batch_norm, **conv_kw):
    """``conv_layers.conv{i}`` (+ ``bn{i}``) as the reference names them."""
    seq = nn.Module()
    cin = channels
    for i, (w, k) in enumerate(zip(layer_sizes, kernels), start=1):
        setattr(seq, f"conv{i}", nn.Conv1d(cin, w, k, **conv_kw))
        if batch_norm:
            setattr(seq, f"bn{i}", nn.BatchNorm1d(w))
        cin = w
    return seq


def reference_module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def port_out(model, x):
    with torch.no_grad():
        return model.eval()(torch.tensor(x)).numpy()


def jax_out(jm, variables, x):
    return np.asarray(jm.apply(variables, jnp.asarray(x), train=False))


def x_of(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# -- CNN ----------------------------------------------------------------------

CNN_CASES = [
    (dict(layer_sizes=[4, 6], kernel_size=3), "plain"),
    (dict(layer_sizes=[4, 6], kernel_size=5, batch_norm=True, pool=True,
          padding=2), "bn-pool"),
    (dict(layer_sizes=[5], kernel_size=3, dilation=2, activation="relu"),
     "dilated"),
]


def ref_cnn(args, w, c, seed):
    k, pad, dil = args["kernel_size"], args.get("padding", 1), args.get(
        "dilation", 1)
    v = w
    for _ in args["layer_sizes"]:
        v = v + 2 * pad - dil * (k - 1)
        v = v // 2 if args.get("pool") else v
    convs = conv_layers(c, args["layer_sizes"], [k] * len(args[
        "layer_sizes"]), args.get("batch_norm"), padding=pad, dilation=dil)
    return randomise(reference_module(
        conv_layers=convs, fc=nn.Linear(args["layer_sizes"][-1] * v, 2)),
        seed)


@pytest.mark.parametrize("args", [a for a, _ in CNN_CASES],
                         ids=[i for _, i in CNN_CASES])
def test_cnn_import(args):
    w, c = 40, 3
    margs = dict(input_size=w, channels=c, output_size=2, dropout_rate=0.0,
                 **args)
    sd = ref_cnn(args, w, c, 1)
    model = P.cnn_from_model_args(margs)
    model.load_state_dict(P.cnn_state_dict_from_reference(sd, model))
    jm = J.cnn_from_model_args(margs)
    x = x_of((4, c, w))
    np.testing.assert_allclose(
        port_out(model, x),
        jax_out(jm, J.cnn_variables_from_state_dict(sd, jm, w, c), x), **KW)


def test_cnn_import_refusals():
    w, c = 40, 3
    args = CNN_CASES[0][0]
    sd = ref_cnn(args, w, c, 2)
    bad_size = dict(input_size=w + 8, channels=c, **args)
    cases = [
        (bad_size, sd),
        (dict(input_size=w, channels=c, **args), {**sd, "head.weight":
                                                  sd["fc.weight"]}),
        (dict(input_size=w, channels=c, layer_sizes=[4],
              kernel_size=3), sd),
    ]
    for margs, state in cases:
        with pytest.raises(ValueError):
            P.cnn_state_dict_from_reference(state, P.cnn_from_model_args(
                margs))
        with pytest.raises(ValueError):
            J.cnn_variables_from_state_dict(
                state, J.cnn_from_model_args(margs), margs["input_size"], c)


# -- CCCNN --------------------------------------------------------------------

#: tests/test_torch_import_cccnn.py's configurations, and item 8's flagship
CCCNN_CASES = [
    (dict(layer_sizes=[4, 6], kernel_sizes=3), "plain"),
    (dict(layer_sizes=[4, 6], kernel_sizes=[3, 5], batch_norm=True),
     "groupnorm"),
    (dict(layer_sizes=[4], kernel_sizes=7, pool=True, padding=2), "pool"),
    (dict(layer_sizes=[3, 4], kernel_sizes=3, strides=[1, 2]), "strided"),
    (dict(layer_sizes=[4, 6], kernel_sizes=3, group=True), "grouped"),
    (dict(layer_sizes=[4, 6], kernel_sizes=3, group=True, batch_norm=True),
     "grouped_joint_norm"),
    (dict(layer_sizes=[5] * 7, kernel_sizes=[1, 33, 64, 15, 15, 15, 1],
          conv_impl="pallas"), "flagship_pallas"),
]


def ref_cccnn(margs, seed):
    """A reference-layout CCCNN state_dict for ``margs``."""
    c, w = margs["channels"], margs["input_size"]
    n = len(margs["layer_sizes"])
    ks = margs["kernel_sizes"]
    ks = [ks] * n if isinstance(ks, int) else ks
    st = margs.get("strides", 1)
    st = [st] * n if isinstance(st, int) else st
    groups = c if margs.get("group") else 1
    pad = margs.get("padding", 1)
    convs = nn.Module()
    cin, v = 1, w
    for i, (width, k, s) in enumerate(zip(margs["layer_sizes"], ks, st),
                                      start=1):
        setattr(convs, f"conv{i}", nn.Conv1d(cin * groups, width * groups,
                                             k, stride=s, padding=pad,
                                             groups=groups))
        if margs.get("batch_norm"):
            setattr(convs, f"bn{i}", nn.GroupNorm(1, width * groups))
        v = (v + 2 * pad - (k - 1) - 1) // s + 1
        v = v // 2 if margs.get("pool") else v
        cin = width
    fc = nn.Linear(c * (2 * v - 1), margs["output_size"])
    return randomise(reference_module(conv_layers=convs, fc=fc), seed)


@pytest.mark.parametrize("args", [a for a, _ in CCCNN_CASES],
                         ids=[i for _, i in CCCNN_CASES])
def test_cccnn_import(args):
    flagship = args.get("conv_impl") == "pallas"
    w, c = (256, 3) if flagship else (64, 3)
    margs = dict(input_size=w, output_size=2, channels=c, dropout_rate=0.0,
                 **args)
    sd = ref_cccnn(margs, 3)
    model = P.cccnn_from_model_args(margs)
    model.load_state_dict(P.cccnn_state_dict_from_reference(sd, model))
    assert model.fused == (not args.get("group") and not args.get(
        "batch_norm") and not args.get("pool") and not args.get("strides"))
    jm = J.cccnn_from_model_args({**margs, "activation": "silu"})
    x = x_of((2 if flagship else 4, c, w), seed=4)
    np.testing.assert_allclose(
        port_out(model, x),
        jax_out(jm, J.cccnn_variables_from_state_dict(sd, jm), x), **KW)


def test_cccnn_import_lcccnn_prefix():
    margs = dict(input_size=64, output_size=2, channels=3, dropout_rate=0.0,
                 layer_sizes=[4, 6], kernel_sizes=3)
    sd = ref_cccnn(margs, 5)
    model = P.cccnn_from_model_args(margs)
    wrapped = {f"model.{k}": v for k, v in sd.items()}
    direct = P.cccnn_state_dict_from_reference(sd, model)
    via = P.cccnn_state_dict_from_reference(wrapped, model)
    assert direct.keys() == via.keys()
    assert all(torch.equal(direct[k], via[k]) for k in direct)


def test_cccnn_import_refusals():
    base = dict(input_size=64, output_size=2, channels=3, dropout_rate=0.0,
                layer_sizes=[4, 6], kernel_sizes=3)
    sd = ref_cccnn(base, 6)
    cases = [
        ({**base, "cc_norm": True}, sd),                  # head layout
        ({**base, "batch_norm": True}, sd),               # no norms
        ({**base, "layer_sizes": [4, 8]}, sd),            # width
        ({**base, "group": True}, sd),                    # grouped width
        ({**base, "layer_sizes": [4]}, sd),               # depth
        (base, {**sd, "extra.weight": sd["fc.weight"]}),  # unknown key
    ]
    for margs, state in cases:
        with pytest.raises(ValueError):
            P.cccnn_state_dict_from_reference(
                state, P.cccnn_from_model_args(margs))
        with pytest.raises(ValueError):
            J.cccnn_variables_from_state_dict(
                state, J.cccnn_from_model_args(margs))


# -- RNN and CNNRNN -----------------------------------------------------------

RNN_CASES = [
    (dict(rnn_type="GRU", bidirectional=True), "gru-bi"),
    (dict(rnn_type="LSTM"), "lstm"),
    (dict(rnn_type="RNN", bias=False), "tanh-nobias"),
    (dict(rnn_type="GRU", share_input_weights=True, num_layers=1),
     "gru-shared"),
]


def ref_rnn(margs, seed):
    c, h = margs["channels"], margs["hidden_size"]
    bi = margs.get("bidirectional", False)
    n_in = 2 if margs.get("share_input_weights") else c
    rnn = getattr(nn, margs["rnn_type"])(
        n_in, h, margs["num_layers"], batch_first=True, bidirectional=bi,
        bias=margs.get("bias", True))
    e = h * (2 if bi else 1) * (c - 1 if margs.get("share_input_weights")
                                else 1)
    return randomise(reference_module(
        rnn=rnn, layer_norm=nn.LayerNorm(e),
        attention=nn.MultiheadAttention(e, margs["num_heads"],
                                        batch_first=True),
        fc=nn.Linear(e, margs["output_size"])), seed)


def rnn_args(**extra):
    return {**dict(input_size=24, output_size=2, channels=3, hidden_size=8,
                   num_layers=2, num_heads=2, dropout_rate=0.0), **extra}


@pytest.mark.parametrize("args", [a for a, _ in RNN_CASES],
                         ids=[i for _, i in RNN_CASES])
def test_rnn_import(args):
    margs = rnn_args(**args)
    sd = ref_rnn(margs, 7)
    model = P.rnn_from_model_args(margs)
    model.load_state_dict(P.rnn_state_dict_from_reference(sd, model))
    jm = J.rnn_from_model_args(margs)
    x = x_of((4, 3, 24), seed=8)
    np.testing.assert_allclose(
        port_out(model, x),
        jax_out(jm, J.rnn_variables_from_state_dict(sd, jm), x), **KW)


def test_rnn_import_refusals():
    margs = rnn_args(rnn_type="GRU")
    sd = ref_rnn(margs, 9)
    no_norm = {k: v for k, v in sd.items() if not k.startswith("layer_norm")}
    cases = [
        (rnn_args(rnn_type="GRU", num_layers=1), sd, ValueError),
        (rnn_args(rnn_type="GRU", num_layers=3), sd, ValueError),
        (rnn_args(rnn_type="GRU", bidirectional=True), sd, ValueError),
        (margs, {**sd, "proj.weight": sd["fc.weight"]}, ValueError),
        (margs, no_norm, KeyError),
    ]
    for args, state, err in cases:
        with pytest.raises(err):
            P.rnn_state_dict_from_reference(state,
                                            P.rnn_from_model_args(args))
        with pytest.raises(err):
            J.rnn_variables_from_state_dict(state,
                                            J.rnn_from_model_args(args))
    with pytest.raises(ValueError, match="batch_first"):
        P.rnn_from_model_args({**margs, "batch_first": False})


CNNRNN_CASES = [
    (dict(), "plain"),
    (dict(batch_norm=True, pool=True, n_rnn_layers=2), "bn-pool-2"),
]


def ref_cnnrnn(margs, seed):
    c, w = margs["channels"], margs["input_size"]
    k = margs["kernel_size"]
    v = w
    for _ in margs["layer_sizes"]:
        v = v + 2 - (k - 1)
        v = v // 2 if margs.get("pool") else v
    convs = conv_layers(c, margs["layer_sizes"],
                        [k] * len(margs["layer_sizes"]),
                        margs.get("batch_norm"), padding=1)
    h = margs["n_hidden"]
    return randomise(reference_module(
        conv_layers=convs,
        rnn=nn.GRU(v, h, margs.get("n_rnn_layers", 1), batch_first=True),
        attention=nn.MultiheadAttention(h, 2, batch_first=True),
        fc=nn.Linear(h, margs["output_size"])), seed)


@pytest.mark.parametrize("args", [a for a, _ in CNNRNN_CASES],
                         ids=[i for _, i in CNNRNN_CASES])
def test_cnnrnn_import(args):
    margs = {**dict(input_size=32, output_size=2, channels=3,
                    layer_sizes=[4, 6], kernel_size=3, n_hidden=8,
                    dropout_rate=0.0), **args}
    sd = ref_cnnrnn(margs, 10)
    model = P.cnnrnn_from_model_args(margs)
    model.load_state_dict(P.cnnrnn_state_dict_from_reference(sd, model))
    jm = J.cnnrnn_from_model_args({**margs, "activation": "silu"})
    x = x_of((4, 3, 32), seed=11)
    np.testing.assert_allclose(
        port_out(model, x),
        jax_out(jm, J.cnnrnn_variables_from_state_dict(sd, jm), x), **KW)
    wrong = {**margs, "n_rnn_layers": margs.get("n_rnn_layers", 1) + 1}
    with pytest.raises(ValueError):
        P.cnnrnn_state_dict_from_reference(sd, P.cnnrnn_from_model_args(
            wrong))
    with pytest.raises(ValueError):
        J.cnnrnn_variables_from_state_dict(sd, J.cnnrnn_from_model_args(
            wrong))
