"""The serve setup's persistence (``realtime/setup_io``) and the reference
``model.pt`` import (``models/torch_import``'s FCNN part) against the JAX
package.

A setup saved by the port loads back to the same predictions, with its
conf; a setup directory saved the reference's way (``ml_conf.json`` + a
``model.pt`` of the reference's ``nn.Sequential`` layout, built here as
``tests/test_torch_import.py`` builds it) loads through the port's
``load_setup`` and ``load_reference_setup`` to the predictions of the JAX
package's ``load_reference_setup`` and of the torch model itself.
Tolerance: predictions within 1e-5 (float32, sums in another order);
confs and round trips exactly."""

import json

import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.models import torch_import as jti
from onset_fingerprinting_tpu.realtime import setup_io as jio
from onset_fingerprinting_torch.models import torch_import as tti
from onset_fingerprinting_torch.models.fcnn import (
    FCNN,
    FCNNBundle,
    init_module,
)
from onset_fingerprinting_torch.realtime import setup_io as tio

ACTS = {"relu": torch.nn.ReLU, "silu": torch.nn.SiLU, "elu": torch.nn.ELU,
        "tanh": torch.nn.Tanh}


def reference_mlp(input_size, hidden, activation="relu", batch_norm=True,
                  bias=True, dropout=0.0, output_size=2, seed=0):
    """The reference FCNN's layout (calibration.py:493-519 there): per
    hidden layer Linear → BatchNorm1d → act → Dropout, then a Linear, as
    ``network``; three train-mode forwards give its norms statistics."""
    torch.manual_seed(seed)
    layers, sizes = [], [input_size, *hidden]
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers.append(torch.nn.Linear(a, b, bias=bias))
        if batch_norm:
            layers.append(torch.nn.BatchNorm1d(b))
        layers.append(ACTS[activation]())
        if dropout > 0:
            layers.append(torch.nn.Dropout(dropout))
    layers.append(torch.nn.Linear(sizes[-1], output_size, bias=bias))
    net = torch.nn.Module()
    net.network = torch.nn.Sequential(*layers)
    net.forward = net.network.forward
    g = torch.Generator().manual_seed(seed)
    net.train()
    for _ in range(3):
        net(torch.randn(32, input_size, generator=g) * 3.0 + 1.0)
    return net.eval()


def write_reference_setup(path, net, model_args, sensors=None):
    conf = {"sensor_locations": sensors or [[0.9, 0.0, 0.0],
                                            [0.9, 120.0, 0.0],
                                            [0.9, 240.0, 0.0]],
            "medium": "drumhead", "c": None, "model_args": model_args}
    path.mkdir(parents=True, exist_ok=True)
    (path / "ml_conf.json").write_text(json.dumps(conf))
    torch.save(net.state_dict(), path / "model.pt")


@pytest.mark.parametrize("activation,batch_norm,bias,dropout", [
    ("relu", True, True, 0.0), ("silu", True, True, 0.1),
    ("elu", False, True, 0.0), ("tanh", False, False, 0.0)])
def test_reference_setup_loads_as_in_jax(tmp_path, activation, batch_norm,
                                         bias, dropout):
    net = reference_mlp(2, [10, 8], activation, batch_norm, bias, dropout)
    margs = {"output_size": 2, "hidden_layers": [10, 8],
             "activation": activation, "batch_norm": batch_norm,
             "bias": bias, "dropout": dropout}
    write_reference_setup(tmp_path, net, margs)
    x = np.random.default_rng(0).normal(0, 20, (9, 2)).astype(np.float32)
    with torch.no_grad():
        want = net(torch.as_tensor(x)).numpy()
    jconf, jb = jti.load_reference_setup(tmp_path)
    jwant = np.asarray(jb(x))
    np.testing.assert_allclose(jwant, want, atol=1e-5)
    for load in (tio.load_setup, tti.load_reference_setup):
        conf, tb = load(tmp_path, device="cpu")
        assert conf.keys() == jconf.keys()
        np.testing.assert_array_equal(conf["sensor_locations"],
                                      jconf["sensor_locations"])
        np.testing.assert_allclose(tb(x).numpy(), jwant, atol=1e-5)
        np.testing.assert_allclose(tb.call_np(x[3]), jb.call_np(x[3]),
                                   atol=1e-5)
    conf, _ = tio.load_setup(tmp_path, c=110.0, device="cpu")
    assert conf["c"] == 110.0


@pytest.mark.parametrize("hidden,mode", [([10, 10, 10], "arrival"),
                                         ([32, 32], "by_channel")])
def test_save_load_round_trip(tmp_path, hidden, mode):
    """save_setup → load_setup: the conf as JAX's save_setup writes it
    (the same ml_conf.json) and the model's predictions exactly."""
    net = init_module(FCNN(2, hidden_layers=hidden), 3, "cpu")
    with torch.no_grad():
        for bn in net.norms:
            bn.running_mean.normal_(0, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
    bundle = FCNNBundle(net)
    margs = {"output_size": 2, "hidden_layers": hidden, "batch_norm": True}
    sensors = [[0.9, 0.0, 0.0], [0.9, 120.0, 0.0], [0.9, 240.0, 0.0]]
    kw = dict(model_input=mode, drum_diameter=35.56,
              feasibility_tols=(1.0, 2.0))
    tio.save_setup(np.asarray(sensors), "air", 343.0, bundle, margs,
                   tmp_path / "t", **kw)
    jio.save_setup(np.asarray(sensors), "air", 343.0, None, margs,
                   tmp_path / "j", **kw)
    assert (tmp_path / "t" / "ml_conf.json").read_text() == \
        (tmp_path / "j" / "ml_conf.json").read_text()
    conf, back = tio.load_setup(tmp_path / "t", device="cpu")
    assert conf.get("model_input", "arrival") == mode
    assert conf["drum_diameter"] == 35.56
    assert conf["feasibility_tols"] == [1.0, 2.0]
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 30, (16, 2)).astype(np.float32))
    torch.testing.assert_close(back(x), bundle(x), rtol=0, atol=0)


def test_missing_model_raises(tmp_path):
    margs = {"output_size": 2, "hidden_layers": [4]}
    tio.save_setup([[0.9, 0, 0]] * 3, "air", None, None, margs, tmp_path)
    with pytest.raises(FileNotFoundError, match="model_args"):
        tio.load_setup(tmp_path, device="cpu")
    tio.save_setup([[0.9, 0, 0]] * 3, "air", None, None, None,
                   tmp_path / "none")
    conf, model = tio.load_setup(tmp_path / "none", device="cpu")
    assert model is None and conf["model_args"] is None


def test_reference_map_checks_the_architecture():
    net = reference_mlp(2, [10, 10])
    with pytest.raises(ValueError, match="Linear"):
        tti.fcnn_state_dict_from_reference(
            net.state_dict(), FCNN(2, hidden_layers=(10,)))
    with pytest.raises(ValueError, match="bias"):
        tti.fcnn_state_dict_from_reference(
            net.state_dict(), FCNN(2, hidden_layers=(10, 10), bias=False))
    assert tti.fcnn_from_model_args(
        {"activation": torch.nn.SiLU, "hidden_layers": [5]}, 2
    ).activation == "silu"
    with pytest.raises(ValueError, match="unsupported activation"):
        tti.fcnn_from_model_args({"activation": "gelu-ish"}, 2)
    with pytest.raises(TypeError):
        tti.fcnn_from_model_args({"hidden_layer": [5]}, 2)
