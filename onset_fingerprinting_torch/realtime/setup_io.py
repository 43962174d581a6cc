"""Serve-setup persistence: sensor geometry and the location model (port of
``onset_fingerprinting_tpu.realtime.setup_io``; reference:
realtime/config.py:63-108).

``ml_conf.json`` holds the sensor locations, the medium, the speed of
sound, the model's constructor arguments and, where they differ from the
defaults, the model's input representation, the head's diameter and the
locator's feasibility tiers.  The model is ``torch.save`` of the FCNN's
``state_dict`` (``fcnn_state.pt``), where the JAX package writes an orbax
checkpoint.  A setup directory saved by the reference (``model.pt``, its
torch layout) loads through ``models.torch_import.load_reference_setup``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.fcnn import FCNNBundle

#: the port's checkpoint of the FCNN (``state_dict``)
MODEL_FILE = "fcnn_state.pt"


def read_conf(path: str | Path, json_name: str = "ml_conf.json",
              c: Optional[float] = None) -> dict:
    """Parse a setup's ``ml_conf.json`` (shared by both load paths, so the
    contract cannot drift).  ``c`` overrides the speed of sound."""
    conf = json.loads((Path(path) / json_name).read_text())
    conf["sensor_locations"] = np.asarray(conf["sensor_locations"])
    if c is not None:
        conf["c"] = c
    return conf


def save_setup(sensor_locations, medium: str, c: Optional[float],
               model: Optional[FCNNBundle], model_args: Optional[dict],
               path: str | Path, json_name: str = "ml_conf.json",
               model_input: str = "arrival",
               drum_diameter: Optional[float] = None,
               feasibility_tols: Optional[tuple] = None) -> None:
    """Write a setup directory.  ``model_input`` records the lag
    representation the model was trained on (``locate.
    make_locate_update``), ``drum_diameter`` (cm) the head size its
    targets were scaled to, from which the serve locator builds its
    legality maps."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if isinstance(sensor_locations, np.ndarray):
        sensor_locations = sensor_locations.tolist()
    conf = {"sensor_locations": sensor_locations, "medium": medium, "c": c,
            "model_args": model_args}
    if model_input != "arrival":
        conf["model_input"] = model_input
    if drum_diameter is not None:
        conf["drum_diameter"] = drum_diameter
    if feasibility_tols is not None:
        # the locator's completion-feasibility tiers (cm)
        conf["feasibility_tols"] = [float(t) for t in feasibility_tols]
    (path / json_name).write_text(json.dumps(conf, indent=2))
    if model is not None:
        torch.save({k: v.detach().cpu()
                    for k, v in model.model.state_dict().items()},
                   path / MODEL_FILE)


def load_setup(path: str | Path, json_name: str = "ml_conf.json",
               c: Optional[float] = None, device=None):
    """``(conf dict, FCNNBundle or None)``, the model on ``device`` (None =
    the card).  Reads setups :func:`save_setup` wrote and, where there is
    ``model.pt`` and no port checkpoint, setups the reference wrote."""
    from onset_fingerprinting_torch.models.torch_import import (
        fcnn_from_model_args,
        load_reference_setup,
    )

    path = Path(path)
    if not (path / MODEL_FILE).exists() and (path / "model.pt").exists():
        return load_reference_setup(path, json_name=json_name, c=c,
                                    device=device)
    conf = read_conf(path, json_name=json_name, c=c)
    model = None
    if conf.get("model_args"):
        if not (path / MODEL_FILE).exists():
            # silently serving Newton trilateration would drop the
            # calibrated model with no sign of it
            raise FileNotFoundError(
                f"setup {path} has model_args but neither {MODEL_FILE} "
                "(this package) nor model.pt (reference) exists")
        fcnn = fcnn_from_model_args(conf["model_args"],
                                    len(conf["sensor_locations"]) - 1)
        fcnn.load_state_dict(torch.load(path / MODEL_FILE,
                                        map_location="cpu",
                                        weights_only=True))
        model = FCNNBundle(fcnn.to(resolve_device(device)))
    return conf, model
