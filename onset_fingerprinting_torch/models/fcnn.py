"""Activation registry shared by the model families (port of
``onset_fingerprinting_tpu.models.fcnn.ACTIVATIONS``; the FCNN itself comes
with the training slice)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "silu": F.silu,
    # flax.linen.leaky_relu's default slope
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
