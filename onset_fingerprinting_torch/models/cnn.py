"""CNN regression/classification model for onset windows (port of
``onset_fingerprinting_tpu.models.cnn``, JAX cnn.py:19-55): a Conv1d stack
(each layer conv → activation → optional BatchNorm → optional max-pool),
dropout and one dense layer.  The realtime demo's zone classifier.

Inputs are ``[B, C, L]`` (channels = sensors).  The dense layer reads the
features flattened in flax's ``[B, L, C]`` order, so that a flax kernel
carries over as its transpose.  ``dtype`` is the compute dtype of the convs
and the dense layer (parameters stay float32); the output is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from onset_fingerprinting_torch.models.fcnn import (
    ACTIVATIONS,
    BatchNorm,
    dropout,
)


class CNN(nn.Module):
    """``x [B, channels, input_size] → [B, output_size]``.  Parameters
    ``convs.{i}`` (``[O, I/groups, K]``), ``norms.{i}`` (flax BatchNorm)
    and ``fc``.  ``forward(x, generator)`` draws dropout masks from
    ``generator`` in training."""

    def __init__(self, input_size: int, channels: int, output_size: int = 2,
                 layer_sizes: Sequence[int] = (8, 16), kernel_size: int = 3,
                 dropout_rate: float = 0.5, batch_norm: bool = False,
                 pool: bool = False, padding: int = 1, dilation: int = 1,
                 groups: int = 1, activation: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.pool = pool
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        cin, v = channels, input_size
        for width in layer_sizes:
            self.convs.append(nn.Conv1d(cin, width, kernel_size,
                                        padding=padding, dilation=dilation,
                                        groups=groups))
            if batch_norm:
                self.norms.append(BatchNorm(width))
            v = v + 2 * padding - dilation * (kernel_size - 1)
            if pool:
                v //= 2
            if v <= 0:
                raise ValueError(
                    f"the conv stack leaves no samples of {input_size}")
            cin = width
        self.fc = nn.Linear(cin * v, output_size)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        dt = self.dtype
        for i, conv in enumerate(self.convs):
            x = act(F.conv1d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                             1, conv.padding, conv.dilation, conv.groups))
            if self.norms:
                x = self.norms[i](x)
            if self.pool:
                x = F.max_pool1d(x, 2, 2)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # flax's [B, L, C]
        x = dropout(x, self.dropout_rate, self.training, generator)
        out = F.linear(x.to(dt), self.fc.weight.to(dt), self.fc.bias.to(dt))
        return out.to(torch.float32)
