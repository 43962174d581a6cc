"""Recurrent models: RNN (GRU/LSTM/tanh cells + attention) and the CNNRNN
hybrid (port of ``onset_fingerprinting_tpu.models.rnn``; reference:
model.py:168-440).

RNN: a recurrent stack → LayerNorm (eps 1e-5) → multi-head self-attention →
mean over time → dense head, with the optional shared-weights mode that
runs the same stack over every adjacent channel pair (model.py:255-261).
CNNRNN: a conv stack → a GRU over the feature maps (the conv channels are
the sequence, the conv length the features) → attention → dense.

The recurrences are ``nn.GRU``/``nn.LSTM``/``nn.RNN`` (cuDNN on the card),
one module per layer (both directions in one), so that dropout between
layers draws from the generator ``forward`` is given; the JAX package runs
them with ``lax.scan``.  flax's cells carry one bias per gate where torch
carries two (input and hidden side): a carried model holds the hidden-side
biases at zero, except the GRU's candidate gate, whose hidden bias sits
inside the reset product in both.  The attention's parameters live in an
``nn.MultiheadAttention`` (torch's packed ``in_proj_weight``, head-major
features, as flax's per-head ``DenseGeneral`` kernels reshape); its forward
is written out here so that its dropout draws from the same generator.

Inputs: ``RNN`` takes ``[B, C, L]`` (``permute_input``, the sequence along
L with C features) or ``[B, L, C]``; ``CNNRNN`` takes ``[B, C, L]``.
Parameters: ``rnn.{layer}``, ``layer_norm``, ``attention``, ``fc``;
CNNRNN ``convs.{i}``, ``norms.{i}``, ``rnn.{layer}``, ``attention``,
``fc``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from onset_fingerprinting_torch.models.fcnn import (
    ACTIVATIONS,
    BatchNorm,
    dropout,
)

CELLS = {"GRU": nn.GRU, "LSTM": nn.LSTM, "RNN": nn.RNN}


def attention(mha: nn.MultiheadAttention, x: torch.Tensor, rate: float,
              training: bool, generator: torch.Generator | None
              ) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention`` self-attention over ``x [B, T,
    E]`` with ``mha``'s parameters: softmax of the scaled dot products,
    dropout on the weights (training), the weighted values, the output
    projection."""
    b, t, e = x.shape
    h = mha.num_heads
    q, k, v = F.linear(x, mha.in_proj_weight, mha.in_proj_bias).chunk(3, -1)
    q, k, v = (u.reshape(b, t, h, e // h).transpose(1, 2) for u in (q, k, v))
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(e // h), dim=-1)
    w = dropout(w, rate, training, generator)
    out = (w @ v).transpose(1, 2).reshape(b, t, e)
    return mha.out_proj(out)


def _stack(cell, n_in: int, hidden: int, layers: int, bidirectional: bool):
    mods = nn.ModuleList()
    for _ in range(layers):
        mods.append(cell(n_in, hidden, batch_first=True,
                         bidirectional=bidirectional))
        n_in = hidden * (2 if bidirectional else 1)
    return mods


def _run_stack(mods, x, rate, training, generator):
    """The recurrent layers in turn, dropout between them (training)."""
    for i, mod in enumerate(mods):
        x = mod(x)[0]
        if i + 1 < len(mods):
            x = dropout(x, rate, training, generator)
    return x


class RNN(nn.Module):
    """``x → [B, output_size]``.  ``channels`` is the input's feature count
    (C; flax infers it); with ``share_input_weights`` the stack takes 2
    features (one channel pair) and its outputs for the C - 1 pairs are
    concatenated."""

    def __init__(self, channels: int, output_size: int = 2,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout_rate: float = 0.5, rnn_type: str = "GRU",
                 bidirectional: bool = False, num_heads: int = 2,
                 share_input_weights: bool = False,
                 permute_input: bool = True):
        super().__init__()
        if rnn_type not in CELLS:
            raise ValueError(f"unknown rnn_type {rnn_type!r}")
        self.rnn_type = rnn_type
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.num_heads = num_heads
        self.share_input_weights = share_input_weights
        self.permute_input = permute_input
        self.dropout_rate = dropout_rate
        self.channels = channels
        self.rnn = _stack(CELLS[rnn_type], 2 if share_input_weights
                          else channels, hidden_size, num_layers,
                          bidirectional)
        e = hidden_size * (2 if bidirectional else 1)
        if share_input_weights:
            e *= channels - 1
        self.layer_norm = nn.LayerNorm(e, eps=1e-5)
        self.attention = nn.MultiheadAttention(e, num_heads,
                                               batch_first=True)
        self.fc = nn.Linear(e, output_size)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.permute_input:
            x = x.transpose(1, 2)  # [B, L, C]
        run = lambda u: _run_stack(  # noqa: E731
            self.rnn, u, self.dropout_rate, self.training, generator)
        if self.share_input_weights:
            out = torch.cat([run(x[..., i:i + 2])
                             for i in range(x.shape[-1] - 1)], dim=-1)
        else:
            out = run(x)
        out = self.layer_norm(out)
        out = attention(self.attention, out, self.dropout_rate,
                        self.training, generator)
        return self.fc(out.mean(dim=1))


class CNNRNN(nn.Module):
    """Conv stack → GRU over feature maps → attention → dense
    (model.py:310-440 of the reference): ``x [B, channels, input_size] →
    [B, output_size]``.  As in the reference, the GRU treats the conv
    channels as the sequence and the conv length as the features."""

    def __init__(self, input_size: int, channels: int, output_size: int = 2,
                 layer_sizes: Sequence[int] = (8, 16), kernel_size: int = 3,
                 dropout_rate: float = 0.5, n_hidden: int = 64,
                 batch_norm: bool = False, pool: bool = False,
                 padding: int = 1, dilation: int = 1, groups: int = 1,
                 activation: str = "silu", num_heads: int = 2,
                 n_rnn_layers: int = 1):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.pool = pool
        self.layer_sizes = tuple(layer_sizes)
        self.batch_norm = batch_norm
        self.padding = padding
        self.dilation = dilation
        self.num_heads = num_heads
        self.n_rnn_layers = n_rnn_layers
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
        self.rnn = _stack(nn.GRU, v, n_hidden, n_rnn_layers, False)
        self.attention = nn.MultiheadAttention(n_hidden, num_heads,
                                               batch_first=True)
        self.fc = nn.Linear(n_hidden, output_size)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        for i, conv in enumerate(self.convs):
            x = act(conv(x))
            if self.norms:
                x = self.norms[i](x)
            if self.pool:
                x = F.max_pool1d(x, 2, 2)
        x = dropout(x, self.dropout_rate, self.training, generator)
        h = _run_stack(self.rnn, x, self.dropout_rate, self.training,
                       generator)  # [B, K, n_hidden]
        h = attention(self.attention, h, self.dropout_rate, self.training,
                      generator)
        return self.fc(h.mean(dim=1))
