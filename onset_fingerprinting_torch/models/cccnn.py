"""CCCNN: the learned-cross-correlation fingerprint model (port of
``onset_fingerprinting_tpu.models.cccnn.CCCNN``, shared-weights form).

Per channel, a stride-1 conv stack (``ops/conv_stack.py``: kernel K3 on the
card) maps a window to K feature maps; the self cross-correlation of every
map, summed over maps, goes through a normalised (``cc_norm``) or softmax
head into one dense layer that predicts the hit coordinates (reference:
model.py:443-629).

Not ported yet (raise ``NotImplementedError``; see ROADMAP.md Queue 1):
``group=True`` (per-channel weights), ``batch_norm``, ``pool``,
``cc_pairs`` and ``paired_xcorr``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from onset_fingerprinting_torch.ops.conv_stack import (
    _ACTIVATIONS,
    conv_stack,
    stack_lengths,
)
from onset_fingerprinting_torch.ops.xcorr import (
    batch_full_correlate,
    batch_self_correlate_dft,
)


def paired_xcorr(x: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """Adjacent-channel-pair CC of feature maps (cccnn.py:32-43)."""
    raise NotImplementedError(
        "paired_xcorr is not ported yet (ROADMAP.md Queue 1, item 5)"
    )


class CCCNN(nn.Module):
    """``x [B, C, L]`` onset windows → ``[B, output_size]``.

    ``input_size`` is the window length L (flax infers it at init; a torch
    module sizes its dense layer up front).  ``dtype`` is the conv stack's
    compute dtype; the correlation head and the dense layer run in float32.
    Parameters: ``convs.{i}.weight [O, I, K]``/``bias``, ``fc.weight
    [out, in]``/``bias``.
    """

    def __init__(
        self,
        input_size: int,
        output_size: int = 2,
        channels: int = 3,
        layer_sizes: Sequence[int] = (8, 16),
        kernel_sizes: Sequence[int] | int = 3,
        strides: Sequence[int] | int = 1,
        dropout_rate: float = 0.5,
        batch_norm: bool = False,
        pool: bool = False,
        padding: int = 1,
        dilation: int = 1,
        group: bool = False,
        activation: str = "silu",
        dtype: torch.dtype = torch.float32,
        cc_impl: str = "fft",
        cc_norm: bool = False,
        cc_pairs: str | None = None,
    ):
        super().__init__()
        if cc_impl not in ("fft", "dft"):
            raise ValueError(f"cc_impl must be 'fft' or 'dft', got {cc_impl!r}")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        n = len(layer_sizes)
        ks = [kernel_sizes] * n if isinstance(kernel_sizes, int) else list(
            kernel_sizes)
        st = [strides] * n if isinstance(strides, int) else list(strides)
        for name, on in (("group=True", group), ("batch_norm", batch_norm),
                         ("pool", pool), ("cc_pairs", cc_pairs is not None),
                         ("strides != 1", any(s != 1 for s in st)),
                         ("dilation != 1", dilation != 1)):
            if on:
                raise NotImplementedError(
                    f"CCCNN {name} is not ported yet (ROADMAP.md Queue 1, "
                    "item 5)"
                )
        self.channels = channels
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        self.cc_impl = cc_impl
        self.cc_norm = cc_norm
        self.convs = nn.ModuleList()
        cin = 1
        for width, k in zip(layer_sizes, ks):
            self.convs.append(nn.Conv1d(cin, width, k, padding=padding))
            cin = width
        v = stack_lengths(
            input_size, [c.weight for c in self.convs], padding
        )[-1]
        dense_in = channels * (2 * v - 1) + (channels if cc_norm else 0)
        self.dropout = nn.Dropout(dropout_rate)
        self.fc = nn.Linear(dense_in, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, length = x.shape
        # shared weights: fold the channels into the batch (cccnn.py:455-458)
        feats = conv_stack(
            x.reshape(b * c, length).contiguous(),
            [m.weight for m in self.convs],
            [m.bias for m in self.convs],
            padding=self.padding,
            activation=self.activation,
            compute_dtype=self.dtype,
        )  # [B*C, V, K]
        feats = feats.reshape(b, c, *feats.shape[1:]).transpose(2, 3)
        feats = feats.to(torch.float32)  # [B, C, K, V]
        if self.cc_impl == "dft":
            cc = batch_self_correlate_dft(feats, sum_axis=2)  # [B, C, 2V-1]
        else:
            cc = batch_full_correlate(feats, feats).sum(dim=2)
        v = feats.shape[-1]
        if self.cc_norm:
            lag0 = cc[..., v - 1: v] + 1e-6
            probs = torch.cat(
                [(cc / lag0).reshape(b, -1), torch.log(lag0).reshape(b, -1)],
                dim=-1,
            )
        else:
            probs = torch.softmax(cc, dim=-1).reshape(b, -1)
        return self.fc(self.dropout(probs))
