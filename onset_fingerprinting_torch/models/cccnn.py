"""CCCNN: the learned-cross-correlation fingerprint model (port of
``onset_fingerprinting_tpu.models.cccnn``).

Per channel, a conv stack maps a window to K feature maps; the self
cross-correlation of every map, summed over maps, goes through a normalised
(``cc_norm``) or softmax head, optionally followed by the cross-correlation
of channel pairs (``cc_pairs``), into one dense layer that predicts the hit
coordinates (reference: model.py:443-629).

The conv stack takes one of two routes, on the card and on the CPU alike:

- a stack that kernel K3 runs (shared weights, stride 1, dilation 1, no
  norm, no pool) goes through :func:`~onset_fingerprinting_torch.ops.
  conv_stack.conv_stack`;
- any other stack (``group=True``, ``batch_norm``, ``pool``, strides or
  dilation ≠ 1) is an ``F.conv1d`` chain, as the JAX package runs such
  stacks through XLA's conv and never through its Pallas kernel.

Both routes train: K3 is differentiable (its backward differentiates the
plain chain, as the JAX package's custom VJP does).  ``model.train()`` /
``model.eval()`` stand for flax's ``train=``; dropout draws its masks from
the generator ``forward`` is given.

``conv_impl`` ('conv', 'mxu', 'pallas') and ``conv_u_block`` are accepted
and validated as the JAX package does, so that a JAX configuration carries
over unchanged; they do not change the route.  ``Conv1dMXU`` (the TPU's
Toeplitz-matmul layout of the same convolution) has no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from onset_fingerprinting_torch.models.fcnn import dropout
# the module, not its names: ops/conv_stack imports models.fcnn, so a first
# import of ops.conv_stack reaches this line while it is half initialised
from onset_fingerprinting_torch.ops import conv_stack as _conv_stack
from onset_fingerprinting_torch.ops.cccnn_head import head_plan, self_cc_head
from onset_fingerprinting_torch.ops.xcorr import (
    batch_full_correlate,
    self_and_pair_correlate_dft,
    self_cc_from_power,
    self_power_dft,
)
from onset_fingerprinting_torch.utils.metrics import count, trace


def paired_xcorr(x: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """Cross-correlate every adjacent channel pair of each feature map
    (cccnn.py:32-43).

    :param x: ``[B, C*K, V]`` feature maps
    :returns: ``[B, C-1, 2V-1]``, the full CC per adjacent pair, mean over
        the K maps.
    """
    b, ck, v = x.shape
    if ck != C * K:
        raise ValueError(f"x has {ck} maps, not C*K = {C * K}")
    x = x.reshape(b, C, K, v)
    return batch_full_correlate(x[:, :-1], x[:, 1:]).mean(dim=2)


def _channel_pairs(cc_pairs: str | None, c: int):
    if cc_pairs == "adjacent":
        return [(i, i + 1) for i in range(c - 1)]
    if cc_pairs == "all":
        return [(i, j) for i in range(c) for j in range(i + 1, c)]
    if cc_pairs is None:
        return None
    raise ValueError(
        f"cc_pairs must be None, 'adjacent' or 'all', got {cc_pairs!r}"
    )


class CCCNN(nn.Module):
    """``x [B, C, L]`` onset windows → ``[B, output_size]``.

    ``input_size`` is the window length L (flax infers it at init; a torch
    module sizes its dense layer up front).  ``dtype`` is the conv stack's
    compute dtype; the correlation head and the dense layer run in float32.
    Parameters: ``convs.{i}.weight [O, I/groups, K]``/``bias``,
    ``norms.{i}.weight``/``bias`` with ``batch_norm``, ``fc.weight [out,
    in]``/``bias``.  With ``group=True`` layer i has ``width·C`` output
    features in channel-major order (channel ch's maps at ``[ch·width,
    (ch+1)·width)``).
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
        cc_pair_lags: int | None = None,
        conv_impl: str = "conv",
        conv_u_block: int | None = None,
    ):
        super().__init__()
        if cc_impl not in ("fft", "dft"):
            raise ValueError(f"cc_impl must be 'fft' or 'dft', got {cc_impl!r}")
        if conv_impl not in ("conv", "mxu", "pallas"):
            raise ValueError("conv_impl must be 'conv', 'mxu' or 'pallas', "
                             f"got {conv_impl!r}")
        if activation not in _conv_stack._ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        n = len(layer_sizes)
        ks = [kernel_sizes] * n if isinstance(kernel_sizes, int) else list(
            kernel_sizes)
        st = [strides] * n if isinstance(strides, int) else list(strides)
        plain_steps = dilation == 1 and all(s == 1 for s in st)
        # the JAX package's validation (cccnn.py:423-428, 230-237, 269-274)
        if group and conv_impl != "conv":
            raise ValueError(
                f"conv_impl={conv_impl!r} requires group=False (the flagship "
                "shared-weights configuration); grouped convs use "
                "conv_impl='conv'"
            )
        if conv_impl != "conv" and not plain_steps:
            raise ValueError(
                f"conv_impl={conv_impl!r} supports stride=1, dilation=1 only")
        if conv_impl == "pallas" and (batch_norm or pool):
            raise ValueError(
                "conv_impl='pallas' does not support batch_norm/pool")
        self.pairs = _channel_pairs(cc_pairs, channels)
        groups = channels if group else 1
        self.channels = channels
        self.groups = groups
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        self.cc_impl = cc_impl
        self.cc_norm = cc_norm
        self.pool = pool
        self.cc_pair_lags = cc_pair_lags
        # K3 runs a shared-weights, stride-1 stack with nothing between
        # the layers but the activation
        self.fused = groups == 1 and plain_steps and not (batch_norm or pool)
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        cin, v = 1, input_size
        for width, k, s in zip(layer_sizes, ks, st):
            self.convs.append(nn.Conv1d(
                cin * groups, width * groups, k, stride=s, padding=padding,
                dilation=dilation, groups=groups))
            if batch_norm:
                self.norms.append(nn.GroupNorm(1, width * groups, eps=1e-5))
            v = (v + 2 * padding - dilation * (k - 1) - 1) // s + 1
            if pool:
                v //= 2
            if v <= 0:
                raise ValueError(
                    f"the conv stack leaves no samples of {input_size}")
            cin = width
        dense_in = channels * (2 * v - 1) + (channels if cc_norm else 0)
        if self.pairs is not None:
            if cc_pair_lags is not None and cc_pair_lags >= v:
                raise ValueError(
                    f"cc_pair_lags={cc_pair_lags} exceeds the feature-map "
                    f"length {v} - 1"
                )
            pair_len = 2 * v - 1 if cc_pair_lags is None else (
                2 * cc_pair_lags + 1)
            dense_in += len(self.pairs) * pair_len
            self.register_buffer(
                "pair_i", torch.tensor([i for i, _ in self.pairs]),
                persistent=False)
            self.register_buffer(
                "pair_j", torch.tensor([j for _, j in self.pairs]),
                persistent=False)
        self.dropout_rate = dropout_rate
        self.fc = nn.Linear(dense_in, output_size)

    def fused_features(self, x: torch.Tensor) -> torch.Tensor:
        """The conv stack through K3 (``fused`` stacks only): ``x [B, C, L]
        → [B, C, K, V]``."""
        b, c, length = x.shape
        # shared weights: fold the channels into the batch (cccnn.py:455-458)
        feats = _conv_stack.conv_stack(
            x.reshape(b * c, length).contiguous(),
            [m.weight for m in self.convs],
            [m.bias for m in self.convs],
            padding=self.padding,
            activation=self.activation,
            compute_dtype=self.dtype,
        )  # [B*C, V, K]
        return feats.reshape(b, c, *feats.shape[1:]).transpose(2, 3)

    def chain_features(self, x: torch.Tensor) -> torch.Tensor:
        """The conv stack as an ``F.conv1d`` chain in ``dtype`` (GroupNorm
        in float32): ``x [B, C, L] → [B, C, K, V]``.  Runs any stack."""
        b, c, length = x.shape
        act = _conv_stack._ACTIVATIONS[self.activation]
        y = x if self.groups > 1 else x.reshape(b * c, 1, length)
        for i, conv in enumerate(self.convs):
            y = F.conv1d(
                y.to(self.dtype), conv.weight.to(self.dtype),
                conv.bias.to(self.dtype), conv.stride, conv.padding,
                conv.dilation, conv.groups,
            )
            y = act(y)
            if self.norms:
                y = self.norms[i](y.to(torch.float32))
            if self.pool:
                y = F.max_pool1d(y, 2, 2)
        # grouped: [B, C*K, V] channel-major; shared: [B*C, K, V]
        return y.reshape(b, c, -1, y.shape[-1])

    def head_on_kernel(self, feats: torch.Tensor) -> bool:
        """Whether :meth:`forward` runs its head on the head kernel
        (``ops/cccnn_head.py``), from what it observes: the bf16 DFT head
        with ``cc_norm`` and no pair head, a float32 ``fc``, features on the
        card, no dropout (not training), no gradient needed, and a shape
        the kernel serves (``head_plan``).  Else the chain of products and
        elementwise passes below."""
        fc = self.fc
        _, c, k, v = feats.shape
        return (self.cc_impl == "dft" and self.dtype == torch.bfloat16
                and self.cc_norm and self.pairs is None
                and not self.training and feats.device.type == "cuda"
                and fc.weight.dtype == fc.bias.dtype == torch.float32
                and not (torch.is_grad_enabled() and (
                    feats.requires_grad or fc.weight.requires_grad
                    or fc.bias.requires_grad))
                and head_plan(c, k, v, fc.weight.shape[0]) is not None)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``model.train()`` as flax's ``train=True``: dropout on the
        head's input, its masks drawn from ``generator``.  Spans
        ``cccnn.features`` (the conv stack) and ``cccnn.head`` (the
        correlation, its normalisation and the dense layer); inside the
        head's chain ``cccnn.head_spectrum`` (the DFT head's forward
        products, power and sum over maps), ``cccnn.head_inverse`` (its
        inverse product) and ``cccnn.head_dense`` (the normalisation and
        the dense layer).  The counter ``model_rows`` counts the rows of
        ``x``, ``head_kernel_rows`` those whose head ran on the head
        kernel."""
        b = x.shape[0]
        count("model_rows", b)
        with trace("cccnn.features"):
            feats = (self.fused_features(x) if self.fused
                     else self.chain_features(x))  # [B, C, K, V]
        with trace("cccnn.head"):
            if self.head_on_kernel(feats):
                count("head_kernel_rows", b)
                return self_cc_head(feats, self.fc.weight, self.fc.bias)
            # as the JAX package chooses (cccnn.py:479-497 there): a bf16
            # model's features carry bf16 error already, so its head runs
            # one bf16 pass accumulating in f32; other models run full f32,
            # their products and dense layer held there whatever the
            # process's TF32 settings
            if self.dtype == torch.bfloat16:
                return self.chain_head(feats, "default", generator)
            with _conv_stack.exact_f32_matmul():
                return self.chain_head(feats, "highest", generator)

    def chain_head(self, feats: torch.Tensor, prec: str,
                   generator: torch.Generator | None) -> torch.Tensor:
        """The head as products and elementwise passes: ``feats [B, C, K,
        V]`` → ``[B, output_size]``, the DFT's products at ``prec``."""
        b, v = feats.shape[0], feats.shape[-1]
        # the DFT takes the features as they are: rounding a bf16 model's
        # to bf16 again is exact
        if self.cc_impl == "dft" and self.pairs is not None:
            cc, pcc = self_and_pair_correlate_dft(
                feats, self.pair_i, self.pair_j, precision=prec)
        elif self.cc_impl == "dft":
            # sum over the K maps on the power spectrum (linear: the same
            # values with K-fold less inverse work)
            with trace("cccnn.head_spectrum"):
                power = self_power_dft(feats, sum_axis=2, precision=prec)
            with trace("cccnn.head_inverse"):
                cc = self_cc_from_power(power, v, prec)
        else:
            feats = feats.to(torch.float32)
            # [B, C, 2V-1]
            cc = batch_full_correlate(feats, feats).sum(dim=2)
            if self.pairs is not None:
                # [B, P, K, 2V-1] summed over maps; lag index v-1-d peaks
                # when channel pi leads pj by d samples
                pcc = batch_full_correlate(feats[:, self.pair_i],
                                           feats[:, self.pair_j]).sum(dim=2)
        with trace("cccnn.head_dense"):
            if self.cc_norm:
                lag0 = cc[..., v - 1: v] + 1e-6
                probs = torch.cat(
                    [(cc / lag0).reshape(b, -1),
                     torch.log(lag0).reshape(b, -1)],
                    dim=-1,
                )
            else:
                probs = torch.softmax(cc, dim=-1).reshape(b, -1)
            if self.pairs is not None:
                pi, pj = self.pair_i, self.pair_j
                if self.cc_pair_lags is not None:
                    lo = v - 1 - self.cc_pair_lags
                    pcc = pcc[..., lo: lo + 2 * self.cc_pair_lags + 1]
                # normalised by the pair's geometric-mean lag-0 energy
                lag0c = cc[..., v - 1] + 1e-6  # [B, C]
                norm = torch.sqrt(lag0c[:, pi] * lag0c[:, pj])[..., None]
                probs = torch.cat([probs, (pcc / norm).reshape(b, -1)],
                                  dim=-1)
            return self.fc(dropout(probs, self.dropout_rate, self.training,
                                   generator))
