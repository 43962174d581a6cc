"""Fused few-feature Conv1d stack: the wrapper of kernel K3.

Port of ``onset_fingerprinting_tpu.ops.pallas_conv.conv_stack_fused``: a
chain of stride-1 ``Conv1d`` layers with the same zero ``padding`` on every
layer and bias + activation after every layer (the last included),
``x [B, L] → [B, T_out, O_last]`` float32.  On the card the whole stack is
one kernel (``csrc/conv_stack.cu``) with every layer's activations in
shared memory; on the CPU it is :func:`conv_stack_reference`, an
``F.conv1d`` chain with the kernel's rounding points (inputs and weights
in ``compute_dtype``, float32 accumulation, bias and activation in
float32, activations stored in ``compute_dtype`` between layers).

Weights are PyTorch ``Conv1d`` layout ``[O, I, K]``, biases ``[O]``.
Forward only: the gradient comes with the training slice.  On the card a
stack whose two activation buffers do not fit shared memory even for one
signal per CTA (about 220 KB: e.g. 128 features at L=256 in float32)
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from onset_fingerprinting_torch.models.fcnn import ACTIVATIONS
from onset_fingerprinting_torch.ops import _cuda

_ACTIVATIONS = dict(ACTIVATIONS, linear=lambda x: x)
#: activation codes of csrc/conv_stack.cu::activate
_ACT_CODES = {"linear": 0, "relu": 1, "silu": 2, "leakyrelu": 3, "elu": 4,
              "tanh": 5, "sigmoid": 6}
MAX_LAYERS = 16


class _StackDesc(ctypes.Structure):
    # must match csrc/conv_stack.cu::StackDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_layers", "B", "L", "pad", "act", "bf16", "buf_len", "max_feat",
        "max_w", "max_o8",
    )] + [(n, ctypes.c_int * MAX_LAYERS) for n in (
        "K", "I", "O", "T_out", "w_off", "b_off",
    )]


def stack_lengths(length: int, weights, padding: int) -> list[int]:
    """Validate that the layers chain and return each layer's output
    length."""
    if weights[0].shape[1] != 1:
        raise ValueError("first layer must take a single input feature")
    outs = []
    t = length
    prev_o = 1
    for w in weights:
        o, i, k = w.shape
        if i != prev_o:
            raise ValueError("layer feature widths do not chain")
        t = t + 2 * padding - k + 1
        if t <= 0:
            raise ValueError(f"kernel {k} longer than the padded input")
        outs.append(t)
        prev_o = o
    return outs


def conv_stack_reference(x, weights, biases, padding=1, activation="silu",
                         compute_dtype=torch.bfloat16):
    """Plain version of K3: an ``F.conv1d`` + activation chain with the
    kernel's rounding points.  ``[B, L] → [B, T_out, O_last]`` float32."""
    _cuda.CONV_STACK.plain_calls += 1
    act = _ACTIVATIONS[activation]
    y = x.to(compute_dtype).to(torch.float32)[:, None, :]
    for w, b in zip(weights, biases):
        y = F.conv1d(y, w.to(compute_dtype).to(torch.float32),
                     padding=padding)
        y = act(y + b.to(torch.float32)[None, :, None])
        y = y.to(compute_dtype).to(torch.float32)
    return y.transpose(1, 2).contiguous()


def _pack(weights, biases, compute_dtype):
    """Weights rounded to ``compute_dtype``, packed per layer as
    ``[O/8, I, K, 8]`` float32 (output features padded to groups of 8),
    and the biases as float32, both flat."""
    ws, bs, w_off, b_off = [], [], [], []
    nw = nb = 0
    for w, b in zip(weights, biases):
        o, i, k = w.shape
        o8 = -(-o // 8) * 8
        wr = w.detach().to(compute_dtype).to(torch.float32)
        wr = F.pad(wr, (0, 0, 0, 0, 0, o8 - o))  # [o8, I, K]
        wr = wr.reshape(o8 // 8, 8, i, k).permute(0, 2, 3, 1).reshape(-1)
        ws.append(wr)
        bs.append(b.detach().to(torch.float32).reshape(-1))
        w_off.append(nw)
        b_off.append(nb)
        nw += wr.numel()
        nb += o
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous(), w_off, b_off


def conv_stack(x: torch.Tensor, weights, biases, padding: int = 1,
               activation: str = "silu",
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the whole stride-1 conv stack ``x [B, L] → [B, T_out, O_last]``
    float32: kernel K3 for a CUDA tensor, :func:`conv_stack_reference` for
    a CPU tensor."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if x.dim() != 2:
        raise ValueError("x must be [B, L]")
    t_outs = stack_lengths(x.shape[1], weights, padding)
    if x.device.type == "cpu":
        return conv_stack_reference(x, weights, biases, padding, activation,
                                    compute_dtype)
    if torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, *weights, *biases)
    ):
        raise RuntimeError(
            "conv_stack is forward only on the card: run it under "
            "torch.no_grad()/inference_mode (the backward comes with the "
            "training slice)"
        )
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [B, L] tensor")
    if any(v.device != x.device for v in (*weights, *biases)):
        raise ValueError("weights, biases and x must be on one device")
    if len(weights) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers")
    bsz, length = x.shape
    w_flat, b_flat, w_off, b_off = _pack(weights, biases, compute_dtype)
    d = _StackDesc(
        n_layers=len(weights), B=bsz, L=length, pad=padding,
        act=_ACT_CODES[activation], bf16=int(compute_dtype == torch.bfloat16),
        buf_len=max([length] + t_outs) + 2 * padding,
        max_feat=max([1] + [w.shape[0] for w in weights]),
        max_w=max(-(-w.shape[0] // 8) * 8 * w.shape[1] * w.shape[2]
                  for w in weights),
        max_o8=max(-(-w.shape[0] // 8) * 8 for w in weights),
    )
    for li, (w, t) in enumerate(zip(weights, t_outs)):
        d.O[li], d.I[li], d.K[li] = w.shape
        d.T_out[li] = t
        d.w_off[li] = w_off[li]
        d.b_off[li] = b_off[li]
    out = torch.empty((bsz, t_outs[-1], weights[-1].shape[0]),
                      dtype=torch.float32, device=x.device)
    _cuda.CONV_STACK.launch(
        "ofpt_conv_stack", ctypes.addressof(d), x.data_ptr(),
        w_flat.data_ptr(), b_flat.data_ptr(), out.data_ptr(), _cuda.stream(),
    )
    return out
