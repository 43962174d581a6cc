"""The CCCNN's bf16 DFT head as one kernel: K3's feature maps in, the dense
layer's outputs out (``csrc/cccnn_head.cu``, counter ``_cuda.CCCNN_HEAD``).

The head of a ``cc_impl="dft"``, ``cc_norm=True`` CCCNN without a pair head
(``models/cccnn.py``): the self cross-correlation of every feature map by
DFT, summed over the maps on the power spectrum, normalised by its lag 0
(the divide and the log of ``cc_norm``), through ``fc``.  At the JAX
package's ``"default"`` precision (``ops/xcorr.py``) it rounds features,
DFT matrices and the power spectrum to bf16 and sums in f32; the kernel
rounds at those points and nowhere else, so only the order of its sums
differs from the chain of GEMMs and elementwise passes it replaces.

- :func:`head_plan` is the rule on shapes: the kernel serves a head whose
  inverse matrix, one tile's features and ``fc`` fit a CTA's shared memory
  (V <= 136: the 256-sample windows of the fleet and the drum, not the
  realtime classifier's 512) with up to 16 channels, 8 maps and 8 outputs;
  ``CCCNN.head_on_kernel`` adds what else it observes.
- :func:`self_cc_head` launches the kernel on the card and runs
  :func:`self_cc_head_reference`, its plain version, on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.xcorr import _dft_matrices, _dft_tensors

# must match csrc/cccnn_head.cu
F_WARPS = 6
X_WARPS = 6
THREADS = 32 * (F_WARPS + X_WARPS)
ROWS = 16
PITCH = 152
PLANE = ROWS * PITCH + 8
MAX_KS = 9
MAX_FJ = 3
MAX_LJ = 6
MAX_OUT = 8
MAX_K = 8
#: a CTA's largest dynamic shared memory on the H100 (227 KB)
SMEM_MAX = 232448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class HeadPlan(NamedTuple):
    """The kernel's sizes for one shape (``csrc/cccnn_head.cu``)."""

    ks: int          # forward k steps: ceil(V / 16)
    n_fwd: int       # forward n tiles: ceil(F / 8)
    n_lag: int       # lag n tiles: ceil((2V - 1) / 8)
    per_tile: int    # windows per tile of 16 signals
    raw_floats: int  # shared floats for one tile's features
    w_floats: int    # shared floats for fc's weight and bias, and zeros
    smem: int        # shared bytes of a CTA


def head_plan(c: int, k: int, v: int, o: int) -> HeadPlan | None:
    """The kernel's plan for ``c`` channels of ``k`` maps of ``v`` samples
    into ``o`` outputs, or None where it does not serve that shape."""
    f = _cdiv(2 * v - 1, 16) * 8 + 1
    ks, n_fwd, n_lag = _cdiv(v, 16), _cdiv(f, 8), _cdiv(2 * v - 1, 8)
    if not (1 <= c <= ROWS and 1 <= o <= MAX_OUT and 1 <= k <= MAX_K
            and v >= 1 and ks <= MAX_KS
            and n_fwd <= F_WARPS * MAX_FJ and n_lag <= F_WARPS * MAX_LJ):
        return None
    per_tile = ROWS // c
    raw_floats = 4 * _cdiv(per_tile * c * v * k * 4 + 12, 16)
    # fc.weight, the bias, and zeros for the columns past the last lag
    w_floats = 4 * _cdiv(o * (c * (2 * v - 1) + c + 1) + 8, 4)
    # the inverse (every warp's lag tiles), two plane sets, the power, one
    # tile's features, fc, the warps' partials, lag 0
    smem = (8 * F_WARPS * MAX_LJ * PITCH * 2 + 2 * k * PLANE * 2
            + ROWS * PITCH * 2 + raw_floats * 4 + w_floats * 4
            + F_WARPS * ROWS * MAX_OUT * 4 + ROWS * 4)
    if smem > SMEM_MAX:
        return None
    return HeadPlan(ks, n_fwd, n_lag, per_tile, raw_floats, w_floats, smem)


def _bf16_bits(m: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (ties to even), as uint32 bit
    patterns in the low half."""
    t = torch.from_numpy(np.ascontiguousarray(m, np.float32))
    bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits.astype(np.uint32)


def forward_fragments(v: int) -> np.ndarray:
    """The forward DFT matrices as each lane's mma B fragments: ``[n_fwd,
    ks, 32, 4]`` uint32, for n tile j, k step s and lane (g = lane / 4, t =
    lane % 4) the bf16 pairs (cos[r, 8j + g], cos[r + 1, 8j + g]) at r = 16s
    + 2t and r = 16s + 2t + 8, then the same of -sin; low half first, zero
    past V and past F."""
    re_m, im_m, _ = _dft_matrices(v)
    f = re_m.shape[1]
    ks, nf = _cdiv(v, 16), _cdiv(f, 8)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    col = 8 * np.arange(nf)[:, None, None] + g        # [nf, 1, 32]
    row = 16 * np.arange(ks)[None, :, None] + 2 * t   # [1, ks, 32]
    words = []
    for m in (re_m, im_m):
        b = np.zeros((ks * 16, nf * 8), np.uint32)
        b[:v, :f] = _bf16_bits(m)
        for r in (row, row + 8):
            words.append(b[r, col] | (b[r + 1, col] << 16))
    return np.stack(words, axis=-1)


def inverse_rows(v: int) -> np.ndarray:
    """The inverse matrix transposed, ``[8 n_lag, PITCH]`` bf16 bit
    patterns (uint16): row j holds lag column j of ``_dft_matrices``'
    inverse over the frequencies, zero past 2V - 1 and past F."""
    _, _, inv = _dft_matrices(v)
    f, n = inv.shape
    out = np.zeros((8 * _cdiv(n, 8), PITCH), np.uint16)
    out[:n, :f] = _bf16_bits(inv.T).astype(np.uint16)
    return out


@functools.lru_cache(maxsize=8)
def _head_tensors(v: int, device: torch.device):
    """``(forward fragments, inverse rows)`` on ``device``, made once."""
    with torch.inference_mode(False):
        fwd = torch.from_numpy(forward_fragments(v).view(np.int32))
        inv = torch.from_numpy(inverse_rows(v).view(np.int16))
        return fwd.to(device), inv.to(device)


class _HeadDesc(ctypes.Structure):
    # must match csrc/cccnn_head.cu::HeadDesc field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "C", "K", "V", "O", "ks", "n_fwd", "n_lag",
        "per_tile", "n_tiles", "sv", "sk", "raw_floats", "w_floats",
    )]


def self_cc_head_reference(feats: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``feats [B, C, K, V]`` → ``[B, O]``
    float32, rounding where the kernel rounds (features, DFT matrices and
    power spectrum to bf16; every product and sum in f32), summing the maps
    in order."""
    b, _, k, v = feats.shape
    re_m, im_m, inv, _ = _dft_tensors(v, feats.device)
    bf, f32 = torch.bfloat16, torch.float32
    x = feats.to(bf).to(f32)
    re = torch.matmul(x, re_m.to(bf).to(f32))
    im = torch.matmul(x, im_m.to(bf).to(f32))
    p = re * re + im * im  # [B, C, K, F]
    power = p[:, :, 0]
    for i in range(1, k):
        power = power + p[:, :, i]
    cc = torch.matmul(power.to(bf).to(f32), inv.to(bf).to(f32))
    lag0 = cc[..., v - 1: v] + 1e-6
    probs = torch.cat([(cc / lag0).reshape(b, -1),
                       torch.log(lag0).reshape(b, -1)], dim=-1)
    return F.linear(probs, weight, bias)


def _layout(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """``(x, sv, sk)``: features whose every signal is one contiguous block
    of V * K floats, and the strides of v and k inside it (K3's ``[B*C, V,
    K]`` seen as ``[B, C, K, V]``, or a contiguous ``[B, C, K, V]``)."""
    b, c, k, v = x.shape
    if x.stride() == (c * v * k, v * k, 1, k):
        return x, k, 1
    return x.contiguous(), 1, v


def self_cc_head(feats: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The head from ``feats [B, C, K, V]`` (float32 or bf16 values) to
    ``[B, O]`` float32 with ``fc``'s ``weight [O, C (2V-1) + C]`` and
    ``bias [O]`` (float32): the kernel on the card, raising for a shape
    :func:`head_plan` does not serve; the plain version on the CPU."""
    if feats.device.type == "cpu":
        _cuda.CCCNN_HEAD.plain_calls += 1
        return self_cc_head_reference(feats, weight, bias)
    b, c, k, v = feats.shape
    o = weight.shape[0]
    plan = head_plan(c, k, v, o)
    if plan is None:
        raise ValueError(f"the head kernel does not serve C={c}, K={k}, "
                         f"V={v}, {o} outputs")
    if tuple(weight.shape) != (o, c * (2 * v - 1) + c) or tuple(
            bias.shape) != (o,):
        raise ValueError(f"fc's weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} do not take {c} channels of "
                         f"{2 * v - 1} lags")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("the head kernel takes a float32 fc")
    x, sv, sk = _layout(feats.to(torch.float32))
    if x.data_ptr() % 16:
        raise ValueError("the head kernel reads features 16-byte aligned")
    w = weight.detach().contiguous()
    bs = bias.detach().contiguous()
    fwd, inv = _head_tensors(v, feats.device)
    out = torch.empty((b, o), dtype=torch.float32, device=feats.device)
    d = _HeadDesc(B=b, C=c, K=k, V=v, O=o, ks=plan.ks, n_fwd=plan.n_fwd,
                  n_lag=plan.n_lag, per_tile=plan.per_tile,
                  n_tiles=_cdiv(b, plan.per_tile), sv=sv, sk=sk,
                  raw_floats=plan.raw_floats, w_floats=plan.w_floats)
    _cuda.CCCNN_HEAD.launch(
        "ofpt_cccnn_head", ctypes.addressof(d), x.data_ptr(),
        fwd.data_ptr(), inv.data_ptr(), w.data_ptr(), bs.data_ptr(),
        out.data_ptr(), _cuda.stream())
    return out
