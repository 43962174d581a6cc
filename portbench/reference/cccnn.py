"""The CCCNN forward (the reference repository's ``model.py`` LCCCNN:
shared-weight conv stack per channel, self cross-correlation of every
feature map summed over maps, normalised by lag 0, one dense layer), in
plain PyTorch on the CPU in float32, with no TF32 anywhere.

``fp8=True`` is the lower-precision control: the conv stack's input,
weights and every layer's output are rounded to float8 e4m3 with a
per-tensor scale (amax to 448); the correlation is taken as the
configuration's ``cc_impl="dft"`` states, by a real DFT whose operands
(the features, both bases and the power spectrum) are rounded to float8
and whose sums run in float32; the dense layer's input and weights are
rounded to bfloat16.  In float32 the DFT and the direct sums agree to
rounding; the reference takes the direct sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def self_correlation(f: torch.Tensor) -> torch.Tensor:
    """``f [N, K, V]`` → ``[N, 2V-1]``: the full correlation of every map
    with itself, summed over the K maps, by direct sums."""
    n, k, v = f.shape
    flat = f.reshape(n * k, v)
    out = torch.empty((n * k, 2 * v - 1), dtype=torch.float32)
    for i in range(0, n * k, 2048):
        blk = flat[i:i + 2048]
        lagged = F.pad(blk, (v - 1, v - 1)).unfold(1, v, 1)  # [b, 2V-1, V]
        out[i:i + 2048] = torch.einsum("bjv,bv->bj", lagged, blk)
    return out.reshape(n, k, 2 * v - 1).sum(dim=1)


def self_correlation_dft(f: torch.Tensor, q) -> torch.Tensor:
    """:func:`self_correlation` by a real DFT of length 2V - 1 with every
    operand rounded by ``q``."""
    n, k, v = f.shape
    m = 2 * v - 1
    bins = v  # m is odd: bins 0 .. (m - 1) / 2
    t = torch.arange(v, dtype=torch.float64)
    b = torch.arange(bins, dtype=torch.float64)
    ang = 2 * torch.pi * t[:, None] * b[None, :] / m
    cos, sin = q(ang.cos().float()), q(ang.sin().float())
    x = q(f.reshape(n * k, v))
    power = ((x @ cos) ** 2 + (x @ sin) ** 2).reshape(n, k, bins).sum(1)
    lags = torch.arange(v, dtype=torch.float64)
    w = torch.full((bins,), 2.0, dtype=torch.float64)
    w[0] = 1.0
    inv = q((w[:, None] * torch.cos(2 * torch.pi * b[:, None] * lags[None, :]
                                    / m) / m).float())
    half = q(power) @ inv  # lags 0 .. V-1
    return torch.cat([half.flip(-1)[:, :-1], half], dim=-1)


def forward(x: torch.Tensor, params: dict, padding: int = 1,
            fp8: bool = False) -> torch.Tensor:
    """``x [B, C, W]`` windows → ``[B, out]``.  ``params``: ``conv_w`` (a
    list of ``[O, I, K]``), ``conv_b``, ``fc_w [out, in]``, ``fc_b``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = _fp8 if fp8 else (lambda t: t)
    b, c, w = x.shape
    outs = []
    for i in range(0, b, 1024):
        xb = x[i:i + 1024].to(torch.float32)
        nb = xb.shape[0]
        y = q(xb.reshape(nb * c, 1, w))
        for wt, bs in zip(params["conv_w"], params["conv_b"]):
            y = F.conv1d(y, q(wt.float()), bs.float(), padding=padding)
            y = q(F.silu(y))
        v = y.shape[-1]
        if fp8:
            cc = self_correlation_dft(y, q)
        else:
            cc = self_correlation(y)
        cc = cc.reshape(nb, c, 2 * v - 1)
        lag0 = cc[..., v - 1:v] + 1e-6
        feats = torch.cat([(cc / lag0).reshape(nb, -1),
                           torch.log(lag0).reshape(nb, -1)], dim=-1)
        fw, fb = params["fc_w"].float(), params["fc_b"].float()
        if fp8:
            feats, fw = _bf16(feats), _bf16(fw)
        outs.append(feats @ fw.T + fb)
    return torch.cat(outs) if outs else torch.zeros((0, params["fc_b"]
                                                      .numel()))

