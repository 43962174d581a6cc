"""FCNN: a configurable MLP mapping lag vectors to hit coordinates (port of
``onset_fingerprinting_tpu.models.fcnn``), the activation registry the
model families share, and the flax layer semantics they train with.

flax's layers differ from torch's defaults in ways that move a trained
model, so the port has its own:

- :class:`BatchNorm`: momentum 0.99 (torch's ``momentum=0.01``), eps 1e-5,
  the batch variance as ``E[x^2] - E[x]^2`` clipped at 0, and the *biased*
  variance in the running average (``nn.BatchNorm1d`` keeps the unbiased
  one);
- :func:`dropout`: a Bernoulli keep mask drawn from a generator the caller
  gives, kept values scaled by ``1 / keep``;
- under :func:`data_parallel` (a trainer on a mesh, each rank holding
  rows of the global batch) :class:`BatchNorm` takes its statistics over
  the global batch (sums and sums of squares ``all_reduce``-d, the
  gradient flowing back through the collective) and :func:`dropout` draws
  the global batch's mask from the generator and keeps the rank's rows, as
  the JAX trainer's one program over the sharded batch computes them;
- :func:`flax_init_`: LeCun-normal kernels (a normal truncated at two
  standard deviations, rescaled to variance ``1 / fan_in``), zero biases,
  norms at scale 1 and bias 0, drawn from a seeded generator; recurrent
  layers per gate as flax's cells (input kernels LeCun-normal, hidden
  kernels orthogonal), attention projections LeCun-normal.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from onset_fingerprinting_torch.device import resolve_device

ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "silu": F.silu,
    # flax.linen.leaky_relu's default slope
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

#: stddev of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


class DataParallel(NamedTuple):
    """A rank's place in a data-parallel step: the process group of the
    ``data`` axis, its size and this rank's index along it (its rows are
    the ``rank``-th of ``world`` equal parts of the global batch)."""

    group: object
    world: int
    rank: int


_DATA_PARALLEL: contextvars.ContextVar = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(dp: DataParallel | None):
    """Run the enclosed forward passes as ``dp``'s rank of a data-parallel
    step (None: a single process, nothing changes)."""
    token = _DATA_PARALLEL.set(dp)
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each value with probability
    ``1 - rate`` (mask drawn from ``generator``) and scale it by ``1 / (1 -
    rate)``; the identity otherwise or at ``rate == 0``."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    dp = _DATA_PARALLEL.get()
    if dp is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) \
            < keep
    else:
        # the global batch's mask, this rank's rows of it
        b = x.shape[0]
        mask = torch.rand((b * dp.world,) + tuple(x.shape[1:]),
                          generator=generator, device=x.device)[
            dp.rank * b: (dp.rank + 1) * b] < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but ``axis`` (module
    docstring).  Parameters ``weight``/``bias`` (flax ``scale``/``bias``),
    buffers ``running_mean``/``running_var`` (flax ``batch_stats``)."""

    def __init__(self, num_features: int, axis: int = 1,
                 momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.axis = axis
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        axes = [d for d in range(x.dim()) if d != self.axis]
        shape = [1] * x.dim()
        shape[self.axis] = -1
        dp = _DATA_PARALLEL.get()
        if self.training and dp is not None:
            # the global batch's statistics: the ranks' sums, reduced
            from torch.distributed.nn.functional import all_reduce

            n = x.numel() // x.shape[self.axis] * dp.world
            sums = all_reduce(torch.stack([x.sum(dim=axes),
                                           (x * x).sum(dim=axes)]),
                              group=dp.group)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        elif self.training:
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + \
            self.bias.reshape(shape)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()`` in place: truncated normal, variance ``1 /
    fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every layer of ``module`` as flax would (module
    docstring), in the order :meth:`~torch.nn.Module.modules` walks them.
    An :class:`FCNN` with ``eye_init`` takes its own."""
    skip = set()
    for m in module.modules():
        if id(m) in skip:
            continue
        if isinstance(m, FCNN) and m.eye_init:
            m.eye_init_(generator)
            skip.update(id(d) for d in m.modules())
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.RNNBase):
            for name, p in m.named_parameters():
                if name.startswith("bias"):
                    p.zero_()
                    continue
                for gate in p.view(-1, m.hidden_size, p.shape[1]):
                    if name.startswith("weight_ih"):
                        lecun_normal_(gate, p.shape[1], generator)
                    else:
                        nn.init.orthogonal_(gate, generator=generator)
        elif isinstance(m, nn.MultiheadAttention):
            for proj in m.in_proj_weight.view(3, m.embed_dim, -1):
                lecun_normal_(proj, m.embed_dim, generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (BatchNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module


class FCNN(nn.Module):
    """MLP of (Dense → BatchNorm → act → Dropout) blocks and a dense output
    (JAX fcnn.py:29-80).  ``input_size`` is the lag vector's length (flax
    infers it).  Parameters ``layers.{i}``, ``norms.{i}`` and ``out``.
    ``forward(x, generator)`` draws dropout masks from ``generator`` in
    training."""

    def __init__(self, input_size: int, output_size: int = 2,
                 hidden_layers: Sequence[int] = (10, 10, 10),
                 activation: str = "relu", dropout: float = 0.0,
                 batch_norm: bool = True, l2_reg: float = 0.0,
                 eye_init: bool = False, eye_noise_floor: float = 0.01,
                 bias: bool = True):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.dropout = dropout
        self.l2_reg = l2_reg
        self.eye_init = eye_init
        self.eye_noise_floor = eye_noise_floor
        self.layers = nn.ModuleList()
        self.norms = nn.ModuleList()
        cin = input_size
        for width in hidden_layers:
            self.layers.append(nn.Linear(cin, width, bias=bias))
            if batch_norm:
                self.norms.append(BatchNorm(width))
            cin = width
        self.out = nn.Linear(cin, output_size, bias=bias)

    @torch.no_grad()
    def eye_init_(self, generator: torch.Generator) -> None:
        """flax ``_eye_init``: every kernel ``eye + noise_floor * N(0,
        1)``, zero biases, norms at 1/0."""
        for lin in (*self.layers, self.out):
            o, i = lin.weight.shape
            noise = torch.randn((i, o), generator=generator,
                                device=lin.weight.device)
            eye = torch.eye(i, o, device=lin.weight.device)
            lin.weight.copy_((eye + self.eye_noise_floor * noise).T)
            if lin.bias is not None:
                lin.bias.zero_()
        for norm in self.norms:
            norm.weight.fill_(1.0)
            norm.bias.zero_()
            norm.running_mean.zero_()
            norm.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if self.norms:
                x = self.norms[i](x)
            x = dropout(act(x), self.dropout, self.training, generator)
        return self.out(x)

    def l2_loss(self) -> torch.Tensor:
        """L2 penalty over all parameters (JAX fcnn.py:72-77)."""
        p = next(self.parameters())
        if self.l2_reg == 0.0:
            return torch.zeros((), device=p.device)
        return self.l2_reg * sum((q ** 2).sum() for q in self.parameters())


class FCNNBundle:
    """A trained :class:`FCNN` behind an inference call (JAX
    fcnn.py:80-95): ``bundle(x)`` runs it in eval mode without autograd;
    ``call_np(lags)`` takes one lag vector and returns a numpy coordinate
    (the realtime locator's bypass, calibration.py:552-560 of the
    reference)."""

    def __init__(self, model: FCNN):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.model(x)

    def call_np(self, lags) -> np.ndarray:
        return self(np.asarray([lags], np.float32))[0].cpu().numpy()


def init_module(module: nn.Module, seed: int = 0, device=None) -> nn.Module:
    """``module`` on ``device`` (None = the card), initialised by
    :func:`flax_init_` from a generator seeded with ``seed`` (drawn on the
    CPU, so that a seed gives the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return flax_init_(module.cpu(), g).to(resolve_device(device))
