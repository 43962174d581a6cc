"""Training loops: optax's optimizers and schedules, early stopping (port of
``onset_fingerprinting_tpu.models.train``, JAX train.py:31-387).

- :func:`make_optimizer` keeps optax's chain and its order: clip by global
  norm → add decayed weights → the optimizer scaled by the schedule, the
  schedule read at the update count before it increments (0 for the first
  update).  sgd (momentum 0.8) is torch's ``SGD``, which computes optax's
  update.  adam and nadam are :class:`OptaxAdam`: torch's ``Adam`` is the
  same method but rounds in another order (1e-6 apart after 20 updates),
  and nadam is optax's ``scale_by_adam(nesterov=True)``, not
  ``torch.optim.NAdam``'s momentum-decay method.  The clip is optax's rule, ``g / norm * max_norm`` once the norm
  reaches ``max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm).
- :class:`Trainer` fits full batch or mini batch with early stopping on the
  validation loss (the train loss without one), ``min_epochs`` and
  continuation from a returned state; ``epochs_per_step=K`` runs K
  full-batch steps with no host sync between them and reads their K
  losses at once.  The state it returns holds the best weights: a copy
  taken off the live module when the monitor improved, restored at the
  end.
- Checkpoints are ``torch.save`` of the module's ``state_dict`` where the
  JAX package uses orbax.
- ``mesh`` (a ``parallel.Mesh`` with a ``data`` axis) trains data
  parallel, as the JAX trainer's ``in_shardings``: every rank is given
  the global batch and takes its rows of it, the gradients are averaged
  over the axis (one ``all_reduce`` of their flat concatenation), and the
  parameters and optimizer state stay replicated.  BatchNorm takes its
  statistics over the global batch and dropout draws the global batch's
  mask (``models.fcnn.data_parallel``), so a meshed step computes the
  unmeshed one's update.  The returned loss is the global batch's.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from onset_fingerprinting_torch.core.config import TrainConfig
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.fcnn import (
    DataParallel,
    data_parallel,
    init_module,
)


def cosine_warm_restarts(lr: float, period: int, t_mult: int = 1):
    """``CosineAnnealingWarmRestarts``-style schedule (t_mult=1 keeps a
    fixed period), in float32 as the JAX package computes it."""
    f = np.float32

    def schedule(step: int) -> float:
        t = step % period if t_mult == 1 else step
        return float(f(lr) * f(0.5) * (f(1) + np.cos(
            f(np.pi) * f(t % period) / f(period))))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0):
    """``optax.cosine_decay_schedule``: the cosine from ``init_value`` down
    to ``alpha * init_value`` over ``decay_steps`` updates, then constant
    (0 by default)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f = np.float32

    def schedule(step: int) -> float:
        count = f(min(step, decay_steps))
        decay = f(0.5) * (f(1) + np.cos(f(np.pi) * count / f(decay_steps)))
        return float(f(init_value) * ((f(1) - f(alpha)) * decay ** f(exponent)
                                      + f(alpha)))

    return schedule


class OptaxAdam(torch.optim.Optimizer):
    """optax ``adam`` (``nesterov=False``) or ``nadam`` (``nesterov=True``,
    optax's ``scale_by_adam(nesterov=True)``) in optax's order of
    operations, with ``weight_decay`` added to the gradient first
    (``optax.add_decayed_weights`` before it).  At update ``t`` (from 1)::

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
        mu_hat = mu / (1 - b1^t)                         (adam)
        mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)  (nadam)
        p -= lr mu_hat / (sqrt(nu / (1 - b2^t)) + eps)

    The bias corrections are float32, as in optax.  One pass of
    ``torch._foreach`` ops over the parameters, no host sync."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            gs = [p.grad for p in ps]
            if group["weight_decay"]:
                gs = torch._foreach_add(gs, ps, alpha=group["weight_decay"])
            for p in ps:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
            t = self.state[ps[0]]["step"]
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, gs, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(gs, gs), alpha=1 - b2)
            bc1, bc1_next, bc2 = (float(np.float32(1) - np.float32(b) ** n)
                                  for b, n in ((b1, t), (b1, t + 1), (b2, t)))
            if group["nesterov"]:
                mu_hat = torch._foreach_mul(torch._foreach_div(mus, bc1_next),
                                            b1)
                torch._foreach_add_(mu_hat, torch._foreach_div(gs, bc1),
                                    alpha=1 - b1)
            else:
                mu_hat = torch._foreach_div(mus, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, group["eps"])
            torch._foreach_add_(ps, torch._foreach_div(mu_hat, den),
                                alpha=-group["lr"])


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: every gradient scaled by
    ``max_norm / norm`` (as ``g / norm * max_norm``) once the global norm
    reaches ``max_norm``.  No host sync."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclass(frozen=True)
class OptimizerSpec:
    """An optax chain to build over a module's parameters (``spec(params)``
    → :class:`Chain`)."""

    name: str
    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: float
    momentum: float

    def __call__(self, params) -> "Chain":
        params = list(params)
        wd = self.weight_decay
        if self.name in ("adam", "nadam"):
            opt = OptaxAdam(params, lr=0.0, weight_decay=wd,
                            nesterov=self.name == "nadam")
        else:
            opt = torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                                  weight_decay=wd)
        return Chain(opt, self.schedule, self.grad_clip)


class Chain:
    """A torch optimizer behind optax's chain: the clip, then the update at
    the schedule's rate for this update's count."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float], grad_clip: float):
        self.opt = opt
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip:
            clip_by_global_norm_(
                [p.grad for g in self.opt.param_groups for p in g["params"]
                 if p.grad is not None], self.grad_clip)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": copy.deepcopy(self.opt.state_dict()),
                "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count = sd["count"]


def make_optimizer(
    name: str = "nadam",
    lr: float = 1e-3,
    schedule: str = "cosine_restarts",
    schedule_period: int = 250,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
    momentum: float = 0.8,
) -> OptimizerSpec:
    """optax's ``chain(clip_by_global_norm, add_decayed_weights,
    nadam/adam/sgd(schedule))`` (JAX train.py:43-74)."""
    if schedule == "cosine_restarts":
        sched = cosine_warm_restarts(lr, schedule_period)
    elif schedule == "cosine":
        sched = cosine_decay_schedule(lr, schedule_period)
    else:
        def sched(step, lr=lr):
            return lr
    if name not in ("nadam", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {name}")
    return OptimizerSpec(name, sched, weight_decay, grad_clip, momentum)


def _xent(logits, labels):
    """Softmax cross-entropy with integer labels (zone classification)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


LOSSES: dict[str, Callable] = {
    "l1": lambda out, y: (out - y).abs().mean(),
    "mse": lambda out, y: ((out - y) ** 2).mean(),
    "xent": _xent,
}


@dataclass
class TrainState:
    """The module being trained, its optimizer chain, the update count and
    the dropout generator (on the module's device)."""

    module: nn.Module
    optimizer: Chain
    step: int
    generator: torch.Generator


@dataclass
class Trainer:
    """Trainer with early stopping (JAX train.py:93-387).  ``model`` is the
    architecture: :meth:`init_state` trains a copy of it, initialised as
    flax would from ``cfg.seed``.  ``device=None`` means the card."""

    model: nn.Module
    cfg: TrainConfig = field(default_factory=TrainConfig)
    optimizer: Optional[OptimizerSpec] = None
    log_every: int = 0
    device: Any = None
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        if self.optimizer is None:
            self.optimizer = make_optimizer(
                self.cfg.optimizer, self.cfg.lr,
                grad_clip=self.cfg.grad_clip,
                weight_decay=self.cfg.weight_decay,
            )
        self.loss_fn = LOSSES[self.cfg.loss]
        self.history: dict[str, list[float]] = {
            "train_loss": [], "val_loss": []}

    # -- core steps ----------------------------------------------------------

    def init_state(self) -> TrainState:
        """A fresh copy of ``model``, initialised from ``cfg.seed`` (drawn on
        the CPU: a seed gives the same weights on every device), with a
        fresh optimizer and a dropout generator seeded ``cfg.seed``."""
        module = init_module(copy.deepcopy(self.model), self.cfg.seed,
                             self.device)
        g = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return TrainState(module, self.optimizer(module.parameters()), 0, g)

    def step(self, state: TrainState, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """One update on ``(x, y)`` in train mode; returns the loss at the
        pre-update weights as a device scalar (no host sync).  On a mesh
        ``(x, y)`` is the global batch: this rank trains on its rows."""
        m = state.module.train()
        dp = self._data_parallel()
        if dp is None:
            loss = self.loss_fn(m(x, generator=state.generator), y)
            state.optimizer.zero_grad()
            loss.backward()
        else:
            b = x.shape[0]
            if b % dp.world:
                raise ValueError(f"a batch of {b} does not split over "
                                 f"{dp.world} ranks")
            rows = slice(dp.rank * b // dp.world,
                         (dp.rank + 1) * b // dp.world)
            with data_parallel(dp):
                loss = self.loss_fn(m(x[rows], generator=state.generator),
                                    y[rows])
                state.optimizer.zero_grad()
                loss.backward()
            self._average_grads(state, dp)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=dp.group)
            loss = loss / dp.world
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def _data_parallel(self) -> Optional[DataParallel]:
        """This rank's place on the mesh's ``data`` axis (None unmeshed,
        or without a process group)."""
        if self.mesh is None or self.mesh.group("data") is None:
            return None
        return DataParallel(self.mesh.group("data"),
                            self.mesh.shape["data"], self.mesh.index("data"))

    @staticmethod
    def _average_grads(state: TrainState, dp: DataParallel) -> None:
        """Each gradient's mean over the ranks, in one ``all_reduce``."""
        params = [p for p in state.module.parameters() if p.grad is not None]
        if not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=dp.group)
        flat /= dp.world
        off = 0
        for p in params:
            k = p.grad.numel()
            p.grad.copy_(flat[off: off + k].view_as(p.grad))
            off += k

    def _eval_loss(self, state: TrainState, x, y) -> float:
        return float(self.loss_fn(self._out(state, x), y))

    def _out(self, state: TrainState, x) -> torch.Tensor:
        m = state.module.eval()
        with torch.no_grad():
            return m(self._tensor(x))

    def _tensor(self, a) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.to(self.device)

    # -- loops ----------------------------------------------------------------

    def fit(self, train_data, val_data=None, num_epochs: Optional[int] = None,
            state: Optional[TrainState] = None,
            epochs_per_step: int = 1) -> TrainState:
        """Full-batch (``cfg.batch_size`` None) or mini-batch fit with early
        stopping on the validation loss (the train loss without a
        validation set).  ``state`` continues from an earlier fit's
        returned state; ``epochs_per_step > 1`` runs that many full-batch
        epochs between host reads, and early stopping and the monitor then
        work at that granularity."""
        x, y = self._tensor(train_data[0]), self._tensor(train_data[1])
        if val_data is not None:
            val_data = (self._tensor(val_data[0]), self._tensor(val_data[1]))
        num_epochs = num_epochs or self.cfg.num_epochs
        if state is None:
            state = self.init_state()
        bsz = self.cfg.batch_size
        if bsz is None and epochs_per_step > 1:
            return self._fit_scanned(state, x, y, val_data, num_epochs,
                                     epochs_per_step)
        best, best_loss, patience = self._snapshot(state), math.inf, 0
        perm_rng = np.random.default_rng(self.cfg.seed)
        for epoch in range(num_epochs):
            if bsz is None:
                losses = [self.step(state, x, y)]
            else:
                # one host read per epoch: the order goes to the device
                # once and the losses come back together
                idx = torch.as_tensor(perm_rng.permutation(len(x)),
                                      device=self.device)
                losses = [self.step(state, x[b], y[b]) for b in (
                    idx[i:i + bsz]
                    for i in range(0, len(x) - bsz + 1, bsz))]
            losses = (torch.stack(losses).cpu().numpy().astype(np.float64)
                      if losses else np.zeros(0))
            train_loss = float(np.mean(losses))
            self.history["train_loss"].append(train_loss)
            monitor = self._monitor(state, val_data, train_loss)
            if self.log_every and epoch % self.log_every == 0:
                print(f"epoch {epoch}: train {train_loss:.5f} "
                      f"monitor {monitor:.5f}")
            if monitor < best_loss - self.cfg.eps:
                best, best_loss, patience = self._snapshot(state), monitor, 0
            elif epoch >= self.cfg.min_epochs:
                patience += 1
                if patience > self.cfg.patience:
                    break
        return self._finish(state, best, best_loss)

    def _fit_scanned(self, state, x, y, val_data, num_epochs, k):
        best, best_loss, patience = self._snapshot(state), math.inf, 0
        # run-local epoch counter: history accumulates across fit() calls,
        # so an epoch taken from len(history) would let a continued
        # fit(state=...) start past min_epochs and stop at once
        epoch = 0
        for _ in range(-(-num_epochs // k)):
            losses = torch.stack([self.step(state, x, y) for _ in range(k)])
            losses = losses.cpu().numpy().astype(np.float64)
            self.history["train_loss"].extend(float(v) for v in losses)
            monitor = self._monitor(state, val_data, float(losses[-1]))
            epoch += len(losses)
            if monitor < best_loss - self.cfg.eps:
                best, best_loss, patience = self._snapshot(state), monitor, 0
            elif epoch >= self.cfg.min_epochs:
                patience += k
                if patience > self.cfg.patience:
                    break
        return self._finish(state, best, best_loss)

    def _monitor(self, state, val_data, train_loss: float) -> float:
        if val_data is None:
            return train_loss
        monitor = self._eval_loss(state, *val_data)
        self.history["val_loss"].append(monitor)
        return monitor

    @staticmethod
    def _snapshot(state: TrainState) -> dict:
        """A copy of the state's weights, optimizer state, count and
        generator, taken off the live module (not a reference)."""
        return dict(
            module={k: v.detach().clone()
                    for k, v in state.module.state_dict().items()},
            optimizer=state.optimizer.state_dict(), step=state.step,
            generator=state.generator.get_state())

    def _finish(self, state: TrainState, best: dict,
                best_loss: float) -> TrainState:
        """Put the best snapshot back into the live state and return it."""
        self.best_loss = best_loss
        state.module.load_state_dict(best["module"])
        state.optimizer.load_state_dict(best["optimizer"])
        state.step = best["step"]
        state.generator.set_state(best["generator"])
        return state

    # -- evaluation -----------------------------------------------------------

    def test(self, state: TrainState, test_data) -> float:
        """L1 test metric, the reference's ``hp_metric`` (model.py:136-144)."""
        out = self._out(state, test_data[0])
        return float((out - self._tensor(test_data[1])).abs().mean())

    def accuracy(self, state: TrainState, data) -> float:
        """Classification accuracy (zone classifiers)."""
        out = self._out(state, data[0]).argmax(dim=1).cpu().numpy()
        return float((out == np.asarray(data[1])).mean())

    def predict(self, state: TrainState, x) -> np.ndarray:
        return self._out(state, x).cpu().numpy()

    # -- checkpoint / resume --------------------------------------------------

    def save_checkpoint(self, state: TrainState, path) -> None:
        """Persist the module's ``state_dict`` (weights and batch stats)."""
        torch.save(state.module.state_dict(), path)

    def load_checkpoint(self, path) -> TrainState:
        """Restore into a fresh state (optimizer state reinitialised)."""
        state = self.init_state()
        state.module.load_state_dict(
            torch.load(path, map_location=self.device, weights_only=True))
        return state
