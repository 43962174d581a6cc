"""Learned location from lags (port of ``train_location_model`` from
``onset_fingerprinting_tpu.locate.calibration``, JAX calibration.py:376-507):
an FCNN fitted full batch on lag vectors → (x, y) hit coordinates, with
clip 1.0 and adam under cosine warm restarts.

The rest of the JAX module (the TDOA calibration losses, ``fit_tnc``,
``optimize_C``, ``calibrate``, ``optimize_positions``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.fcnn import (
    FCNN,
    FCNNBundle,
    init_module,
)
from onset_fingerprinting_torch.models.train import make_optimizer


def train_location_model(observed_lags, sound_positions, lr: float = 0.01,
                         lossfun: str = "l1", num_epochs: int = 1000,
                         eps: float = 1e-9, patience: int = 10,
                         verbose: bool = False, epochs_per_step: int = 1,
                         device=None, **fcnn_kwargs):
    """Train an FCNN mapping lag vectors to (x, y) (calibration.py:685-754
    of the reference), initialised as flax would from seed 0.  The lags
    ``[N, P]`` and positions ``[N, >=2]`` are arrays or tensors.  Returns
    ``(FCNNBundle, per-epoch losses)``.

    ``epochs_per_step > 1`` runs that many epochs between host reads and
    tracks the best state at that granularity, on the loss of the
    post-chunk weights (one extra train-mode forward, no update).  With
    one epoch per step the loss belongs to the pre-update weights, so the
    best state keeps those (and the batch stats of that forward).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(observed_lags, dtype=torch.float32, device=dev)
    y = torch.as_tensor(sound_positions, dtype=torch.float32,
                        device=dev)[:, :2]
    model = init_module(FCNN(x.shape[1], output_size=2, **fcnn_kwargs), 0,
                        dev).train()
    # torch's CosineAnnealingLR(T_max=epochs/10) cycles past T_max, which
    # the reference relies on (calibration.py:723-725): warm restarts
    opt = make_optimizer("adam", lr, schedule="cosine_restarts",
                         schedule_period=max(num_epochs // 10, 1),
                         grad_clip=1.0)(model.parameters())

    def loss_of():
        err = model(x) - y
        return err.abs().mean() if lossfun == "l1" else (err ** 2).mean()

    def step():
        loss = loss_of()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    def params():
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    def buffers():
        return {k: v.detach().clone() for k, v in model.named_buffers()}

    best = {**params(), **buffers()}
    last_loss = np.inf
    counter = 0
    errors = []
    if epochs_per_step > 1:
        k = epochs_per_step
        for chunk in range((num_epochs + k - 1) // k):
            losses = torch.stack([step() for _ in range(k)]).cpu().numpy()
            errors.extend(float(v) for v in losses)
            # the post-chunk loss, and the batch stats that forward leaves;
            # training carries on from the chunk's own stats
            stats = buffers()
            with torch.no_grad():
                end_loss = float(loss_of())
            stats_eval = buffers()
            model.load_state_dict(stats, strict=False)
            if end_loss < last_loss - eps:
                last_loss = end_loss
                best = {**params(), **stats_eval}
                counter = 0
            elif counter < patience:
                counter += k
            else:
                break
            if verbose:
                print(f"epoch {(chunk + 1) * k}: loss {end_loss:.3e}")
    else:
        for epoch in range(num_epochs):
            prev = params()
            loss = float(step())
            errors.append(loss)
            if loss < last_loss - eps:
                last_loss = loss
                best = {**prev, **buffers()}
                counter = 0
            elif counter < patience:
                counter += 1
            else:
                break
            if verbose and epoch % 10 == 0:
                print(f"epoch {epoch}: loss {loss:.3e}")
    model.load_state_dict(best)
    return FCNNBundle(model), errors
