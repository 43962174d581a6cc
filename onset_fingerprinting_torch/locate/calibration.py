"""Sensor-geometry calibration from TDOA observations, and learned location
from lags (port of ``onset_fingerprinting_tpu.locate.calibration``;
reference: onset_fingerprinting/calibration.py:13-754).

- :func:`tdoa_calib_loss` / :func:`tdoa_calib_loss_with_sp`: losses over
  all hits at once, differentiable by autograd.
- :func:`fit_tnc`: scipy's bounded TNC fed by float64 autograd of a loss
  on ``device`` (None = the card).  Each iteration evaluates a loss of a
  few hundred elements, so on the card it is bound by launches and host
  round trips; it runs there all the same unless ``device="cpu"``.
- :func:`optimize_C`, :func:`calibrate`: the reference's multi-stage
  pipelines (fit → median-error outlier filter → (a scalar C search) →
  refit).
- :func:`optimize_positions`: optax's adam with a learning rate per group
  (:class:`~onset_fingerprinting_torch.models.train.OptaxAdam`), cosine
  decay, global-norm clipping and patience early stop.
- :func:`train_location_model`: an FCNN fitted full batch on lag vectors
  → (x, y) hit coordinates, with clip 1.0 and adam under cosine warm
  restarts.

The JAX module keeps its inputs in float32 and evaluates the TNC losses
under ``jax.enable_x64``, so the losses compute in float64 on
float32-rounded observations; these functions round their inputs the same
way.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy import optimize as sciopt

from onset_fingerprinting_torch.core.coords import spherical_to_cartesian
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.fcnn import (
    FCNN,
    FCNNBundle,
    init_module,
)
from onset_fingerprinting_torch.models.train import (
    OptaxAdam,
    clip_by_global_norm_,
    cosine_decay_schedule,
    make_optimizer,
)


def calibration_locations(n_lugs: int, n_each, radius: float,
                          add_z: Optional[int] = None,
                          clockwise: bool = False) -> list[tuple]:
    """Spherical coordinates of calibration hits around the drum's lugs
    (calibration.py:423-460)."""
    n = len(n_each) if isinstance(n_each, list) else 1
    angles = np.repeat(range(0, 360, int(360 / n_lugs)), n_each)
    if not clockwise:
        angles = 360 - angles
    radii = np.repeat(np.repeat([radius] * n, n_each), n_lugs)
    if add_z is not None:
        assert isinstance(add_z, int), "add_z must be an integer"
        zs = np.repeat(np.repeat([add_z] * n, n_each), n_lugs)
        return list(zip(radii, angles, zs))
    return list(zip(radii, angles))


def _lug_sound_positions(radius: float, n_lugs: int, n_each: int,
                         center_hits: int) -> torch.Tensor:
    """Center hits + lug-ring hits in cartesian, as one float32 ``[H, 3]``
    tensor (on the CPU)."""
    ring = [torch.stack(spherical_to_cartesian(*pos)).to(torch.float32)
            for pos in calibration_locations(n_lugs, n_each, radius, 0)]
    ring = torch.stack(ring) if ring else torch.zeros((0, 3))
    return torch.cat([torch.zeros((center_hits, 3)), ring]).to(
        torch.float32)


def _f32(a) -> torch.Tensor:
    """An observation as the JAX module holds it: rounded to float32."""
    if torch.is_tensor(a):
        return a.to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32))


def _per_hit_errors(sensor_positions, sound_positions, observed_tdoa, C,
                    norm):
    """``[H, S-1]`` per-hit TDOA residual errors."""
    dists = torch.linalg.norm(
        sound_positions[:, None, :] - sensor_positions[None, :, :],
        dim=-1) / C
    tdoa = torch.diff(dists, dim=1)
    return torch.abs(tdoa - observed_tdoa) ** norm


def tdoa_calib_loss(params: torch.Tensor, sound_positions: torch.Tensor,
                    observed_tdoa: torch.Tensor, C: float = 343.0,
                    norm: int = 1) -> torch.Tensor:
    """Mean summed per-hit TDOA error; ``params`` are the flat sensor
    positions (calibration.py:13-45).  Scalar, differentiable; computes in
    the dtype of ``params``."""
    sp = params.reshape(-1, 3)
    e = _per_hit_errors(sp, sound_positions.to(params),
                        observed_tdoa.to(params), C, norm)
    return torch.mean(torch.sum(e, dim=0))


def tdoa_calib_errors(params, sound_positions, observed_tdoa, C=343.0,
                      norm=1, device=None) -> np.ndarray:
    """Per-hit error vector ``[H]`` (for outlier filtering,
    calibration.py:286-289), in float32 as the JAX module computes it, on
    ``device`` (None = the card)."""
    dev = resolve_device(device)
    sp = _f32(params).to(dev).reshape(-1, 3)
    e = _per_hit_errors(sp, _f32(sound_positions).to(dev),
                        _f32(observed_tdoa).to(dev), float(np.float32(C)),
                        norm)
    return torch.sum(e, dim=1).cpu().numpy()


def tdoa_calib_loss_with_sp(params: torch.Tensor,
                            observed_tdoa: torch.Tensor, n_lugs: int = 10,
                            n_each: int = 4, center_hits: int = 4,
                            norm: int = 1, opt_c: bool = False,
                            C: float = 343.0) -> torch.Tensor:
    """Joint loss over the hit-ring radius (``params[0]``), optionally C
    (``params[1]``) and the sensor positions (calibration.py:91-139),
    differentiable in all of them: the lug layout is regenerated from the
    radius at each evaluation (the ring's cosines in float32, as the JAX
    module takes them)."""
    radius = params[0]
    angles = np.repeat(
        360.0 - np.repeat(np.arange(0, 360, 360 // n_lugs), n_each), 1
    ).astype(np.float32)
    phi = torch.deg2rad(torch.as_tensor(angles, device=params.device))
    x = radius * torch.cos(phi).to(params.dtype)
    y = radius * torch.sin(phi).to(params.dtype)
    ring = torch.stack([x, y, torch.zeros_like(x)], dim=1)
    sound_positions = torch.cat([
        torch.zeros((center_hits, 3), dtype=params.dtype,
                    device=params.device), ring])
    c_val = params[1] if opt_c else C
    sp = params[(1 + int(opt_c)):].reshape(-1, 3)
    e = _per_hit_errors(sp, sound_positions, observed_tdoa.to(params),
                        c_val, norm)
    return torch.mean(torch.sum(e, dim=0))


def fit_tnc(loss_fn: Callable, x0: np.ndarray, args: tuple = (),
            bounds=None, maxfun: int = 10000,
            device=None) -> sciopt.OptimizeResult:
    """Bounded TNC minimisation (the reference's optimiser, method='TNC',
    hand Jacobians) with the value and gradient from float64 autograd on
    ``device`` (None = the card).  Tensor ``args`` go to ``device`` as
    float64; quasi-Newton line searches stall on float32 gradient noise
    well before the reference's criteria (calibration.py:574, 593-595)."""
    dev = resolve_device(device)
    args = tuple(a.to(dev, torch.float64) if torch.is_tensor(a) else a
                 for a in args)

    def f(p):
        pt = torch.tensor(p, dtype=torch.float64, device=dev,
                          requires_grad=True)
        v = loss_fn(pt, *args)
        (g,) = torch.autograd.grad(v, pt)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    return sciopt.minimize(f, np.asarray(x0, np.float64), jac=True,
                           method="TNC", bounds=bounds,
                           options={"maxfun": maxfun})


def _default_sensors(third_r: float) -> np.ndarray:
    return np.array([
        [float(v) for v in spherical_to_cartesian(*pos)]
        for pos in [(0.9, 140, 75), (0.9, 10, 55), (third_r, 100, 15)]])


def optimize_C(tdoa: np.ndarray, n_lugs: int = 10, n_each: int = 4,
               center_hits: int = 4, norm: int = 1,
               C_range: tuple = (336, 345), initial_C: float = 343.0,
               radius: float = 14 * 2.54 / 100 / 2, hits_at: float = 0.155,
               filter_errors_above: float = 3, sound_positions=None,
               initial_sensor_positions=None, bounds=None, device=None,
               **kwargs):
    """Three stages: a TNC position fit at ``initial_C`` → median-error
    outlier filter → a bounded scalar search over C, each step a nested
    TNC fit → the final refit (calibration.py:212-314).  Returns
    ``(positions [S, 3], best C)``."""
    if sound_positions is None:
        sound_positions = _lug_sound_positions(hits_at, n_lugs, n_each,
                                               center_hits)
    if initial_sensor_positions is None:
        initial_sensor_positions = _default_sensors(hits_at)
    if bounds is None:
        bounds = [(None, None), (None, None), (0, None)] * 2 + [
            (-radius, radius), (-radius, radius), (0, radius)]
    sound_positions = _f32(sound_positions)
    tdoa_t = _f32(tdoa)
    res = fit_tnc(tdoa_calib_loss,
                  np.asarray(initial_sensor_positions).flatten(),
                  args=(sound_positions, tdoa_t, initial_C, norm),
                  bounds=bounds, device=device)
    x0 = res.x
    errors = tdoa_calib_errors(x0, sound_positions, tdoa_t, initial_C, norm,
                               device=device)
    good = np.where(errors < filter_errors_above * np.median(errors))[0]
    sp_g = sound_positions[good]
    td_g = tdoa_t[good]

    def objective(C):
        return fit_tnc(tdoa_calib_loss, x0,
                       args=(sp_g, td_g, float(C), norm), bounds=bounds,
                       maxfun=1000, device=device).fun

    best = sciopt.minimize_scalar(objective, bounds=C_range,
                                  method="bounded")
    final = fit_tnc(tdoa_calib_loss, x0,
                    args=(sp_g, td_g, float(best.x), norm), bounds=bounds,
                    maxfun=100000, device=device)
    return final.x.reshape(-1, 3), float(best.x)


def calibrate(onsets: np.ndarray, sr: int = 96000, C: float = 343.0,
              diameter: float = 14 * 2.54, n_lugs: int = 10,
              n_each: int = 4, hits_at: float = 0.9, center_hits: int = 4,
              norm: int = 1, filter_errors_above: float = 2,
              opt_c: bool = False, device=None) -> np.ndarray:
    """End-to-end sensor calibration from an onset matrix ``[H, S]``
    (calibration.py:317-420): a joint radius (+ C) + positions TNC fit with
    bounds → outlier filter → refit.  Returns sensor positions ``[S, 3]``
    (meters)."""
    radius = diameter / 2 / 100
    tdoa = _f32(np.diff(onsets) / sr)
    x0 = np.concatenate([[radius * hits_at], [C] if opt_c else [],
                         _default_sensors(radius).flatten()])
    bounds = (
        [(0.5 * radius, 1.1 * radius)]
        + ([(336.0, 345.0)] if opt_c else [])
        + [(None, None), (None, None), (0, None)] * 2
        + [(-radius, radius), (-radius, radius), (0, radius)]
    )
    res = fit_tnc(
        lambda p, td: tdoa_calib_loss_with_sp(
            p, td, n_lugs, n_each, center_hits, norm, opt_c, C),
        x0, args=(tdoa,), bounds=bounds, device=device)
    r = res.x[0]
    if opt_c:
        C = res.x[1]
    sound_positions = _lug_sound_positions(float(r), n_lugs, n_each,
                                           center_hits)
    sensor_positions = res.x[1 + int(opt_c):].reshape(-1, 3)
    errors = tdoa_calib_errors(sensor_positions, sound_positions, tdoa, C,
                               norm, device=device)
    good = np.where(errors < filter_errors_above * np.median(errors))[0]
    final = fit_tnc(
        tdoa_calib_loss, sensor_positions.flatten(),
        args=(sound_positions[good], tdoa[good], float(C), norm),
        bounds=[(None, None), (None, None), (0, None)] * 2
        + [(-radius, radius), (-radius, radius), (0, radius)],
        device=device)
    return final.x.reshape(-1, 3)


def optimize_positions(observed_lags: np.ndarray,
                       initial_sensor_positions: np.ndarray,
                       initial_sound_positions: np.ndarray, lr: float = 0.01,
                       lossfun: str = "mse", num_epochs: int = 1000,
                       C: float = 342.29, sr: int = 96000,
                       eps: float = 1e-12, patience: int = 10,
                       verbose: bool = False, device=None):
    """Joint gradient optimisation of the sensor positions, the sounds' x/y
    (z fixed at 0) and C, in float32 on ``device`` (None = the card): the
    reference's torch Adam loop (calibration.py:563-682) as the JAX module
    runs it in optax: a learning rate per group (2e-3, 1e-4 and 0.1 ×
    ``lr``), each decayed by its own cosine over ``num_epochs`` updates,
    the gradients clipped to global norm 1 first, patience early stop on
    the train loss.  Returns ``(sensor_positions [S, 3], sound_positions
    [H, 3], C)``."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    observed_tdoa = torch.as_tensor(
        np.asarray(observed_lags, np.float32), **f32) / sr
    params = {
        "sensors": torch.as_tensor(
            np.asarray(initial_sensor_positions, np.float32), **f32),
        "sounds_xy": torch.as_tensor(
            np.asarray(initial_sound_positions, np.float32), **f32)[:, :2],
        "C": torch.tensor(np.float32(C), **f32),
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    lrs = {"sensors": 2e-3 * lr, "sounds_xy": 1e-4 * lr, "C": 0.1 * lr}
    schedules = {k: cosine_decay_schedule(v, num_epochs)
                 for k, v in lrs.items()}
    opt = OptaxAdam([{"params": [params[k]], "name": k} for k in lrs],
                    lr=0.0)

    def loss_fn():
        p = params
        sounds = torch.cat([p["sounds_xy"], torch.zeros(
            (p["sounds_xy"].shape[0], 1), **f32)], dim=1)
        dists = torch.linalg.norm(sounds[:, None, :] - p["sensors"][None],
                                  dim=-1)
        tdoa = (dists[:, :2] - dists[:, 2:]) / p["C"]
        err = tdoa - observed_tdoa
        if lossfun == "mse":
            return torch.mean(err ** 2)
        return torch.mean(torch.abs(err))

    last_loss = np.inf
    counter = 0
    for epoch in range(num_epochs):
        loss = loss_fn()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params.values()], 1.0)
        for group in opt.param_groups:
            group["lr"] = schedules[group["name"]](epoch)
        opt.step()
        loss = float(loss.detach())
        if loss < last_loss - eps:
            last_loss = loss
            counter = 0
        elif counter < patience:
            counter += 1
        else:
            break
        if verbose and epoch % 10 == 0:
            print(f"epoch {epoch}: loss {loss:.3e}")
    sounds = np.concatenate(
        [params["sounds_xy"].detach().cpu().numpy(),
         np.zeros((len(observed_tdoa), 1))], axis=1)
    return (params["sensors"].detach().cpu().numpy(), sounds,
            float(params["C"].detach()))


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
