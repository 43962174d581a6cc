"""TDOA trilateration (port of ``onset_fingerprinting_tpu.locate.
trilateration``).

The reference solves the two-equation hyperbolic system

    ‖p − a‖ − ‖p − o‖ = Δa,   ‖p − b‖ − ‖p − o‖ = Δb

with ``scipy.optimize.fsolve`` and a hand-written Jacobian (xtol 0.01,
maxfev 20; multilateration.py:170-316).  As in the JAX package it is a
damped Newton iteration with the same analytic Jacobian and a closed-form
2×2 solve, in float32, batched over any leading axes.  ``unroll=True``
runs ``max_iter`` masked iterations with no host read (the realtime
engine's form, which a CUDA graph can capture); ``unroll=False`` stops
once every problem has converged, reading ``done`` on the host each
iteration.  Both give the same values: once a problem is done its masks
freeze it.
"""

from __future__ import annotations

import torch


def _residual_jac_3d(p, sensors, deltas):
    """Residuals ``[..., 2]`` and Jacobian ``[..., 2, 2]`` for 3D sensors
    ``[..., 3, 3]`` (rows origin, a, b), the unknown point ``p [..., 2]``
    on z = 0, ``deltas [..., 2]`` (Δa, Δb) in distance."""
    xy = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    diff = xy[..., None, :] - sensors  # [..., 3, 3]
    dist = torch.sqrt(torch.sum(diff ** 2, dim=-1))  # [..., 3]
    f = dist[..., 1:] - dist[..., :1] - deltas
    grads = diff[..., :2] / dist[..., None]
    jac = grads[..., 1:, :] - grads[..., :1, :]
    return f, jac


def _solve_2x2(jac, f):
    """Newton step ``jac⁻¹ f`` by the closed form, and whether ``jac`` is
    solvable (|det| ≥ 1e-12)."""
    a, b = jac[..., 0, 0], jac[..., 0, 1]
    c, d = jac[..., 1, 0], jac[..., 1, 1]
    det = a * d - b * c
    safe = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    step = torch.stack([d * f[..., 0] - b * f[..., 1],
                        -c * f[..., 0] + a * f[..., 1]], dim=-1)
    return step / safe[..., None], torch.abs(det) >= 1e-12


def solve_tdoa(sensors: torch.Tensor, deltas: torch.Tensor,
               initial_guess: torch.Tensor, xtol: float = 0.01,
               max_iter: int = 20, unroll: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The strike point: ``(point [..., 2], success [...])`` for
    ``sensors [..., 3, 3]`` (origin, a, b; z = 0 rows for 2D),
    ``deltas [..., 2]`` and ``initial_guess [..., 2]``."""
    sensors = sensors.to(torch.float32)
    deltas = deltas.to(torch.float32)
    p = initial_guess.to(torch.float32)
    batch = p.shape[:-1]
    done = torch.zeros(batch, dtype=torch.bool, device=p.device)
    ok = torch.ones(batch, dtype=torch.bool, device=p.device)
    for _ in range(max_iter):
        if not unroll and bool(done.all()):
            break
        f, jac = _residual_jac_3d(p, sensors, deltas)
        step, solvable = _solve_2x2(jac, f)
        converged = torch.amax(torch.abs(step), dim=-1) < xtol
        live = ~done
        p = torch.where(live[..., None], p - step, p)
        ok = torch.where(live, ok & solvable, ok)
        done = done | (live & (converged | ~solvable))
    f, _ = _residual_jac_3d(p, sensors, deltas)
    success = (
        ok & done & torch.all(torch.isfinite(p), dim=-1)
        & (torch.amax(torch.abs(f), dim=-1)
           < 10 * xtol * (1 + torch.amax(torch.abs(deltas), dim=-1)))
    )
    return p, success


def solve_trilateration(sensor_a, sensor_b, sensor_origin, delta_d_a,
                        delta_d_b, initial_guess):
    """2D host API (multilateration.py:170-227): the (x, y) tuple, or None
    on failure."""
    sensors = torch.tensor([[*sensor_origin, 0.0], [*sensor_a, 0.0],
                            [*sensor_b, 0.0]], dtype=torch.float32)
    p, ok = solve_tdoa(sensors, torch.tensor([delta_d_a, delta_d_b]),
                       torch.as_tensor(initial_guess, dtype=torch.float32))
    return tuple(map(float, p)) if bool(ok) else None


def solve_trilateration_3d(sensor_a, sensor_b, sensor_origin, delta_d_a,
                           delta_d_b, initial_guess):
    """3D host API (multilateration.py:230-316), the strike on z = 0."""
    sensors = torch.tensor([sensor_origin, sensor_a, sensor_b],
                           dtype=torch.float32)
    p, ok = solve_tdoa(sensors, torch.tensor([delta_d_a, delta_d_b]),
                       torch.as_tensor(initial_guess, dtype=torch.float32))
    return tuple(map(float, p)) if bool(ok) else None


def trilaterate_batch(sensors: torch.Tensor, deltas: torch.Tensor,
                      initial_guesses: torch.Tensor, xtol: float = 0.01,
                      max_iter: int = 20
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched solve: ``sensors [H, 3, 3]``, ``deltas [H, 2]``, guesses
    ``[H, 2]`` → ``(points [H, 2], success [H])``, with no host read."""
    return solve_tdoa(sensors, deltas, initial_guesses, xtol=xtol,
                      max_iter=max_iter, unroll=True)
