"""Online multilateration of a drum strike from three sensors' onsets,
written plainly in NumPy: the reference repository's ``Multilaterate3D``
(``multilateration.py``): candidate groups of onsets, pairwise legality by
lag maps, three-way feasibility through a cascade of tolerances, and a
Newton solve of the two TDOA hyperbolae from the feasible cell.

``q`` rounds after every operation of the Newton solve: the identity for
the float32 reference, ``detector.to_bf16`` for the control.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.detector import ident

F32 = np.float32


def sensor_positions(polar, radius: float) -> np.ndarray:
    """``[(r, phi, theta)]`` (r a share of the radius, angles in degrees,
    theta the elevation) → ``[S, 3]`` float32 cm."""
    out = []
    for r, phi, theta in polar:
        phi = np.deg2rad(F32(phi))
        incl = np.deg2rad(F32(-theta if theta < 0 else 90.0 - theta))
        rr = F32(r * radius)
        out.append([rr * np.cos(phi) * np.sin(incl),
                    rr * np.sin(phi) * np.sin(incl), rr * np.cos(incl)])
    return np.asarray(out, np.float32)


def lag_map(a, b, diameter: float, sr: int, c: float, tol: float = 2.0):
    """Expected onset lag in samples of sensor ``a`` after sensor ``b`` at
    every cm cell of the playing surface (z = 0), NaN outside the drum
    plus ``tol`` cm."""
    r = int(np.round(diameter, 1)) // 2
    ax = np.arange(-r, r + 1)
    j, i = np.meshgrid(ax, ax, indexing="ij")
    outside = i ** 2 + j ** 2 > (r + tol) ** 2
    i, j = i.astype(np.float32), j.astype(np.float32)
    ta = np.sqrt((i - a[0]) ** 2 + (j - a[1]) ** 2 + F32(a[2] ** 2)) / F32(c)
    tb = np.sqrt((i - b[0]) ** 2 + (j - b[1]) ** 2 + F32(b[2] ** 2)) / F32(c)
    lm = np.round((ta - tb) * F32(sr)).astype(np.float32)
    return np.where(outside, np.float32(np.nan), lm)


class Locator:
    """Strikes from onset events, one stream at a time."""

    def __init__(self, polar, diameter: float, sr: int, c_cm_s: float,
                 tols=(1.0,), q=ident):
        self.radius = diameter / 2
        self.xyz = sensor_positions(polar, self.radius)
        self.sr, self.c = sr, c_cm_s
        self.spc = sr / c_cm_s
        self.tols = tuple(tols)
        self.q = q
        n = len(polar)
        self.maps, self.lo, self.hi = {}, {}, {}
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                lm = lag_map(self.xyz[j], self.xyz[i], diameter, sr, c_cm_s)
                lm[lm < -self.spc] = np.nan
                self.maps[i, j] = lm
                self.lo[i, j], self.hi[i, j] = np.nanmin(lm), np.nanmax(lm)
        self.reach = [max(self.hi[i, j] for j in range(n) if j != i)
                      for i in range(n)]

    def _cell(self, sensors, onsets):
        lag1, lag2 = onsets[1] - onsets[0], onsets[2] - onsets[0]
        lm1 = self.maps[sensors[0], sensors[1]]
        lm2 = self.maps[sensors[0], sensors[2]]
        for t in self.tols:
            tol = t * self.spc
            with np.errstate(invalid="ignore"):
                ok = ((lm1 < lag1 + tol) & (lm1 > lag1 - tol)
                      & (lm2 < lag2 + tol) & (lm2 > lag2 - tol))
            cell = np.unravel_index(np.argmax(ok), ok.shape, "F")
            if tuple(cell) != (0, 0):
                return cell
        return None

    def solve(self, sensors, onsets, guess, xtol=0.01, iters=20):
        """Newton on the two hyperbolae from ``guess`` → point or None."""
        q = self.q
        s = self.xyz[list(sensors)]
        k = F32(self.c / self.sr)
        dl = np.array([q(F32(onsets[1] - onsets[0]) * k),
                       q(F32(onsets[2] - onsets[0]) * k)], np.float32)
        p = np.asarray(guess, np.float32)

        def residual(p):
            diff = q(np.array([p[0], p[1], 0], np.float32)[None] - s)
            dist = q(np.sqrt(q(q(diff[:, 0] ** 2 + diff[:, 1] ** 2)
                                + diff[:, 2] ** 2)))
            f = q(q(dist[1:] - dist[0]) - dl)
            g = q(diff[:, :2] / dist[:, None])
            return f, q(g[1:] - g[0])

        ok, done = True, False
        for _ in range(iters):
            f, j = residual(p)
            det = q(q(j[0, 0] * j[1, 1]) - q(j[0, 1] * j[1, 0]))
            solvable = abs(det) >= 1e-12
            safe = det if solvable else F32(1.0)
            step = q(np.array([q(j[1, 1] * f[0]) - q(j[0, 1] * f[1]),
                               q(-j[1, 0] * f[0]) + q(j[0, 0] * f[1])],
                              np.float32) / safe)
            p = q(p - step)
            ok = ok and solvable
            if np.max(np.abs(step)) < xtol or not solvable:
                done = True
                break
        f, _ = residual(p)
        good = (ok and done and np.all(np.isfinite(p))
                and np.max(np.abs(f)) < 10 * xtol * (1 + np.max(np.abs(dl))))
        return p if good else None

    def run(self, onsets, channels):
        """Feed one stream's events in order → ``(points [E, 2], emits
        [E])``."""
        e = len(onsets)
        pts = np.zeros((e, 2), np.float32)
        emits = np.zeros(e, bool)
        groups = []  # [sensors], [onsets], in insertion order
        for n, (sensor, onset) in enumerate(zip(channels, onsets)):
            kept, done = [], False
            for sens, ons in groups:
                lag = onset - ons[0]
                if lag > self.reach[sens[0]]:
                    continue
                if len(sens) < 3 and sensor not in sens and \
                        self.lo[sens[0], sensor] < lag < self.hi[sens[0],
                                                                 sensor]:
                    sens, ons = sens + [sensor], ons + [onset]
                    if len(sens) == 3:
                        cell = self._cell(sens, ons)
                        if cell is not None:
                            p = self.solve(sens, ons,
                                           F32(np.array(cell) - self.radius))
                            if p is not None:
                                pts[n], emits[n] = p, True
                                kept = [g for g in kept
                                        if (g[0][0], g[1][0])
                                        != (sens[0], ons[0])]
                            groups, done = kept, True
                            break
                kept.append((sens, ons))
            if not done:
                groups = kept + [([sensor], [onset])]
        return pts, emits
