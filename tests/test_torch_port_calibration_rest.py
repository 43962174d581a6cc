"""The rest of ``locate/calibration.py`` (the TDOA losses, ``fit_tnc``,
``optimize_C``, ``calibrate``, ``optimize_positions``) against the JAX
package on the CPU, on numpy-seeded inputs.

The JAX losses run under ``jax.enable_x64`` on float32-rounded
observations, as the JAX fits call them; the port's take float64
parameters and the same float32-rounded observations.  Tolerances: the
lug layout and the helpers exactly or within 1 ulp of float32; losses and
gradients in float64 within 1e-12 relative (another order of summation);
the TNC fits within 1e-5 m (a line search on gradients that differ in the
last bits may stop one step apart); ``optimize_positions`` (float32 adam,
400-800 steps) within 1e-6 m and 1e-3 m/s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.coords import spherical_to_cartesian
from onset_fingerprinting_tpu.locate import calibration as J
from onset_fingerprinting_torch.locate import calibration as T

SR = 96000
C_SOUND = 343.0
RADIUS = 14 * 2.54 / 2 / 100


def _fixture():
    """The calibration demo's drum: true sensors, the 44 calibration
    sounds, their exact TDOAs and the onset matrix they imply."""
    true = np.array([tuple(map(float, spherical_to_cartesian(*p)))
                     for p in [(0.8 * RADIUS, 135, 80),
                               (0.8 * RADIUS, 15, 60), (0.15, 100, 20)]])
    sounds = np.asarray([(0.0, 0.0, 0.0)] * 4 + [
        tuple(map(float, spherical_to_cartesian(*p)))
        for p in J.calibration_locations(10, 4, RADIUS * 0.9, 0)])
    dists = np.linalg.norm(sounds[:, None, :] - true[None], axis=-1) \
        / C_SOUND
    tdoa = np.diff(dists, axis=1)
    onsets = np.cumsum(np.concatenate(
        [np.zeros((len(tdoa), 1)), tdoa * SR], axis=1), axis=1)
    return true, sounds, dists, tdoa, onsets


@pytest.mark.parametrize("args", [(4, 2, 0.1), (10, 4, 0.155, 0),
                                  (6, 3, 0.2, None, True)])
def test_calibration_locations_match_jax(args):
    assert T.calibration_locations(*args) == J.calibration_locations(*args)


def test_lug_sound_positions_match_jax():
    for args in ((0.155, 10, 4, 4), (0.16, 8, 2, 0)):
        np.testing.assert_allclose(np.asarray(T._lug_sound_positions(*args)),
                                   np.asarray(J._lug_sound_positions(*args)),
                                   rtol=1.2e-7, atol=1e-8)


def _vag64(fn, p, *args):
    with jax.enable_x64():
        v, g = jax.value_and_grad(lambda q: fn(q, *args))(
            jnp.asarray(p, jnp.float64))
        return float(v), np.asarray(g)


def _tvag(fn, p, *args):
    pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    v = fn(pt, *args)
    (g,) = torch.autograd.grad(v, pt)
    return float(v.detach()), g.numpy()


@pytest.mark.parametrize("norm", [1, 2])
def test_tdoa_losses_and_grads_match_jax(norm):
    true, sounds, _, tdoa, _ = _fixture()
    rng = np.random.default_rng(norm)
    p = (true + rng.normal(0, 0.01, true.shape)).ravel()
    sp32, td32 = sounds.astype(np.float32), tdoa.astype(np.float32)
    jv, jg = _vag64(J.tdoa_calib_loss, p, jnp.asarray(sp32),
                    jnp.asarray(td32), C_SOUND, norm)
    tv, tg = _tvag(T.tdoa_calib_loss, p, torch.as_tensor(sp32),
                   torch.as_tensor(td32), C_SOUND, norm)
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    np.testing.assert_allclose(tg, jg, rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(
        T.tdoa_calib_errors(p, sounds, tdoa, C_SOUND, norm, device="cpu"),
        J.tdoa_calib_errors(p, jnp.asarray(sp32), jnp.asarray(td32),
                            C_SOUND, norm), rtol=1e-5, atol=1e-12)
    for opt_c in (False, True):
        q = np.concatenate([[RADIUS * 0.85], [341.0] if opt_c else [], p])
        jv, jg = _vag64(lambda x, td: J.tdoa_calib_loss_with_sp(
            x, td, 10, 4, 4, norm, opt_c, C_SOUND), q, jnp.asarray(td32))
        tv, tg = _tvag(lambda x, td: T.tdoa_calib_loss_with_sp(
            x, td, 10, 4, 4, norm, opt_c, C_SOUND), q,
            torch.as_tensor(td32))
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-12)


def test_fit_tnc_matches_jax():
    true, sounds, _, tdoa, _ = _fixture()
    x0 = (true + np.random.default_rng(5).normal(0, 0.01, true.shape)).ravel()
    sp32, td32 = sounds.astype(np.float32), tdoa.astype(np.float32)
    rj = J.fit_tnc(J.tdoa_calib_loss, x0, args=(
        jnp.asarray(sp32), jnp.asarray(td32), C_SOUND, 2), maxfun=2000)
    rt = T.fit_tnc(T.tdoa_calib_loss, x0, args=(
        torch.as_tensor(sp32), torch.as_tensor(td32), C_SOUND, 2),
        maxfun=2000, device="cpu")
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-5)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-3, atol=1e-14)


def test_calibrate_matches_jax():
    true, sounds, _, tdoa, onsets = _fixture()
    kw = dict(sr=SR, C=C_SOUND, n_lugs=10, n_each=4, hits_at=0.9,
              center_hits=4, norm=2)
    ej = J.calibrate(onsets, **kw)
    et = T.calibrate(onsets, device="cpu", **kw)
    np.testing.assert_allclose(et, ej, atol=1e-5)
    d = np.linalg.norm(sounds[:, None, :] - et[None], axis=-1) / C_SOUND
    assert np.abs(np.diff(d, axis=1) - tdoa).mean() * SR < 2.0


def test_optimize_C_matches_jax():
    """The squared loss (norm=2): with the default L1 loss the inner TNC
    fits stop unconverged (maxfun=1000), so the scalar search over C reads
    a noisy objective and follows gradients' last bits, in either
    package."""
    true, _, _, _, _ = _fixture()
    sounds = np.asarray(J._lug_sound_positions(0.155, 10, 4, 4), np.float64)
    d = np.linalg.norm(sounds[:, None, :] - true[None], axis=-1) / 340.0
    tdoa = np.diff(d, axis=1)
    init = true + np.random.default_rng(2).normal(0, 0.002, true.shape)
    kw = dict(initial_sensor_positions=init, C_range=(336, 345), norm=2)
    pj, cj = J.optimize_C(tdoa, **kw)
    pt, ct = T.optimize_C(tdoa, device="cpu", **kw)
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    np.testing.assert_allclose(pt, pj, atol=1e-5)


@pytest.mark.parametrize("lossfun,epochs,patience", [("mse", 800, 50),
                                                     ("l1", 400, 10)])
def test_optimize_positions_matches_jax(lossfun, epochs, patience):
    true, sounds, dists, _, _ = _fixture()
    lags01 = (dists[:, :2] - dists[:, 2:]) * SR
    init = true + np.random.default_rng(0).normal(0, 0.002, true.shape)
    kw = dict(lr=0.05, lossfun=lossfun, num_epochs=epochs, C=C_SOUND, sr=SR,
              patience=patience)
    sj, dj, cj = J.optimize_positions(lags01, init, sounds, **kw)
    st, dt, ct = T.optimize_positions(lags01, init, sounds, device="cpu",
                                      **kw)
    np.testing.assert_allclose(st, sj, atol=1e-6)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert ct == pytest.approx(cj, abs=1e-3)
