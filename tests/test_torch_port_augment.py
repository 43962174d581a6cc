"""The port's augmentations (``onset_fingerprinting_torch.data.augment``)
against the JAX package's at JAX's draws, on the CPU.

The JAX package ``vmap``s each augmentation over rows with one key per row;
the test draws with those keys exactly as each JAX function does, feeds the
draws into the port's batched ``apply`` and compares with the ``vmap``ped
JAX result.  Bar: within 1e-5 of the result's scale, 1e-4 for the two
recursions (the seven-band EQ and the air absorption) and ``some_of``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.data import augment as J
from onset_fingerprinting_torch.data import augment as P

B, N = 6, 300
RECURSIVE = {"seven_band_eq", "air_absorption"}


def jax_draws(name, key, x, aug=None):
    """One example's draws, taken from ``key`` as the JAX function takes
    them."""
    aug = aug or getattr(P, name)
    if name == "gaussian_noise":
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (), minval=aug.min_amplitude,
                                   maxval=aug.max_amplitude),
                jax.random.normal(k2, x.shape, x.dtype))
    if name == "seven_band_eq":
        return jax.random.uniform(key, (7,), minval=aug.min_gain_db,
                                  maxval=aug.max_gain_db)
    if name == "air_absorption":
        return jax.random.uniform(key, (), minval=aug.min_distance,
                                  maxval=aug.max_distance)
    return jax.random.uniform(key, (), minval=aug.min_distortion,
                              maxval=aug.max_distortion)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.tensor(np.asarray(v)),
                                  tree)


def batch(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    x = (rng.normal(0, 0.05, (B, N))
         + np.sin(2 * np.pi * 3000 * t / 96000) * np.exp(-t / 80)
         * rng.uniform(0.2, 1.0, (B, 1)))
    return x.astype(np.float32)


def close(port, ref, rel):
    ref = np.asarray(ref)
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


@pytest.mark.parametrize("name", ["gaussian_noise", "seven_band_eq",
                                  "air_absorption", "tanh_distortion"])
@pytest.mark.parametrize("sr", [96000, 22050])
def test_augmentation_at_jax_draws(name, sr):
    x = batch(sr)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax.vmap(lambda k, r: getattr(J, name)(k, r, sr))(
        keys, jnp.asarray(x))
    draws = jax.vmap(lambda k, r: jax_draws(name, k, r))(keys,
                                                        jnp.asarray(x))
    port = getattr(P, name).apply(torch.tensor(x), to_torch(draws), sr)
    close(port, ref, 1e-4 if name in RECURSIVE else 1e-5)


def test_parameters_carry_over():
    """Non-default ranges reach the draws, as the JAX keyword arguments."""
    x = batch(1)
    key = jax.random.PRNGKey(9)
    ref = J.seven_band_eq(key, jnp.asarray(x[0]), min_gain_db=-3.0,
                          max_gain_db=6.0)
    aug = P.SevenBandEQ(-3.0, 6.0)
    d = jax_draws("seven_band_eq", key, jnp.asarray(x[0]), aug)
    close(aug.apply(torch.tensor(x[0]), to_torch(d)), ref, 1e-4)
    g = torch.Generator().manual_seed(0)
    out = P.seven_band_eq(g, torch.tensor(x), min_gain_db=-3.0,
                          max_gain_db=6.0)
    g.manual_seed(0)
    gains = aug.draws(g, torch.tensor(x))
    assert float(gains.min()) >= -3.0 and float(gains.max()) <= 6.0
    torch.testing.assert_close(out, aug.apply(torch.tensor(x), gains),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_some_of_at_jax_draws(seed):
    x = batch(10 + seed)
    n = len(J.AUGMENTATIONS)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    ref = jax.vmap(lambda k, r: J.some_of(k, r))(keys, jnp.asarray(x))

    def one(key, r):
        k_key, sel_key, *aug_keys = jax.random.split(key, 2 + n)
        k = jax.random.randint(k_key, (), 0, 4)
        order = jax.random.permutation(sel_key, n)
        chosen = jnp.zeros((n,), bool).at[order[:3]].set(jnp.arange(3) < k)
        return chosen, [jax_draws(fn.__name__, ak, r)
                        for fn, ak in zip(J.AUGMENTATIONS, aug_keys)]

    chosen, draws = jax.vmap(one)(keys, jnp.asarray(x))
    port = P.some_of_apply(torch.tensor(x), to_torch(chosen),
                           to_torch(draws))
    close(port, ref, 1e-4)


def test_port_draws_are_per_row():
    """The port's own draws: one per row (a row's result does not depend on
    the other rows), ``tanh_distortion`` RMS-matched per row, ``some_of``
    choosing 0-3 augmentations per row, and the call equal to its draws
    then its apply."""
    x = torch.tensor(batch(4))
    x[0] *= 10.0
    g = torch.Generator().manual_seed(1)
    y = P.tanh_distortion(g, x)
    rms = lambda a: a.pow(2).mean(-1).sqrt()  # noqa: E731
    torch.testing.assert_close(rms(y), rms(x), rtol=1e-5, atol=0)
    g.manual_seed(2)
    chosen, draws = P.some_of_draws(g, x)
    assert chosen.shape == (B, 4) and int(chosen.sum(-1).max()) <= 3
    assert draws[0][1].shape == x.shape and draws[2].shape == (B, 7)
    g.manual_seed(2)
    out = P.some_of(g, x)
    torch.testing.assert_close(out, P.some_of_apply(x, chosen, draws),
                               rtol=0, atol=0)
    kept = ~chosen.any(-1)
    torch.testing.assert_close(out[kept], x[kept], rtol=0, atol=0)
    one = P.some_of_apply(x[1:2], chosen[1:2], [
        tuple(t[1:2] for t in d) if isinstance(d, tuple) else d[1:2]
        for d in draws])
    torch.testing.assert_close(one, out[1:2], rtol=1e-6, atol=1e-7)
