"""The port's optimizers against optax: every ``make_optimizer``
combination (nadam, adam, sgd x cosine_restarts, cosine, constant x clip
on/off x weight decay on/off) for 20 updates on the same fixed gradients,
params within 1e-6; the schedules' values; torch's ``SGD`` behind sgd and
torch's ``Adam`` computing the same method as adam (within 1e-5)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onset_fingerprinting_tpu.models import train as jtrain
from onset_fingerprinting_torch.models import train as ttrain

COMBOS = list(itertools.product(
    ("nadam", "adam", "sgd"), ("cosine_restarts", "cosine", "constant"),
    (0.0, 1.0), (0.0, 1e-2)))


def fixed_grads(steps=20, seed=0):
    """Per update, gradients for a [3, 4] and a [5] parameter whose global
    norm wanders across 1.0 (so that the clip acts on some updates)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        scale = 0.3 if t % 3 == 0 else 2.0
        out.append([rng.normal(0, scale / 3, (3, 4)).astype(np.float32),
                    rng.normal(0, scale / 3, (5,)).astype(np.float32)])
    return out


@pytest.mark.parametrize("name,schedule,clip,wd", COMBOS,
                         ids=lambda v: str(v))
def test_make_optimizer_matches_optax(name, schedule, clip, wd):
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=(3, 4)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    kw = dict(lr=2e-2, schedule=schedule, schedule_period=7,
              weight_decay=wd, grad_clip=clip)
    tx = jtrain.make_optimizer(name, **kw)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    chain = ttrain.make_optimizer(name, **kw)(tp)
    for g in fixed_grads():
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        chain.step()
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-6, rtol=0)
    assert chain.count == 20


def test_schedules_match_jax():
    for sched_t, sched_j in (
        (ttrain.cosine_warm_restarts(3e-3, 25),
         jtrain.cosine_warm_restarts(3e-3, 25)),
        (ttrain.cosine_decay_schedule(3e-3, 100),
         optax.cosine_decay_schedule(3e-3, 100)),
    ):
        for step in range(0, 260, 7):
            np.testing.assert_allclose(
                sched_t(step), float(sched_j(jnp.int32(step))), rtol=1e-6)
    # optax's cosine decay stays at 0 past its decay steps
    assert ttrain.cosine_decay_schedule(1.0, 10)(11) == 0.0


def test_sgd_is_torchs_and_torchs_adam_is_the_same_method():
    p = [torch.zeros(2, requires_grad=True)]
    sgd = ttrain.make_optimizer("sgd")(p).opt
    assert type(sgd) is torch.optim.SGD
    assert sgd.param_groups[0]["momentum"] == 0.8
    for name, nesterov in (("adam", False), ("nadam", True)):
        opt = ttrain.make_optimizer(name)(p).opt
        assert isinstance(opt, ttrain.OptaxAdam)
        assert opt.param_groups[0]["nesterov"] is nesterov
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer("rmsprop")
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    ours = torch.tensor(p0, requires_grad=True)
    theirs = torch.tensor(p0, requires_grad=True)
    a = ttrain.OptaxAdam([ours], lr=2e-2, weight_decay=1e-2)
    b = torch.optim.Adam([theirs], lr=2e-2, weight_decay=1e-2)
    for g in fixed_grads():
        ours.grad = torch.tensor(g[0])
        theirs.grad = torch.tensor(g[0])
        a.step()
        b.step()
    torch.testing.assert_close(ours, theirs, atol=1e-5, rtol=0)
    assert not torch.equal(ours, theirs)


def test_clip_is_optax_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    ttrain.clip_by_global_norm_(g, 1.0)
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.array([3.0, 4.0]), jnp.array([0.0])], None)[0]
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    small = [torch.tensor([0.3, 0.4])]
    ttrain.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))
