"""``parallel/`` against the JAX package's on two devices.

The JAX functions run here on a 2-device virtual CPU mesh
(tests/conftest.py gives 8 CPU devices).  The port's run in two processes
joined by a gloo process group (``init_distributed(device="cpu")``), as
tests/test_distributed.py spawns its workers: one pair of processes runs
every case once and writes each rank's results under ``tmp_path``.  Both
ranks must hold the same global result, and rank 0's is held to JAX's:
events (on, deltas, starts, valid, onsets, emits, drop counts) exactly,
``rel`` within atol 2e-2 (the JAX suite's own detector bar), predictions
within 1e-5, located points within 1e-3 cm where emitted; the meshed
trainer (a CNN with BatchNorm, 5 nadam steps) within 1e-4 of JAX's meshed
trainer, and with dropout equal to the port's unmeshed trainer (a global
mask drawn from one generator).  The mesh helpers and the stream-batched
locate entry's plain version (against JAX's ``lax.scan``) run in this
process.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import (
    DetectorConfig as JDetectorConfig,
    TrainConfig as JTrainConfig,
)
from onset_fingerprinting_tpu.detect.amplitude import (
    detect_offline as j_detect_offline,
    detector_init as j_detector_init,
)
from onset_fingerprinting_tpu.parallel import (
    detect_events_time_sharded as j_events,
    detect_fingerprint_sharded as j_fingerprint,
    detect_offline_sharded as j_offline_sharded,
    detect_offline_time_sharded as j_time_sharded,
    make_detect_locate_sharded as j_locate_sharded,
    make_mesh as j_make_mesh,
)
from onset_fingerprinting_tpu.parallel.sharding import (
    events_from_dense as j_events_from_dense,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
SR = 96000
#: the shapes of the cases (small: the plain detector loops per sample)
BATCH = (4, 128 * 24, 2)
LONG_T = 128 * 40 * 2 + 1000  # 1000 samples past the 2-device floor
HALO = 128 * 30
FP = dict(T=128 * 30, C=2, S=4, W=128, K=4)
LOC = dict(S=4, T=128 * 60, E=16, W=128)
ZONES = dict(output_size=4, layer_sizes=(4, 6), kernel_size=5, pool=True,
             batch_norm=True, dropout_rate=0.0)
TRAIN_CFG = dict(lr=1e-2, num_epochs=5, min_epochs=1, patience=3, seed=0,
                 loss="xent")
STEPS = 5


def synth(T, C, seed=0, spacing=6000, start=3000):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-4, (T, C)).astype(np.float32)
    t = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 120) * 0.5)
    for base in range(start, T - 700, spacing):
        x[base: base + 600] += burst[:, None].astype(np.float32)
    return x


def long_recording():
    """A recording whose last onset lies in the samples past the 2-device
    floor (the ones floor truncation would drop)."""
    x = synth(LONG_T, 2, seed=5)
    x[LONG_T - 1800:] = np.random.default_rng(9).normal(
        0, 1e-4, (1800, 2)).astype(np.float32)
    t = np.arange(300)
    burst = np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 60) * 0.5
    x[LONG_T - 800: LONG_T - 500] += burst[:, None].astype(np.float32)
    return x


def drum_streams():
    """``[S, T, 3]`` streams of two strikes each on the realtime demo's
    drum (tests/test_parallel.py's serve-path fixture, shorter)."""
    from onset_fingerprinting_tpu.core.coords import (
        polar_to_cartesian,
        speed_of_sound,
    )

    radius = 14 * 2.54 / 2
    polar = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
    c = speed_of_sound(100, medium="drumhead")
    xy = [polar_to_cartesian(r * radius, phi) for (r, phi, _) in polar]
    rng = np.random.default_rng(3)
    s_, t_ = LOC["S"], LOC["T"]
    streams = rng.normal(0, 1e-4, (s_, t_, 3)).astype(np.float32)
    tt = np.arange(600)
    burst = (np.sin(2 * np.pi * 4000 / SR * tt) * np.exp(-tt / 150)
             * 0.6).astype(np.float32)
    for s in range(s_):
        for k, base in enumerate((1500, 4500)):
            r = (0.2 + 0.5 * ((s + k) % 4) / 4) * radius
            x, y = polar_to_cartesian(r, 45.0 * s + 120.0 * k)
            for ch, (sx, sy) in enumerate(xy):
                d = int(round(np.hypot(x - sx, y - sy) / c * SR))
                streams[s, base + d: base + d + 600, ch] += burst
    return polar, streams


def head_weights(c, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.05, (2, c * w)).astype(np.float32),
            rng.normal(0, 0.1, 2).astype(np.float32))


_WORKER = textwrap.dedent(
    """
    import sys, warnings
    pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from torch import nn
    torch.set_num_threads(1)
    from onset_fingerprinting_torch.parallel import (
        detect_events_time_sharded, detect_fingerprint_sharded,
        detect_offline_sharded, detect_offline_time_sharded,
        init_distributed, make_detect_locate_sharded, make_mesh)
    from onset_fingerprinting_torch.core.config import DetectorConfig, TrainConfig
    from onset_fingerprinting_torch.detect.amplitude import detector_init
    from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
    from onset_fingerprinting_torch.models.cnn import CNN
    from onset_fingerprinting_torch.models.train import Trainer

    assert init_distributed(f"localhost:{{port}}", nproc, pid, device="cpu")
    import torch.distributed as dist
    assert dist.get_backend() == "gloo"
    mesh = make_mesh((nproc,), ("data",), device="cpu")
    inp = dict(np.load(out + "/inputs.npz"))
    res = {{}}

    class Head(nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.fc = nn.Linear(w.shape[1], 2)
            with torch.no_grad():
                self.fc.weight.copy_(torch.as_tensor(w))
                self.fc.bias.copy_(torch.as_tensor(b))
        def forward(self, x):
            return self.fc(x.reshape(x.shape[0], -1))

    def det(n, **kw):
        return detector_init(DetectorConfig(n_channels=n, block_size=128,
                                            hipass_freq=0.0, sr=96000, **kw),
                             "cpu")

    st, pa, s0 = det(2)
    on, d, rel = detect_offline_sharded(st, pa, s0, inp["batch"], mesh)
    res.update(batch_on=on, batch_d=d, batch_rel=rel)
    on, d, rel = detect_offline_time_sharded(st, pa, s0, inp["long"], mesh,
                                             halo={halo})
    res.update(long_on=on, long_d=d, long_rel=rel)
    ch, ons = detect_events_time_sharded(st, pa, s0, inp["long"], mesh,
                                         halo={halo})
    res.update(ev_ch=ch, ev_on=ons)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ch, ons, dr = detect_events_time_sharded(
            st, pa, s0, inp["long"], mesh, halo={halo}, capacity=1,
            return_dropped=True)
    res.update(ov_ch=ch, ov_on=ons, ov_dropped=dr,
               ov_warned=np.array(any("dropped" in str(x.message) for x in w)))

    fp = {fp!r}
    st, pa, s0 = det(fp["C"], coupled_off_gate=False)
    head = Head(inp["head_w"], inp["head_b"])
    kw = dict(window=fp["W"], pre=32, capacity=fp["K"])
    cases = dict(
        stream=(inp["fp"], kw),
        wide=(inp["fp_wide"], dict(kw, layout="wide",
                                    channels_per_stream=fp["C"])),
        compact=(inp["fp"], dict(kw, compact_capacity=fp["K"] * fp["S"])),
        under=(inp["fp"], dict(kw, compact_capacity=1)))
    for name, (x, k) in cases.items():
        p, s, v, dr = detect_fingerprint_sharded(st, pa, s0, x, mesh, head,
                                                 **k)
        res.update({{f"fp_{{name}}_preds": p, f"fp_{{name}}_starts": s,
                     f"fp_{{name}}_valid": v, f"fp_{{name}}_dropped": dr}})

    loc = {loc!r}
    st, pa, s0 = det(3, backtrack=True)
    locator = Multilaterate3D([tuple(r) for r in inp["polar"]],
                              drum_diameter=14 * 2.54, medium="drumhead",
                              sr=96000)
    lhead = Head(inp["lhead_w"], inp["lhead_b"])
    run = make_detect_locate_sharded(
        st, pa, s0, inp["streams"].shape, mesh, locator, model=lhead,
        event_capacity=loc["E"], window=loc["W"], pre=32)
    pts, ons, em, pr = run(inp["streams"])
    res.update(loc_points=pts, loc_onsets=ons, loc_emits=em, loc_preds=pr)

    # the meshed trainer: BatchNorm over the global batch (JAX's init),
    # then with dropout against the unmeshed trainer
    cfg = TrainConfig(**{train_cfg!r})
    x, y = torch.as_tensor(inp["tx"]), torch.as_tensor(inp["ty"]).long()
    for drop in (0.0, 0.3):
        model = CNN(32, 3, **dict({zones!r}, dropout_rate=drop))
        for meshed in (True, False):
            tr = Trainer(model, cfg, device="cpu",
                         mesh=mesh if meshed else None)
            s = tr.init_state()
            s.module.load_state_dict(torch.load(out + "/init.pt"))
            losses = [float(tr.step(s, x, y)) for _ in range({steps})]
            tag = f"train_{{drop}}_{{meshed}}"
            res[tag + "_losses"] = np.array(losses)
            for k, v in s.module.state_dict().items():
                res[tag + "_" + k] = v.numpy()

    # the HPO loop with its trainers on the mesh
    from onset_fingerprinting_torch.models.experiment import run_location_hpo
    study = run_location_hpo(out + "/hpo", "combined0", n_trials=2,
                             num_epochs=2, min_epochs=0, subsample=5,
                             mesh=mesh, device="cpu")
    res["hpo_values"] = np.array([t.value for t in study.results],
                                 dtype=float)
    res["hpo_test"] = np.array(study.best_trial.user_attrs["test_l1"])

    res = {{k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in res.items()}}
    np.savez(out + f"/rank{{pid}}.npz", **res)
    dist.destroy_process_group()
    print("WORKER_OK", pid)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cnn_init():
    from onset_fingerprinting_tpu.models.cnn import CNN as JCNN
    from onset_fingerprinting_tpu.models.train import Trainer as JTrainer
    from onset_fingerprinting_torch.models.jax_import import (
        cnn_state_dict_from_flax,
    )

    jt = JTrainer(JCNN(**ZONES), JTrainConfig(**TRAIN_CFG),
                  mesh=j_make_mesh((2,), ("data",)))
    jstate = jt.init_state(jnp.zeros((1, 3, 32), jnp.float32))
    sd = cnn_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    return jt, jstate, sd


def zone_data():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (28, 3, 32)).astype(np.float32)
    y = rng.integers(0, 4, 28).astype(np.int32)
    x[np.arange(28), y % 3, :4] += 2.0
    return x, y


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, after checking that they hold the same global
    result, and the inputs."""
    out = tmp_path_factory.mktemp("parallel")
    polar, streams = drum_streams()
    fp = np.stack([synth(FP["T"], FP["C"], seed=100 + i, spacing=1700)
                   for i in range(FP["S"])])
    hw, hb = head_weights(FP["C"], FP["W"], 0)
    lw, lb = head_weights(3, LOC["W"], 1)
    tx, ty = zone_data()
    inp = dict(
        batch=np.stack([synth(BATCH[1], BATCH[2], seed=i, spacing=1200,
                              start=600 + 100 * i)
                        for i in range(BATCH[0])]),
        long=long_recording(), fp=fp,
        fp_wide=np.ascontiguousarray(np.moveaxis(fp, 0, 1).reshape(
            FP["T"], FP["S"] * FP["C"])),
        head_w=hw, head_b=hb, lhead_w=lw, lhead_b=lb,
        polar=np.array(polar), streams=streams, tx=tx, ty=ty)
    np.savez(out / "inputs.npz", **inp)
    from onset_fingerprinting_torch.data.synth import synth_location_session

    synth_location_session(out / "hpo", n_hits=24, sr=SR, seed=0)
    _, _, sd = _jax_cnn_init()
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               out / "init.pt")
    worker = out / "worker.py"
    worker.write_text(_WORKER.format(repo=str(REPO), halo=HALO, fp=FP,
                                     loc=LOC, train_cfg=TRAIN_CFG,
                                     zones=ZONES, steps=STEPS))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in o, \
            f"worker {i} failed:\n{o[-3000:]}"
    r0 = dict(np.load(out / "rank0.npz"))
    r1 = dict(np.load(out / "rank1.npz"))
    return r0, r1, dict(inp, _dir=str(out / "inputs.npz"))


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return j_make_mesh((2,), ("data",))


def _jdet(n, **kw):
    return j_detector_init(JDetectorConfig(
        n_channels=n, block_size=128, hipass_freq=0.0, sr=SR, **kw))


def test_ranks_hold_the_same_global_result(run):
    r0, r1, _ = run
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_detect_offline_sharded_matches_jax(run, jmesh):
    r0, _, inp = run
    st, pa, s0 = _jdet(2)
    on, d, rel = j_offline_sharded(st, pa, s0, jnp.asarray(inp["batch"]),
                                   jmesh)
    np.testing.assert_array_equal(r0["batch_on"], np.asarray(on))
    np.testing.assert_array_equal(r0["batch_d"], np.asarray(d))
    np.testing.assert_allclose(r0["batch_rel"], np.asarray(rel), atol=2e-2)
    assert r0["batch_on"].sum() > 0


def test_detect_offline_time_sharded_matches_jax(run, jmesh):
    """Including the samples past the devices' whole-block floor: the
    tail's onset is kept, as sequentially."""
    r0, _, inp = run
    st, pa, s0 = _jdet(2)
    x = inp["long"]
    on, d, rel = j_time_sharded(st, pa, s0, jnp.asarray(x), jmesh, halo=HALO)
    np.testing.assert_array_equal(r0["long_on"], np.asarray(on))
    np.testing.assert_array_equal(r0["long_d"], np.asarray(d))
    np.testing.assert_allclose(r0["long_rel"], np.asarray(rel), atol=2e-2)
    assert r0["long_on"].shape[0] == LONG_T // 128
    _, (on_r, d_r, _) = j_detect_offline(
        st, pa, s0, jnp.asarray(x[: LONG_T // 128 * 128]))
    want = set(zip(*j_events_from_dense(np.asarray(on_r), np.asarray(d_r),
                                        128)))
    from onset_fingerprinting_torch.parallel.sharding import (
        events_from_dense,
    )

    got = set(zip(*events_from_dense(r0["long_on"], r0["long_d"], 128)))
    assert got == want and any(o >= LONG_T - 1000 for _, o in want)


def test_detect_events_time_sharded_matches_jax(run, jmesh):
    """The all-gathered event list, and the overflow: the same drops, the
    same kept events and a warning on each side."""
    r0, _, inp = run
    st, pa, s0 = _jdet(2)
    x = jnp.asarray(inp["long"])
    ch, ons = j_events(st, pa, s0, x, jmesh, halo=HALO)
    np.testing.assert_array_equal(r0["ev_ch"], np.asarray(ch))
    np.testing.assert_array_equal(r0["ev_on"], np.asarray(ons))
    assert len(ons) >= 3
    with pytest.warns(UserWarning, match="dropped"):
        ch, ons, dr = j_events(st, pa, s0, x, jmesh, halo=HALO, capacity=1,
                               return_dropped=True)
    assert bool(r0["ov_warned"]) and dr.sum() > 0
    np.testing.assert_array_equal(r0["ov_dropped"], dr)
    np.testing.assert_array_equal(r0["ov_ch"], np.asarray(ch))
    np.testing.assert_array_equal(r0["ov_on"], np.asarray(ons))


@pytest.mark.parametrize("case", ["stream", "wide", "compact", "under"])
def test_detect_fingerprint_sharded_matches_jax(run, jmesh, case):
    """Both layouts, the compact route with ample and under-budget
    capacity (per-device drop counts), and the padded route."""
    from flax import linen as nn

    r0, _, inp = run
    st, pa, s0 = _jdet(FP["C"], coupled_off_gate=False)

    class Head(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2)(x.reshape(x.shape[0], -1))

    mp = {"params": {"Dense_0": {"kernel": jnp.asarray(inp["head_w"].T),
                                 "bias": jnp.asarray(inp["head_b"])}}}
    kw = dict(window=FP["W"], pre=32, capacity=FP["K"])
    x = inp["fp"]
    if case == "wide":
        x = inp["fp_wide"]
        kw.update(layout="wide", channels_per_stream=FP["C"])
    elif case == "compact":
        kw.update(compact_capacity=FP["K"] * FP["S"])
    elif case == "under":
        kw.update(compact_capacity=1)
    p, s, v, dr = j_fingerprint(st, pa, s0, jnp.asarray(x), jmesh, Head(),
                                mp, **kw)
    np.testing.assert_array_equal(r0[f"fp_{case}_starts"], np.asarray(s))
    np.testing.assert_array_equal(r0[f"fp_{case}_valid"], np.asarray(v))
    np.testing.assert_array_equal(r0[f"fp_{case}_dropped"], np.asarray(dr))
    np.testing.assert_allclose(r0[f"fp_{case}_preds"], np.asarray(p),
                               atol=1e-5)
    assert np.asarray(v).any()
    if case == "under":
        assert np.asarray(dr).sum() > 0


def test_detect_locate_sharded_matches_jax(run, jmesh):
    """The serve datapath: the same onsets and emits per stream, points
    within 1e-3 cm where emitted, the classifier's predictions on the
    located slots within 1e-5 and zero elsewhere."""
    from flax import linen as nn

    from onset_fingerprinting_tpu.locate import Multilaterate3D

    r0, _, inp = run
    st, pa, s0 = _jdet(3, backtrack=True)
    locator = Multilaterate3D(
        sensor_locations=[tuple(r) for r in inp["polar"]],
        drum_diameter=14 * 2.54, medium="drumhead", sr=SR)

    class Head(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2)(x.reshape(x.shape[0], -1))

    mp = {"params": {"Dense_0": {"kernel": jnp.asarray(inp["lhead_w"].T),
                                 "bias": jnp.asarray(inp["lhead_b"])}}}
    run_j = j_locate_sharded(st, pa, s0, inp["streams"].shape, jmesh,
                             locator, model=Head(), event_capacity=LOC["E"],
                             window=LOC["W"], pre=32)
    pts, ons, em, pr = (np.asarray(v) for v in run_j(
        jnp.asarray(inp["streams"]), mp))
    np.testing.assert_array_equal(r0["loc_onsets"], ons)
    np.testing.assert_array_equal(r0["loc_emits"], em)
    assert em.sum() >= LOC["S"]
    np.testing.assert_allclose(r0["loc_points"][em], pts[em], atol=1e-3)
    assert not r0["loc_points"][~em].any()
    np.testing.assert_allclose(r0["loc_preds"], pr, atol=1e-5)


def test_meshed_trainer_matches_jax_meshed_trainer(run):
    """5 nadam steps of a CNN with BatchNorm over a 2-rank mesh against
    JAX's trainer on a 2-device mesh: losses and weights (BatchNorm's
    running statistics included) within 1e-4."""
    from onset_fingerprinting_torch.models.jax_import import (
        cnn_state_dict_from_flax,
    )

    r0, _, inp = run
    jt, jstate, _ = _jax_cnn_init()
    step = jt.make_train_step()
    x, y = jnp.asarray(inp["tx"]), jnp.asarray(inp["ty"])
    losses = []
    for _ in range(STEPS):
        jstate, loss = step(jstate, x, y)
        losses.append(float(loss))
    np.testing.assert_allclose(r0["train_0.0_True_losses"], losses,
                               rtol=1e-4, atol=1e-6)
    want = cnn_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    for k, v in want.items():
        np.testing.assert_allclose(r0[f"train_0.0_True_{k}"], v,
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_meshed_trainer_with_dropout_equals_unmeshed(run):
    """With dropout the meshed step draws the global batch's mask from the
    one generator, and BatchNorm takes global statistics: the losses and
    weights equal the unmeshed trainer's on the whole batch."""
    r0, _, _ = run
    a, b = "train_0.3_True_", "train_0.3_False_"
    np.testing.assert_allclose(r0[a + "losses"], r0[b + "losses"],
                               rtol=1e-5)
    for k in r0:
        if k.startswith(a):
            np.testing.assert_allclose(r0[k], r0[b + k[len(a):]], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_locate_streams_reference_matches_jax_scan():
    """The stream-batched locate entry's plain version against the JAX
    function's ``lax.scan`` of ``make_locate_update`` (sharding.py:655-
    673): the same emits, points within 1e-4 cm where emitted."""
    from onset_fingerprinting_tpu.locate.multilaterate import (
        Multilaterate3D as JM,
        locator_init as j_locator_init,
        make_locate_update as j_update,
    )
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        EV_BIG,
        LocateBlock,
        locate_streams,
    )

    polar, streams = drum_streams()
    st, pa, s0 = _jdet(3, backtrack=True)
    rows = []
    for s in range(2):
        _, (on, d, _) = j_detect_offline(st, pa, s0, jnp.asarray(streams[s]))
        ch, ons = j_events_from_dense(np.asarray(on), np.asarray(d), 128)
        rows.append(sorted(zip(ons, ch)))
    rows.append(rows[0][1:] + rows[1][:2])  # a stream starting mid-group
    e = max(len(r) for r in rows) + 2
    ev_on = np.full((len(rows), e), EV_BIG, np.int32)
    ev_ch = np.zeros((len(rows), e), np.int32)
    for s, r in enumerate(rows):
        ev_on[s, : len(r)] = [o for o, _ in r]
        ev_ch[s, : len(r)] = [c for _, c in r]
    kw = dict(drum_diameter=14 * 2.54, medium="drumhead", sr=SR)
    upd = j_update(JM(polar, **kw), capacity=8)

    def step(ls, ev):
        onset, sensor = ev
        valid = onset < EV_BIG
        new, point, emit = upd(ls, sensor, onset)
        ls = jax.tree.map(lambda n_, o_: jnp.where(valid, n_, o_), new, ls)
        return ls, (point, valid & emit)

    lb = LocateBlock(Multilaterate3D(polar, **kw), 3, 128, device="cpu")
    got_p, got_e = locate_streams(lb, torch.as_tensor(ev_on),
                                  torch.as_tensor(ev_ch))
    for s in range(len(rows)):
        _, (pts, em) = jax.lax.scan(step, j_locator_init(8),
                                    (jnp.asarray(ev_on[s]),
                                     jnp.asarray(ev_ch[s])))
        em = np.asarray(em)
        np.testing.assert_array_equal(got_e[s].numpy(), em)
        np.testing.assert_allclose(got_p[s].numpy()[em], np.asarray(pts)[em],
                                   atol=1e-4)
        assert not got_p[s].numpy()[~em].any()
    assert got_e.sum() >= 3


def test_mesh_helpers_match_jax():
    """One process, no process group: one device; the shapes and the
    too-many-devices error of JAX's helpers."""
    from onset_fingerprinting_torch.parallel import (
        default_mesh,
        global_mesh,
        make_mesh,
    )

    m = make_mesh((1,), ("data",), device="cpu")
    assert m.shape == {"data": 1} and m.axis_names == ("data",)
    assert m.index("data") == 0 and m.group("data") is None
    d = default_mesh(device="cpu")
    assert d.shape == {"data": 1, "model": 1} and d.devices.size == 1
    assert global_mesh(device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1 "
                                         "available"):
        make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        global_mesh((4,), device="cpu")
    with pytest.raises(ValueError, match="mesh needs 100 devices"):
        j_make_mesh((100,), ("data",))


def test_single_process_sharded_path_equals_unsharded():
    """Without a process group the sharded detector is the unsharded one
    on the whole batch (one device, nothing gathered)."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        detector_init,
    )
    from onset_fingerprinting_torch.parallel import (
        detect_offline_sharded,
        make_mesh,
    )

    st, pa, s0 = detector_init(DetectorConfig(
        n_channels=2, block_size=128, hipass_freq=0.0, sr=SR), "cpu")
    xs = np.stack([synth(128 * 12, 2, seed=i, spacing=700, start=400)
                   for i in range(2)])
    on, d, _ = detect_offline_sharded(st, pa, s0, xs,
                                      make_mesh((1,), ("data",),
                                                device="cpu"))
    for i in range(2):
        _, (on_p, d_p, _) = detect_offline(st, pa, s0, torch.as_tensor(xs[i]))
        assert torch.equal(on[i], on_p)
        assert torch.equal(d[i][on_p], d_p[on_p])
    assert int(on.sum()) > 0


def test_run_location_hpo_on_a_mesh_equals_unmeshed(run):
    """``run_location_hpo(mesh=)``: each trial's trainer on the 2-rank mesh
    (BatchNorm over the global batch, dropout's global mask) reaches the
    unmeshed study's validation and test L1."""
    from onset_fingerprinting_torch.models import experiment as texp

    r0, _, _ = run
    out = pathlib.Path(os.path.dirname(run[2]["_dir"]))
    study = texp.run_location_hpo(out / "hpo", "combined0", n_trials=2,
                                  num_epochs=2, min_epochs=0, subsample=5,
                                  device="cpu")
    want = np.array([t.value for t in study.results], dtype=float)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(r0["hpo_values"], want, rtol=1e-4)
    np.testing.assert_allclose(r0["hpo_test"],
                               study.best_trial.user_attrs["test_l1"],
                               rtol=1e-4)
