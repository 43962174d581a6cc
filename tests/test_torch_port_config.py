"""The port's config tree and workload constants equal the JAX package's
and bench.py's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from onset_fingerprinting_tpu.core import config as jcfg
from onset_fingerprinting_torch import workload
from onset_fingerprinting_torch.core import config as tcfg


@pytest.mark.parametrize(
    "name",
    ["DetectorConfig", "GeometryConfig", "RealtimeConfig", "TrainConfig",
     "PipelineConfig"],
)
def test_config_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)
    ]
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_realtime_derived_constants_match():
    j, t = jcfg.RealtimeConfig(), tcfg.RealtimeConfig()
    for prop in ("n_channels", "rec_n", "n_stft", "tg_pad", "max_offset",
                 "max_length", "avg_offset", "avg_length", "wait",
                 "onset_det_offset"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_config_json_round_trip(tmp_path):
    cfg = tcfg.PipelineConfig()
    cfg.detector.n_channels = 7
    tcfg.save_config(cfg, tmp_path / "c.json")
    assert tcfg.load_config(tmp_path / "c.json") == cfg
    # the JAX package reads the port's file identically
    assert dataclasses.asdict(jcfg.load_config(tmp_path / "c.json")) == (
        dataclasses.asdict(cfg))


def test_workload_constants_match_bench():
    for name in ("SR", "CHANNELS_PER_STREAM", "WINDOW", "PRE", "MAX_HITS",
                 "HIT_FIRST", "HIT_PERIOD", "BURST_LEN", "BURST_MARGIN"):
        assert getattr(workload, name) == getattr(bench, name), name
    for t in (0, 5000, 5700, 15299, 15300, 20480, 32000, 96000):
        assert workload.n_injected(t) == bench.n_injected(t)


@pytest.mark.parametrize("chunks", [1, 2, 3, 6])
def test_chunk_capacities_match_bench(chunks):
    n_streams = 8192
    t = bench.SR // chunks
    max_hits = max(-(-bench.MAX_HITS // chunks), 4)
    cap = -(-(n_streams * bench.n_injected(t) * 4 // 3) // 128) * 128
    assert workload.chunk_capacities(n_streams, t) == (max_hits, cap)


def test_hit_profile_matches_bench_audio():
    t, c = 20480, 4
    x = np.asarray(bench.make_audio(t, c, seed=0))
    noise = np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (t, c), jnp.float32) * 1e-3
    )
    prof = workload.hit_profile(t, device="cpu").numpy()
    np.testing.assert_allclose(x - noise, np.repeat(prof[:, None], c, 1),
                               atol=1e-6)
    audio = workload.make_audio(t, c, seed=0, device="cpu")
    assert audio.shape == (t, c)
    assert abs(float((audio - workload.hit_profile(t, "cpu")[:, None]).std())
               - 1e-3) < 1e-4
