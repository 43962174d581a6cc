"""The whole slice at 32 streams (C = 128), one chunk of 20480 samples,
against the same composition of JAX functions as bench.py: warmup →
Pallas detector (interpret) → top_hit_blocks → compact_hit_list → anchored
gather (Pallas interpret, HIGHEST) → flagship CCCNN (fused conv stack,
interpret) in bfloat16.  Events, starts, stream ids and validity exact;
predictions close; recall and precision 1.0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import DetectorConfig as JCfg
from onset_fingerprinting_tpu.detect.amplitude import warmup_minmax
from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.ops import windows as jw
from onset_fingerprinting_tpu.ops.pallas_detector import make_pallas_detector
from onset_fingerprinting_torch import workload as wl
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.pipeline import (
    HitCapacityError,
    fleet_detector_config,
    make_detect_fingerprint,
)

S, T = 32, 20480
WARM = 38 * 128


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1e-3, (T, S * 4)).astype(np.float32)
    return x + wl.hit_profile(T, "cpu").numpy()[:, None]


@pytest.fixture(scope="module")
def flax_model():
    jm = JCCCNN(dtype=jnp.bfloat16, conv_impl="pallas", **wl.FLAGSHIP)
    variables = jax.tree_util.tree_map(
        np.asarray, wl.flagship_flax_params(seed=3))
    return jm, variables


def port_model(variables):
    m = CCCNN(input_size=wl.WINDOW, dtype=torch.bfloat16, **wl.FLAGSHIP)
    m.load_state_dict(cccnn_state_dict_from_flax(variables))
    return m


def test_slice_matches_jax_composition(audio, flax_model):
    max_hits, cap = wl.chunk_capacities(S, T)
    jm, variables = flax_model
    # JAX: the bench.py composition (bench.py:282-302, 346-352, 402-405)
    cfg = dict(n_channels=S * 4, block_size=128, hipass_freq=2000.0,
               sr=96000, coupled_off_gate=False)
    jstatic, jparams, jstate, run = make_pallas_detector(
        JCfg(**cfg), interpret=True, emit_rel=False)
    xj = jnp.asarray(audio)
    jstate = warmup_minmax(jstatic, jparams, jstate, xj[:WARM])
    _, (on_j, d_j, _) = run(jstate, xj)
    st_pad, v_pad = jw.top_hit_blocks(on_j, 128, S, max_hits, d_j)
    starts_j, sids_j, valid_j, drop_j = jw.compact_hit_list(st_pad, v_pad,
                                                            cap)
    win_j = jw.gather_hit_windows(
        xj, starts_j, sids_j, 4, wl.WINDOW, pre=wl.PRE, backend="pallas",
        interpret=True, precision=jax.lax.Precision.HIGHEST, anchored=True)
    preds_j = np.asarray(jnp.where(valid_j[:, None],
                                   jm.apply(variables, win_j), 0.0))

    # the port, through the user's entry point
    pipe = make_detect_fingerprint(fleet_detector_config(S),
                                   port_model(variables), S, T, cap,
                                   device="cpu")
    assert pipe.max_hits == max_hits
    x = torch.as_tensor(audio)
    state = pipe.warmup(pipe.init_state(), x[:WARM])
    _cuda.reset_counts()
    state2, on, deltas = pipe.detect(state, x)
    starts, sids, valid, dropped = pipe.hit_list(on, deltas)
    np.testing.assert_array_equal(on.numpy(), np.asarray(on_j))
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    np.testing.assert_array_equal(sids.numpy(), np.asarray(sids_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert int(dropped) == int(drop_j) == 0

    _, preds, n_hits, n_dropped = pipe(state, x)
    assert preds.shape == (cap, 2)
    assert int(n_hits) == S * wl.n_injected(T) == int(valid_j.sum())
    assert int(n_dropped) == 0
    # bf16 conv stacks round at the same points in both; summation order
    # differs, so a rare activation rounds one bf16 ulp apart
    np.testing.assert_allclose(preds.numpy(), preds_j, atol=1e-2, rtol=1e-2)
    # on the CPU every kernel wrapper of the path ran its plain version
    # (the fleet detector stands in for the pipelined kernel, the bf16
    # flagship stack for the tensor-core kernel)
    path = (_cuda.DETECTOR_PIPE, _cuda.GATHER, _cuda.CONV_STACK_MMA)
    assert all(k.launches == 0 for k in _cuda.KERNELS)
    assert all(k.plain_calls > 0 for k in path)

    tp, spur, matched = wl.correctness(on, 128, S, max_hits, T)
    assert matched == S * wl.n_injected(T)  # recall 1.0
    assert spur == 0 and tp > 0  # precision 1.0


def test_capacity_overflow_raises(audio, flax_model):
    _, variables = flax_model
    pipe = make_detect_fingerprint(fleet_detector_config(S),
                                   port_model(variables), S, T, 16,
                                   device="cpu")
    x = torch.as_tensor(audio)
    state = pipe.warmup(pipe.init_state(), x[:WARM])
    with pytest.raises(HitCapacityError, match="dropped 48"):
        pipe(state, x)
