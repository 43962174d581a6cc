"""The whole slice at 32 streams (C = 128), one chunk of 20480 samples,
against the same composition of JAX functions as bench.py: warmup →
Pallas detector (interpret) → top_hit_blocks → compact_hit_list → anchored
gather (Pallas interpret, HIGHEST) → flagship CCCNN (fused conv stack,
interpret) in bfloat16 and in float32, the model's default dtype.  Events,
starts, stream ids and validity exact; predictions close; recall and
precision 1.0."""

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
from onset_fingerprinting_torch.ops.conv_stack import kernel_for
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


#: the model's dtype in both frameworks, and the predictions' bar: bf16
#: conv stacks round at the same points in both, but summation order
#: differs, so a rare activation rounds one bf16 ulp apart; in float32
#: (JAX: HIGHEST band products, a "highest" DFT head) only the order of
#: f32 sums differs
DTYPES = {
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=1e-2, rtol=1e-2)),
    "float32": (jnp.float32, torch.float32, dict(atol=1e-4, rtol=1e-4)),
}


def jax_model(dtype="bfloat16"):
    jm = JCCCNN(dtype=DTYPES[dtype][0], conv_impl="pallas", **wl.FLAGSHIP)
    variables = jax.tree_util.tree_map(
        np.asarray, wl.flagship_flax_params(seed=3))
    return jm, variables


@pytest.fixture(scope="module")
def flax_model():
    return jax_model()


def port_model(variables, dtype=torch.bfloat16):
    m = CCCNN(input_size=wl.WINDOW, dtype=dtype, **wl.FLAGSHIP)
    m.load_state_dict(cccnn_state_dict_from_flax(variables))
    return m


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slice_matches_jax_composition(audio, dtype):
    max_hits, cap = wl.chunk_capacities(S, T)
    jm, variables = jax_model(dtype)
    _, torch_dtype, tol = DTYPES[dtype]
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
                                   port_model(variables, torch_dtype), S, T,
                                   cap, device="cpu")
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
    np.testing.assert_allclose(preds.numpy(), preds_j, **tol)
    # on the CPU every kernel wrapper of the path ran its plain version
    # (the fleet detector stands in for the pipelined kernel, the bf16
    # flagship stack for the tensor-core kernel its batch of cap x 4
    # windows is routed to, the f32 one for the CUDA-core kernel)
    k3 = (kernel_for(wl.WINDOW, [torch.zeros(5, 1 if i == 0 else 5, k)
                                 for i, k in enumerate(
                                     wl.FLAGSHIP["kernel_sizes"])], 1,
                     torch_dtype, cap * 4)
          if torch_dtype == torch.bfloat16 else _cuda.CONV_STACK)
    path = (_cuda.DETECTOR_PIPE, _cuda.GATHER, k3)
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
