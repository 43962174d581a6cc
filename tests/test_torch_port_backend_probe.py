"""The port's hang-proof backend probe (``core/backend_probe.py``) against
the JAX package's: the four behaviours its callers rely on (a healthy
count, a bounded hang, a crash's diagnostic, a clean give-up), and the same
answer as the JAX probe for the same child code.  The port's child imports
only torch."""

import torch

from onset_fingerprinting_tpu.core import backend_probe as jprobe
from onset_fingerprinting_torch.core.backend_probe import (
    _PROBE_CODE,
    await_healthy_backend,
    probe_device_count,
)


def test_probe_reports_this_machines_cuda_count():
    n, diag = probe_device_count(timeout=120.0)
    assert diag == "ok"
    assert n == torch.cuda.device_count()
    assert "jax" not in _PROBE_CODE and "torch" in _PROBE_CODE


def test_probe_hang_is_killed_within_timeout():
    n, diag = probe_device_count(timeout=2.0,
                                 code="import time; time.sleep(600)")
    assert n == 0
    assert "hung" in diag


def test_probe_crash_reports_diagnostic():
    n, diag = probe_device_count(timeout=30.0,
                                 code="raise RuntimeError('boom')")
    assert n == 0
    assert "boom" in diag or "exit" in diag


def test_await_healthy_backend_gives_up_cleanly():
    logs = []
    ok = await_healthy_backend(max_wait_s=0.0, probe_timeout=1.0,
                               log=logs.append)
    assert ok is False
    assert logs and "probe 1" in logs[0]


def test_probe_agrees_with_jax_on_the_same_child():
    for code in ("print(3)", "print('x')\nprint(2)", "import sys; "
                 "sys.exit(4)"):
        assert probe_device_count(30.0, code)[0] == \
            jprobe.probe_device_count(30.0, code)[0]
