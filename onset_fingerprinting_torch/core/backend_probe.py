"""Hang-proof probe of the CUDA backend (port of
``onset_fingerprinting_tpu.core.backend_probe``).

Initialising a broken CUDA installation or a wedged card can block a
process rather than raise.  The only safe probe is a throwaway child
process under a hard timeout: if the child hangs it is killed, and this
process never touches the broken backend.  The child imports only torch.

This module imports nothing but the standard library, so a caller can
probe before it imports torch itself.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable

_PROBE_CODE = "import torch; print(torch.cuda.device_count())"


def probe_device_count(
    timeout: float = 120.0, code: str = _PROBE_CODE
) -> tuple[int, str]:
    """Ask a throwaway child process how many CUDA devices come up.

    :param timeout: hard kill budget for the child (a wedged backend
        blocks forever; the child is killed and counted as 0 devices)
    :param code: probe script; must print the device count as its last
        line of standard output
    :returns: ``(device_count, diagnostic)``: count 0 with a one-line
        reason on failure, hang or crash
    """
    try:
        out = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return 0, f"probe hung >{timeout:.0f}s (wedged backend?)"
    except Exception as e:  # pragma: no cover - exec environment failure
        return 0, f"probe failed to launch: {type(e).__name__}: {e}"
    if out.returncode == 0 and out.stdout.strip():
        try:
            return int(out.stdout.strip().splitlines()[-1]), "ok"
        except ValueError:
            pass
    err = out.stderr.strip().splitlines()
    return 0, err[-1] if err else f"probe exit {out.returncode}, no output"


def await_healthy_backend(
    max_wait_s: float,
    probe_timeout: float = 120.0,
    log: Callable[[str], None] | None = None,
) -> bool:
    """Retry :func:`probe_device_count` until a probe reports at least one
    device (True) or ``max_wait_s`` runs out (False), about once a minute:
    the caller records a clean failure instead of a hang."""
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        t0 = time.monotonic()
        n, diag = probe_device_count(probe_timeout)
        if n > 0:
            return True
        if log is not None:
            log(f"backend probe {attempt} failed: {diag}")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        time.sleep(min(max(60 - (time.monotonic() - t0), 5), remaining))
