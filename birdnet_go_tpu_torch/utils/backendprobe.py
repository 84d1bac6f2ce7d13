"""Bounded probe of the CUDA card before ``serve`` builds the app (the
port's counterpart of ``birdnet_go_tpu/utils/backendprobe.py``).

A card whose driver is wedged can block the first CUDA call of a process
for minutes. ``probe_backend`` makes that call in a child process bounded
by a timeout: ``torch.cuda.is_available()``, one small launch read back,
and ``torch.cuda.get_device_name(0)``. It returns the card's name.

Where the JAX probe degrades the process to the CPU on a timeout or an
error (``_degrade``), this one raises ``BackendUnavailable`` with the
reason: serving on the CPU is the caller's choice (``--device cpu``),
never a fallback.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

log = logging.getLogger("birdnet_tpu.backendprobe")

_PROBE_CODE = (
    "import torch\n"
    "assert torch.cuda.is_available(), "
    "'torch.cuda.is_available() is false'\n"
    "x = torch.arange(1024, dtype=torch.float32, device='cuda')\n"
    "s = float((2 * x).sum())\n"
    "assert s == 1047552.0, f'a launch on the card summed {s}, not 1047552'\n"
    "print('DEVICE=' + torch.cuda.get_device_name(0))\n"
)

_HINT = "; pass --device cpu to serve on the CPU"


class BackendUnavailable(RuntimeError):
    """The CUDA card did not answer the probe."""


def probe_backend(timeout_s: float = 120.0,
                  env: dict[str, str] | None = None) -> str:
    """Probe the CUDA card in a child process (environment `env`, default
    this process's) bounded by `timeout_s`; returns the card's name.
    Raises ``BackendUnavailable`` on a timeout or when the child fails."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                           capture_output=True, text=True, timeout=timeout_s,
                           env=dict(os.environ if env is None else env))
    except subprocess.TimeoutExpired:
        raise BackendUnavailable(
            f"the CUDA probe did not answer within {timeout_s:.0f} s "
            f"(a wedged driver?){_HINT}") from None
    if r.returncode == 0:
        for line in r.stdout.splitlines():
            if line.startswith("DEVICE="):
                name = line.split("=", 1)[1].strip()
                log.info("backend probe ok: %s", name)
                return name
    tail = (r.stderr or r.stdout or "").strip().splitlines()
    raise BackendUnavailable(
        "the CUDA probe failed: "
        + (tail[-1] if tail else f"exit {r.returncode}") + _HINT)
