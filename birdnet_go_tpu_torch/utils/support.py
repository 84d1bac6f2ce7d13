"""Support-bundle collector.

Reference: internal/support (3.3k LoC) — gathers logs, scrubbed config,
DB stats, and diagnostics into an archive for bug reports; internal/privacy
scrubs URLs/credentials.

A copy of ``birdnet_go_tpu/utils/support.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_recovery.py`` holds it to
the original. Where it differs from JAX: ``system.json`` lists the CUDA
cards torch sees (``devices``: each ``torch.cuda.get_device_name(i)``)
with the ``torch`` and ``cuda`` versions, where JAX lists
``jax.devices()`` and its version. Without a card ``devices`` is empty and
``devices_error`` says why; the CPU is never named as the device.
"""

from __future__ import annotations

import dataclasses
import io
import json
import platform
import re
import tarfile
import time
from typing import Any

import torch

_SECRET_KEYS = re.compile(
    r"(password|token|secret|api_key|apikey|key)", re.IGNORECASE)
_URL_CRED = re.compile(r"(//[^/@\s:]+):[^@/\s]+@")


def scrub(value: Any) -> Any:
    """Redact credentials from config structures and URL strings."""
    if isinstance(value, dict):
        return {k: ("***" if _SECRET_KEYS.search(str(k)) else scrub(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [scrub(v) for v in value]
    if isinstance(value, str):
        return _URL_CRED.sub(r"\1:***@", value)
    return value


@dataclasses.dataclass
class SupportBundle:
    data: bytes
    name: str


def collect_support_bundle(app=None, log_tail: list[dict] | None = None
                           ) -> SupportBundle:
    """Assemble a scrubbed diagnostics archive."""
    import dataclasses as dc

    sections: dict[str, bytes] = {}
    sysinfo = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "time": time.time(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card "
                               "(torch.cuda.is_available() is false)")
        sysinfo["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())]
    except Exception as e:
        sysinfo["devices"] = []
        sysinfo["devices_error"] = str(e)
    sections["system.json"] = json.dumps(sysinfo, indent=2).encode()

    if app is not None:
        cfg = scrub(dc.asdict(app.settings))
        sections["config.json"] = json.dumps(cfg, indent=2,
                                             default=str).encode()
        stats: dict[str, Any] = {}
        if app.processor is not None:
            stats["processor"] = dc.asdict(app.processor.stats)
        if app.jobqueue is not None:
            stats["jobqueue"] = vars(app.jobqueue.stats)
        if app.datastore is not None:
            stats["detections"] = app.datastore.count_detections()
        if app.engine is not None:
            stats["streams"] = app.engine.stream_health()
        sections["stats.json"] = json.dumps(stats, indent=2,
                                            default=str).encode()
    if log_tail:
        sections["recent_errors.json"] = json.dumps(
            log_tail, indent=2, default=str).encode()

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in sections.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))
    stamp = time.strftime("%Y%m%dT%H%M%S")
    return SupportBundle(data=buf.getvalue(),
                         name=f"support-bundle-{stamp}.tar.gz")
