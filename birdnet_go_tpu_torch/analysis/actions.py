"""Post-approval actions (reference: internal/analysis/processor/
actions_types.go:92-339, execute.go, actions_composite.go).

Actions run on the JobQueue with per-action retry policy. The Composite
action preserves the reference's ordering contract: Database → SSE → MQTT
sequentially, so the SSE/MQTT payloads carry the DB-assigned detection id.
SaveAudio extracts the clip from the CaptureBuffer by wall-clock and is
scheduled separately.

``SaveAudioAction`` is left out of this copy: it needs the capture buffer,
loudness normalisation, the streaming resampler and the clip encoder,
which the port does not have yet.

A copy of ``birdnet_go_tpu/analysis/actions.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Callable, Protocol

from birdnet_go_tpu_torch.analysis.jobqueue import JobQueue, RetryConfig
from birdnet_go_tpu_torch.analysis.processor import Detection

log = logging.getLogger("birdnet_tpu.actions")


class Action(Protocol):
    description: str

    def execute(self) -> None: ...


@dataclasses.dataclass
class LogAction:
    """Console/log line for an approved detection (LogAction analogue)."""

    detection: Detection
    description: str = "log detection"

    def execute(self) -> None:
        d = self.detection
        log.info("detection: %s (%.3f) model=%s source=%s",
                 d.species.common, d.confidence, d.model_id, d.source_id)


@dataclasses.dataclass
class DatabaseAction:
    """Persist the detection; stores the assigned id back on the event so
    downstream actions (SSE/MQTT) reference it."""

    detection: Detection
    store: Any                        # datastore.Datastore
    contributions: dict[str, Any] | None = None
    clip_name: str | None = None
    results: list | None = None       # best window's top-K (Note.Results)
    assigned_id: int | None = None
    on_saved: Callable[[int], None] | None = None
    description: str = "save detection to datastore"

    def execute(self) -> None:
        self.assigned_id = self.store.insert_detection(
            self.detection, clip_name=self.clip_name,
            contributions=self.contributions, results=self.results)
        if self.on_saved:
            self.on_saved(self.assigned_id)


_PARAM_NAME_OK = None   # compiled lazily


@dataclasses.dataclass
class ExecuteCommandAction:
    """Run a user-configured script for a detection (reference:
    ExecuteCommandAction, processor/execute.go — validated command path,
    sorted --Key=value arguments, clean environment, 5 min timeout)."""

    command: str
    params: dict                       # resolved values (Confidence 0-100)
    timeout_seconds: float = 300.0
    description: str = "execute command"

    def validate(self) -> str | None:
        """Returns an error string when the command path is unusable
        (missing, not a file, not executable) — a permanent condition."""
        import os

        p = Path(self.command)
        if not p.is_file():
            return f"command not found: {self.command}"
        if not os.access(p, os.X_OK):
            return f"command not executable: {self.command}"
        return None

    def build_args(self) -> list[str]:
        import re

        global _PARAM_NAME_OK
        if _PARAM_NAME_OK is None:
            _PARAM_NAME_OK = re.compile(r"^[A-Za-z0-9_-]+$")
        args = []
        for key in sorted(self.params):
            if not _PARAM_NAME_OK.match(key):
                raise ValueError(f"invalid parameter name {key!r}")
            v = self.params[key]
            if isinstance(v, float):
                v = f"{v:.2f}".rstrip("0").rstrip(".")
            args.append(f"--{key}={v}")
        return args

    def execute(self) -> None:
        import os
        import subprocess

        err = self.validate()
        if err:
            raise RuntimeError(err)
        # clean environment (execute.go getCleanEnvironment): the script
        # must not inherit credentials from the server process
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": os.environ.get("HOME", "/tmp"),
               "LANG": os.environ.get("LANG", "C.UTF-8")}
        proc = subprocess.run(
            [str(self.command), *self.build_args()],
            env=env, capture_output=True, timeout=self.timeout_seconds)
        if proc.returncode != 0:
            raise RuntimeError(
                f"command exited {proc.returncode}: "
                f"{proc.stderr.decode(errors='replace')[:200]}")


@dataclasses.dataclass
class CallbackAction:
    """Adapter for SSE broadcast / MQTT publish / notification hooks."""

    fn: Callable[[], None]
    description: str = "callback action"

    def execute(self) -> None:
        self.fn()


@dataclasses.dataclass
class CompositeAction:
    """Run sub-actions sequentially, aborting on first failure (so the
    JobQueue retry re-runs the remaining chain in order)."""

    actions: list[Any]
    description: str = "composite action"

    def execute(self) -> None:
        for a in self.actions:
            a.execute()


def enqueue_actions(queue: JobQueue, actions: list[Any],
                    retry: RetryConfig | None = None,
                    category: str = "other") -> int:
    n = 0
    for a in actions:
        if queue.enqueue(a.execute, a.description, retry=retry,
                         category=category):
            n += 1
    return n


def clip_filename(detection: Detection, fmt: str = "wav",
                  duration_seconds: int = 0) -> str:
    """Deterministic clip path (processor.go buildClipPath):
    year/month/<scientific>_<conf>p_<timestamp>Z[_<dur>s].<fmt> — the
    year/month nesting keeps long-running deployments out of
    100k-files-in-one-directory territory; the optional duration suffix
    marks extended-capture session clips."""
    ts = detection.timestamp or None
    if ts is not None:
        stamp = ts.strftime("%Y%m%dT%H%M%S") + "Z"
        prefix = f"{ts.strftime('%Y')}/{ts.strftime('%m')}/"
    else:
        stamp = f"{detection.begin_seconds:.0f}"
        prefix = ""
    sci = detection.species.scientific.replace(" ", "_").lower()
    dur = f"_{duration_seconds}s" if duration_seconds else ""
    # defense in depth (buildClipPath wav fallback): an
    # empty/whitespace format must never write an extension-less path
    fmt = (fmt or "").strip().lstrip(".") or "wav"
    return (f"{prefix}{sci}_{int(round(detection.confidence * 100))}p_"
            f"{stamp}{dur}.{fmt}")
