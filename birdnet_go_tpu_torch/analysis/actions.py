"""Post-approval actions (reference: internal/analysis/processor/
actions_types.go:92-339, execute.go, actions_composite.go).

Actions run on the JobQueue with per-action retry policy. The Composite
action preserves the reference's ordering contract: Database → SSE → MQTT
sequentially, so the SSE/MQTT payloads carry the DB-assigned detection id.
SaveAudio extracts the clip from the CaptureBuffer by wall-clock and is
scheduled separately.

A copy of ``birdnet_go_tpu/analysis/actions.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
(``SaveAudioAction``: ``tests/test_torch_aux.py``) holds it to the
original. ``SaveAudioAction.encoder`` is the port's: the app encodes its
clips in worker processes (``app.ClipEncoder``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
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


@dataclasses.dataclass
class SaveAudioAction:
    """Clip export: CaptureBuffer.read_segment by wall-clock → WAV.

    Reference: SaveAudioAction w/ deferred retries for extended capture
    (extended_capture.go) — if the requested span isn't fully buffered yet
    the action raises so the JobQueue retries later.
    """

    capture_buffer: Any               # audio.CaptureBuffer
    start_time: float
    end_time: float
    out_path: str | Path
    sample_rate: int = 48000
    description: str = "export audio clip"
    # Fallback: the detection window's own PCM (queued through the pipeline,
    # process.go:388-396 deep copy). Used when the CaptureBuffer ring has
    # already overwritten the requested span (slow flush / long deadline).
    fallback_pcm: Any = None          # np.ndarray | None
    fallback_rate: int = 0
    # Bird detections recorded through a shared high-rate (bat) source
    # are downsampled before encoding (reference: export.go — bird clips
    # → 48 kHz; bat clips keep native rate so echolocation survives).
    downsample_to: int = 0
    # Loudness: one gain resolved per clip before ANY encoder runs
    # (reference: actions_database.go:854-880 encodeClip). When
    # normalization["enabled"], the EBU R128 gain measured by audionorm
    # (target LUFS capped by true peak) REPLACES the static gain_db.
    gain_db: float = 0.0
    normalization: dict | None = None
    # the port's: what encodes the clip, encode_clip's signature (default
    # encode_clip on this thread); the app passes its process pool's
    encoder: Callable[..., Any] | None = None

    def _resolve_gain_lin(self, pcm, rate: int) -> float:
        """Linear gain factor for the exported clip — the static gain_db
        setting, or (when normalization is enabled) plan_gain's
        LUFS/true-peak plan, used directly without a dB round-trip."""
        norm = self.normalization or {}
        if not norm.get("enabled"):
            return float(10.0 ** (float(self.gain_db) / 20.0))
        import numpy as _np

        from birdnet_go_tpu_torch.audio.audionorm import (
            NormalizeOptions,
            plan_gain,
        )

        opts = NormalizeOptions(
            target_lufs=float(norm.get("target_lufs", -23.0)),
            max_true_peak_db=float(norm.get("true_peak_db", -2.0)))
        return float(plan_gain(
            pcm.astype(_np.float32) / 32768.0, rate, opts))

    def execute(self) -> None:
        if time.time() < self.end_time:
            raise RuntimeError("clip span not fully captured yet")
        pcm = self.capture_buffer.read_segment(self.start_time, self.end_time)
        # locals only: a JobQueue RETRY re-runs execute() from the top, so
        # mutating self.sample_rate would make the second attempt encode
        # native-rate PCM under a downsampled header
        rate = self.sample_rate
        if not pcm.any() and self.fallback_pcm is not None \
                and self.fallback_rate:
            pcm = self.fallback_pcm
            rate = self.fallback_rate
        if self.downsample_to and rate > self.downsample_to:
            import numpy as _np

            from birdnet_go_tpu_torch.audio.resampler import StreamingResampler

            rs = StreamingResampler(rate, self.downsample_to)
            # the resampler is float32 at the INPUT'S scale — convert back
            # to int16 or write_wav would rescale by 32768 and clip every
            # sample to full scale
            y = _np.concatenate([rs.process(pcm), rs.flush()])
            pcm = _np.clip(_np.round(y), -32768, 32767).astype(_np.int16)
            rate = self.downsample_to
        gain_lin = self._resolve_gain_lin(pcm, rate)
        if gain_lin != 1.0:
            import numpy as _np

            pcm = _np.clip(_np.round(
                pcm.astype(_np.float32) * gain_lin),
                -32768, 32767).astype(_np.int16)
        from birdnet_go_tpu_torch.audio.encode import encode_clip

        out = Path(self.out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        # format by suffix: native wav/flac, ffmpeg-gated aac/opus/mp3
        # (falls back to FLAC when ffmpeg is absent); atomic temp+rename
        (self.encoder or encode_clip)(pcm, rate, out)


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
