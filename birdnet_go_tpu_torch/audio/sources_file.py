"""File-backed realtime sources: WAV loop replay and synthetic tones.

The file-loop source is the realtime-pipeline test vehicle (the reference
gains the same via RTSP against a containerized MediaMTX server —
SURVEY.md §4); it replays a WAV at realtime pace (or a speed multiple)
pushing chunks into the AudioEngine like a capture callback would.

A copy of ``birdnet_go_tpu/audio/sources_file.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original. One divergence: a ``ToneSource`` that falls behind its
pace pushes the chunks it owes in one push, and keeps its pace; JAX's
pushes them back to back, a push a chunk, and 48 such threads at once
starve the device loop's thread of the GIL for seconds. Neither drops
the audio a stall held back, so the tone's capture buffer keeps up with
the wall clock (a live HLS segment ends where the wall clock does).
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path

import numpy as np

from birdnet_go_tpu_torch.audio.source import AudioSource, SourceType

log = logging.getLogger("birdnet_tpu.sources")


class FileLoopSource:
    """Replays a mono WAV into engine.ingest at chunked realtime pace."""

    def __init__(self, engine, path: str | Path, source_id: str | None = None,
                 chunk_seconds: float = 0.1, speed: float = 1.0,
                 loop: bool = True):
        from birdnet_go_tpu_torch.audio.wav import read_wav

        self.engine = engine
        self.path = Path(path)
        samples, info = read_wav(self.path)
        self.pcm = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
        self.rate = info.sample_rate
        self.chunk = max(1, int(self.rate * chunk_seconds))
        self.speed = speed
        self.loop = loop
        self.source = AudioSource(
            source_id=source_id or f"file:{self.path.name}",
            source_type=SourceType.FILE, display_name=self.path.name,
            uri=str(self.path), sample_rate=self.rate)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.engine.add_source(self.source)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"src-{self.source.source_id}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.engine.remove_source(self.source.source_id)

    def _run(self) -> None:
        pos = 0
        chunk_wall = self.chunk / self.rate / self.speed
        next_t = time.monotonic()
        while not self._stop.is_set():
            if self.loop:
                # modular gather: gapless across the wrap (and correct even
                # when the file is shorter than one chunk)
                idx = (pos + np.arange(self.chunk)) % len(self.pcm)
                chunk = self.pcm[idx]
                pos = (pos + self.chunk) % len(self.pcm)
            else:
                chunk = self.pcm[pos:pos + self.chunk]
                pos += self.chunk
                if len(chunk) == 0:
                    break
            self.engine.ingest(self.source.source_id, chunk)
            next_t += chunk_wall
            delay = next_t - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
            else:
                next_t = time.monotonic()


class ToneSource:
    """Synthetic sine source (tests / demo without audio files).

    `pulse_hz` > 0 applies on/off keying at that rate — a bat-call-like
    pulsed ultrasonic signal whose band energy varies frame-to-frame
    (high CV), as opposed to the steady tone the ultrasonic validation
    filter is designed to reject (ultrasonic/filter.go:20-71 semantics).
    """

    def __init__(self, engine, source_id: str = "tone0", rate: int = 48000,
                 freq_hz: float = 1000.0, amplitude: float = 0.3,
                 chunk_seconds: float = 0.1, speed: float = 1.0,
                 pulse_hz: float = 0.0):
        self.engine = engine
        self.rate = rate
        self.freq = freq_hz
        self.amp = amplitude
        self.pulse_hz = pulse_hz
        self.chunk = max(1, int(rate * chunk_seconds))
        self.speed = speed
        self.source = AudioSource(source_id=source_id,
                                  source_type=SourceType.FILE,
                                  display_name=f"tone {freq_hz:.0f} Hz",
                                  sample_rate=rate)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._phase = 0

    def start(self) -> None:
        self.engine.add_source(self.source)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"src-{self.source.source_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.engine.remove_source(self.source.source_id)

    def push_seconds(self, seconds: float) -> None:
        """Synchronously push `seconds` of tone (no thread; test helper)."""
        n = int(self.rate * seconds)
        t = (np.arange(n) + self._phase) / self.rate
        self._phase += n
        wave = self.amp * 32767 * np.sin(2 * np.pi * self.freq * t)
        if self.pulse_hz > 0:
            wave = wave * (np.sin(2 * np.pi * self.pulse_hz * t) > 0)
        pcm = wave.astype(np.int16)
        self.engine.ingest(self.source.source_id, pcm)

    def _run(self) -> None:
        chunk_wall = self.chunk / self.rate / self.speed
        next_t = time.monotonic()
        while not self._stop.is_set():
            # the chunks due by now: one, or those a stall held back too,
            # in one push rather than back to back
            due = 1 + max(0, int((time.monotonic() - next_t) / chunk_wall))
            self.push_seconds(due * self.chunk / self.rate)
            next_t += due * chunk_wall
            delay = next_t - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
