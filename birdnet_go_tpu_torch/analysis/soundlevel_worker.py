"""Octave-band sound-level publication worker.

Reference: internal/analysis/sound_level*.go — periodic 1/3-octave-band
levels per source published to SSE, MQTT, and metrics.

The port's copy of ``birdnet_go_tpu/analysis/soundlevel_worker.py``. Each
pass runs one ``ops/soundlevel.band_levels_db`` a source on `device`, the
card unless the caller asks for another, on a CUDA stream of the worker's
own there. The JAX worker jits a graph per (rate, length); the port runs
eagerly, and ``band_levels_db`` keeps its band matrix and window on the
device, so a pass uploads only PCM. ``sample_once`` takes the pass's
wall-clock time as an argument (the clock by default).
``tests/test_torch_aux.py`` holds it to the original.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from birdnet_go_tpu_torch.ops.soundlevel import (
    SoundLevelConfig,
    band_levels_db,
    third_octave_centers,
)
from birdnet_go_tpu_torch.ops.streams import aux_device, on_stream, side_stream

log = logging.getLogger("birdnet_tpu.soundlevel")


class SoundLevelWorker:
    def __init__(self, engine, sse=None, mqtt=None, mqtt_topic: str = "birdnet",
                 interval_seconds: float = 10.0,
                 device: torch.device | str = "cuda"):
        self.engine = engine
        self.sse = sse
        self.mqtt = mqtt
        self.mqtt_topic = mqtt_topic
        self.interval = interval_seconds
        self.device = aux_device(device, "SoundLevelWorker")
        self._stream = side_stream(self.device)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.published = 0

    def _levels(self, pcm: np.ndarray, rate: int) -> np.ndarray:
        """int16 PCM → the band levels in dBFS, unrounded."""
        x = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(
            self.device)
        return band_levels_db(x, SoundLevelConfig(sample_rate=rate))[0] \
            .cpu().numpy()

    def sample_once(self, now: float | None = None) -> dict:
        """One measurement pass over every source, over the interval that
        ends at `now`."""
        out = {}
        now = time.time() if now is None else now
        with on_stream(self._stream):
            for src in self.engine.sources():
                cb = self.engine.capture_buffer(src.source_id)
                if cb is None:
                    continue
                pcm = cb.read_segment(now - self.interval, now)
                if not len(pcm):
                    continue
                rate = cb.sample_rate
                cfg = SoundLevelConfig(sample_rate=rate)
                levels = self._levels(pcm, rate)
                centers = third_octave_centers(cfg.fmin,
                                               min(cfg.fmax, rate / 2))
                out[src.source_id] = {
                    "bands_hz": [round(float(c), 1) for c in centers],
                    "levels_db": [round(float(v), 1) for v in levels],
                    "time": now,
                }
        return out

    def publish_once(self) -> None:
        data = self.sample_once()
        if not data:
            return
        if self.sse is not None:
            self.sse.publish("soundlevels", "soundlevel", data)
        if self.mqtt is not None:
            self.mqtt.publish(f"{self.mqtt_topic}/soundlevels", data)
        self.published += 1

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="soundlevel",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.publish_once()
            except Exception:
                log.exception("sound level pass failed")
