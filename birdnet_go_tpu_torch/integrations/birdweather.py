"""BirdWeather API v2 client (reference: internal/birdweather —
soundscape upload normalized to −23 LUFS / −1 dBTP FLAC/WAV, detection
POST, circuit breaker, connection probe).

A copy of ``birdnet_go_tpu/integrations/birdweather.py`` for the port,
which imports nothing of the JAX package;
``tests/test_torch_integrations.py`` holds it to the original. Its
default session is the shared client on the port's transport
(``utils/httpclient.py``).
"""

from __future__ import annotations

import dataclasses
import io
import logging

import numpy as np

from birdnet_go_tpu_torch.audio.audionorm import normalize_int16
from birdnet_go_tpu_torch.audio.wav import write_wav
from birdnet_go_tpu_torch.utils.circuit import CircuitBreaker, CircuitOpenError

log = logging.getLogger("birdnet_tpu.birdweather")

_BASE = "https://app.birdweather.com/api/v1"


@dataclasses.dataclass
class BirdWeatherConfig:
    station_token: str = ""
    latitude: float | None = None
    longitude: float | None = None
    base_url: str = _BASE


class BirdWeatherClient:
    def __init__(self, config: BirdWeatherConfig, session=None):
        from birdnet_go_tpu_torch.utils.httpclient import shared_client

        self.config = config
        self.session = session or shared_client()
        self.breaker = CircuitBreaker(failure_threshold=5,
                                      cooldown_seconds=120.0)
        self.uploads = 0
        self.failures = 0

    def _station_url(self, path: str) -> str:
        return (f"{self.config.base_url}/stations/"
                f"{self.config.station_token}{path}")

    def probe(self) -> bool:
        """Connection probe (station endpoint reachable + token valid)."""
        try:
            r = self.session.get(self._station_url(""))
            return r.status_code == 200
        except Exception:
            return False

    def upload_soundscape(self, pcm_i16: np.ndarray, sample_rate: int,
                          timestamp_iso: str) -> int | None:
        """Upload a −23 LUFS-normalized soundscape WAV; returns its id."""
        normalized = normalize_int16(pcm_i16, sample_rate)
        buf = io.BytesIO()
        write_wav(buf, normalized, sample_rate)

        def _do():
            r = self.session.post(
                self._station_url(f"/soundscapes?timestamp={timestamp_iso}"),
                content=buf.getvalue(),
                headers={"Content-Type": "application/octet-stream"})
            r.raise_for_status()
            return r.json().get("soundscape", {}).get("id")

        try:
            sid = self.breaker.call(_do)
            self.uploads += 1
            return sid
        except CircuitOpenError:
            log.warning("birdweather circuit open; soundscape skipped")
            self.failures += 1
            return None
        except Exception as e:
            log.warning("soundscape upload failed: %s", e)
            self.failures += 1
            return None

    def post_detection(self, detection, soundscape_id: int | None,
                       timestamp_iso: str) -> bool:
        payload = {
            "timestamp": timestamp_iso,
            "lat": self.config.latitude,
            "lon": self.config.longitude,
            "soundscapeId": soundscape_id,
            "soundscapeStartTime": 0,
            "soundscapeEndTime": None,
            "commonName": detection.species.common,
            "scientificName": detection.species.scientific,
            "algorithm": detection.model_id,
            "confidence": detection.confidence,
        }

        def _do():
            r = self.session.post(self._station_url("/detections"),
                                  json=payload)
            r.raise_for_status()
            return True

        try:
            return bool(self.breaker.call(_do))
        except (CircuitOpenError, Exception) as e:  # noqa: BLE001
            log.warning("birdweather detection post failed: %s", e)
            self.failures += 1
            return False
