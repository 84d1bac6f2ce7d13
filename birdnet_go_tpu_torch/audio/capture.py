"""Soundcard capture source (native ALSA shim → engine.ingest).

Reference: internal/audiocore/capture.go (malgo/miniaudio CGO callback).
Here a reader thread pulls 100 ms chunks from the native ALSA capture
(birdnet_go_tpu_torch.native) and pushes them into the engine like any
other source; absence of ALSA degrades with a clear error at start.

A copy of ``birdnet_go_tpu/audio/capture.py`` for the port, over the
port's ``native.AlsaCapture`` and ``utils/sysmonitor.audio_devices``;
``tests/test_torch_sources.py`` holds it to the original (every format of
``convert_to_s16`` and its refusal, ``resolve_device``, and the chunks a
fake capture hands ``SoundcardSource``). One difference is the native
library's: the port's builds on first use and raises where it cannot, so
``start`` fails with that ``RuntimeError`` where JAX's loader would have
reported ALSA missing (also a ``RuntimeError``).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from birdnet_go_tpu_torch.audio.source import AudioSource, SourceType

log = logging.getLogger("birdnet_tpu.capture")


def convert_to_s16(raw: bytes, fmt: str = "s16le",
                   channels: int = 1) -> np.ndarray:
    """Host-side sample-format conversion to mono int16
    (capture.go:579-720: S24/S32/F32→S16 in the device callback — devices
    whose native format isn't S16 convert here, not in ALSA).

    Formats: s16le, s24_3le (packed 3-byte), s24le (4-byte container),
    s32le, f32le. Multi-channel input is averaged to mono."""
    if fmt == "s16le":
        x = np.frombuffer(raw[:len(raw) - len(raw) % 2],
                          dtype="<i2").astype(np.float32)
        scale = 1.0
    elif fmt == "s24_3le":
        n = len(raw) // 3
        b = np.frombuffer(raw[:n * 3], np.uint8).reshape(n, 3)
        as32 = (b[:, 0].astype(np.uint32)
                | (b[:, 1].astype(np.uint32) << 8)
                | (b[:, 2].astype(np.uint32) << 16))
        signed = as32.astype(np.int32)
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        x = signed.astype(np.float32)
        scale = 1.0 / 256.0
    elif fmt == "s24le":                # 24-bit in 32-bit container
        x = np.frombuffer(raw[:len(raw) - len(raw) % 4],
                          dtype="<i4").astype(np.float32)
        scale = 1.0 / 256.0
    elif fmt == "s32le":
        x = np.frombuffer(raw[:len(raw) - len(raw) % 4],
                          dtype="<i4").astype(np.float32)
        scale = 1.0 / 65536.0
    elif fmt == "f32le":
        x = np.frombuffer(raw[:len(raw) - len(raw) % 4],
                          dtype="<f4").astype(np.float32)
        scale = 32767.0
    else:
        raise ValueError(f"unsupported capture format {fmt!r}")
    if channels > 1:
        n = len(x) // channels
        x = x[:n * channels].reshape(n, channels).mean(axis=1)
    return np.clip(x * scale, -32768, 32767).astype(np.int16)


def resolve_device(spec: str) -> str:
    """Resolve a device spec to a concrete ALSA name at open time.

    `usb:VENDOR[:PRODUCT[:SERIAL]]` re-matches a card by USB identity —
    the reference's replug/reorder-safe matching (usb_linux.go +
    device.go:95: a configured device keeps working when the kernel
    reassigns card indices). Anything else passes through verbatim
    (hw:N,M / plughw / default)."""
    if not spec.startswith("usb:"):
        return spec
    parts = spec.split(":")[1:]
    from birdnet_go_tpu_torch.utils.sysmonitor import audio_devices

    for card in audio_devices():
        if card.get("usb_vendor") != parts[0]:
            continue
        if len(parts) > 1 and parts[1] \
                and card.get("usb_product") != parts[1]:
            continue
        if len(parts) > 2 and parts[2] \
                and card.get("usb_serial") != parts[2]:
            continue
        return card["alsa_name"]
    raise RuntimeError(f"no sound card matches USB identity {spec!r}")


class SoundcardSource:
    def __init__(self, engine, device: str = "default",
                 source_id: str | None = None, rate: int = 48000,
                 channels: int = 1, chunk_seconds: float = 0.1):
        self.engine = engine
        self.device = device
        self.rate = rate
        self.channels = channels
        self.chunk_frames = max(1, int(rate * chunk_seconds))
        self.source = AudioSource(
            source_id=source_id or f"card:{device}",
            source_type=SourceType.AUDIO_CARD,
            display_name=f"soundcard {device}", uri=device,
            sample_rate=rate, channels=channels)
        self._capture = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        from birdnet_go_tpu_torch import native

        if not native.alsa_available():
            raise RuntimeError(
                "ALSA capture unavailable (no libasound on this host)")
        # usb: specs re-resolve at every (re)start, so a replugged card
        # that moved indices is found again by identity
        self._capture = native.AlsaCapture(
            device=resolve_device(self.device), rate=self.rate,
            channels=self.channels)
        self.engine.add_source(self.source)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"capture-{self.source.source_id}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._capture is not None:
            self._capture.close()
            self._capture = None
        self.engine.remove_source(self.source.source_id)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                pcm = self._capture.read(self.chunk_frames)
            except RuntimeError as e:
                log.error("capture failed on %s: %s", self.device, e)
                return
            if pcm is not None and len(pcm):
                self.engine.ingest(self.source.source_id, pcm)
