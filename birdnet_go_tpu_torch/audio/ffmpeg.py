"""FFmpeg subprocess stream source (RTSP/HTTP ingest).

Reference: internal/audiocore/ffmpeg — per-stream FFmpeg subprocess
writing raw s16le mono PCM at the target rate to stdout (common.go:117-136,
stream.go:859-942), stdout framing with partial-sample carry
(stream.go:1159 readStdout), watchdogs (silence timeout, quick-exit) and
restart with exponential backoff (stream.go:1241-1534).

FFmpeg is an external binary in the reference too; absence degrades to a
clear error at source start.

A copy of ``birdnet_go_tpu/audio/ffmpeg.py`` for the port, over the port's
``audio/encode.ffmpeg_available`` and ``utils/errors``;
``tests/test_torch_sources.py`` holds it to the original (the arguments in
every media mode, the probes with an injected ``run`` and without
ffprobe, the media-mode fallback and the quick-exit streak with a fake
``Popen``, the silence watchdog). No divergence. A machine without the
binaries (the card's) answers the probes with ``{"ok": False, ...}`` and
refuses an ``FfmpegSource`` at start, as JAX's does.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import threading
import time

import numpy as np

from birdnet_go_tpu_torch.audio.source import AudioSource, SourceType, safe_string

log = logging.getLogger("birdnet_tpu.ffmpeg")

_CHUNK_SAMPLES = 4800                 # 100 ms at 48 kHz
_QUICK_EXIT_SECONDS = 5.0             # exited faster than this = failing
_SILENCE_TIMEOUT = 60.0
_MAX_BACKOFF = 60.0


def ffmpeg_available() -> bool:
    # single injectable probe shared with the clip-encoder front end
    from birdnet_go_tpu_torch.audio.encode import ffmpeg_available as probe

    return probe()


def build_ffmpeg_args(url: str, sample_rate: int = 48000,
                      transport: str = "tcp",
                      media_mode: str = "audio_only",
                      channels: int = 1) -> list[str]:
    """Raw-PCM-to-stdout command.

    media_mode (stream.go:960-968): 'audio_only' asks RTSP to SETUP only
    the audio track (-allowed_media_types audio); some cameras refuse that,
    so 'full' pulls the whole stream and discards video host-side."""
    args = ["ffmpeg", "-hide_banner", "-loglevel", "error", "-nostdin"]
    if url.startswith("rtsp://"):
        args += ["-rtsp_transport", transport]
        if media_mode == "audio_only":
            args += ["-allowed_media_types", "audio"]
    args += [
        "-i", url,
        "-vn",                        # never decode video
        "-f", "s16le", "-acodec", "pcm_s16le",
        "-ac", str(channels), "-ar", str(sample_rate),
        "pipe:1",
    ]
    return args


def probe_stream(url: str, transport: str = "tcp", timeout: float = 15.0,
                 run=subprocess.run) -> dict:
    """Stream probe (ffmpeg/probe.go): codecs, rates, track inventory.
    Uses ffprobe's JSON output; `run` is injectable for tests."""
    import json

    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return {"ok": False, "error": "ffprobe not available"}
    cmd = [ffprobe, "-hide_banner", "-loglevel", "error",
           "-print_format", "json", "-show_streams", "-show_format"]
    if url.startswith("rtsp://"):
        cmd += ["-rtsp_transport", transport]
    cmd += [url]
    try:
        proc = run(cmd, capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "probe timed out"}
    if proc.returncode != 0:
        return {"ok": False,
                "error": proc.stderr.decode(errors="replace")[:300]}
    try:
        info = json.loads(proc.stdout)
    except ValueError:
        return {"ok": False, "error": "unparseable probe output"}
    streams = info.get("streams", [])
    audio = [s for s in streams if s.get("codec_type") == "audio"]
    video = [s for s in streams if s.get("codec_type") == "video"]
    out = {
        "ok": True,
        "has_audio": bool(audio),
        "has_video": bool(video),
        "container": info.get("format", {}).get("format_name", ""),
    }
    if audio:
        a = audio[0]
        out.update({
            "audio_codec": a.get("codec_name", ""),
            "sample_rate": int(a.get("sample_rate", 0) or 0),
            "channels": int(a.get("channels", 0) or 0),
        })
    return out


def analyze_channels(url: str, seconds: float = 3.0, channels: int = 2,
                     sample_rate: int = 48000, transport: str = "tcp",
                     run=subprocess.run) -> dict:
    """Per-channel RMS analysis (streams/analyze-channels endpoint): pulls
    a short multi-channel capture and reports level per channel so the UI
    can pick the microphone channel on stereo cameras."""
    if not ffmpeg_available():
        return {"ok": False, "error": "ffmpeg not available"}
    cmd = build_ffmpeg_args(url, sample_rate, transport,
                            media_mode="audio_only", channels=channels)
    cmd.insert(-1, "-t")
    cmd.insert(-1, str(seconds))
    try:
        proc = run(cmd, capture_output=True, timeout=seconds + 20)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "capture timed out"}
    if proc.returncode != 0 or not proc.stdout:
        return {"ok": False,
                "error": proc.stderr.decode(errors="replace")[:300]}
    pcm = np.frombuffer(
        proc.stdout[:len(proc.stdout) - len(proc.stdout) % (2 * channels)],
        dtype="<i2").reshape(-1, channels).astype(np.float32) / 32768.0
    rms = np.sqrt(np.mean(pcm ** 2, axis=0))
    db = 20 * np.log10(np.maximum(rms, 1e-7))
    best = int(np.argmax(rms))
    return {"ok": True, "channels": channels,
            "rms_dbfs": [round(float(v), 1) for v in db],
            "best_channel": best,
            "silent": [bool(v < -65) for v in db]}


class FfmpegSource:
    """Self-healing FFmpeg stream: reader thread + restart with backoff."""

    def __init__(self, engine, url: str, source_id: str | None = None,
                 sample_rate: int = 48000, transport: str = "tcp"):
        self.engine = engine
        self.url = url
        self.sample_rate = sample_rate
        self.transport = transport
        self.source = AudioSource(
            source_id=source_id or safe_string(url),
            source_type=(SourceType.RTSP if url.startswith("rtsp")
                         else SourceType.HTTP),
            display_name=safe_string(url), uri=url, sample_rate=sample_rate)
        self._proc: subprocess.Popen | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.restarts = 0
        self.bytes_received = 0
        self.last_data = 0.0
        # Reactive media-mode fallback (stream.go:960-968): start in
        # audio-only; cameras that refuse audio-only SETUP show up as
        # repeated quick exits with no data → retry pulling the full stream.
        self.media_mode = "audio_only"
        self._quick_exits = 0
        self._silence_kills = 0

    def start(self) -> None:
        if not ffmpeg_available():
            raise RuntimeError(
                "ffmpeg binary not found; RTSP/HTTP sources unavailable")
        self.engine.add_source(self.source)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._supervise, name=f"ffmpeg-{self.source.source_id}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kill()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.engine.remove_source(self.source.source_id)

    def _kill(self) -> None:
        p = self._proc
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=3)
            except subprocess.TimeoutExpired:
                p.kill()

    # -- supervision (restart w/ backoff — stream.go:1241-1534) ---------------------

    def _supervise(self) -> None:
        backoff = 1.0
        while not self._stop.is_set():
            started = time.monotonic()
            bytes_before = self.bytes_received
            try:
                self._run_once()
            except Exception as e:
                log.warning("stream %s failed: %s", self.source.source_id, e)
            if self._stop.is_set():
                return
            ran = time.monotonic() - started
            got_data = self.bytes_received > bytes_before
            if ran < _QUICK_EXIT_SECONDS:
                backoff = min(backoff * 2, _MAX_BACKOFF)
                if got_data:
                    # data arrived, however briefly — the "produces no
                    # data" streak is broken; without this, isolated
                    # dataless blips spread over days would accumulate
                    # to a bogus dead-endpoint tagged error
                    self._quick_exits = 0
                else:
                    self._quick_exits += 1
                    if self._quick_exits == 5:
                        # five dataless quick exits = a dead endpoint,
                        # not a blip → tagged error (ring + telemetry)
                        from birdnet_go_tpu_torch.utils.errors import (
                            Category,
                            new as new_error,
                        )

                        new_error(f"stream produces no data after "
                                  f"{self._quick_exits} restarts") \
                            .component("ffmpeg-stream") \
                            .category(Category.NETWORK) \
                            .context("source_id",
                                     self.source.source_id).build()
                    if self._quick_exits >= 2 \
                            and self.media_mode == "audio_only" \
                            and self.url.startswith("rtsp"):
                        self.media_mode = "full"
                        backoff = 1.0          # retry promptly in new mode
                        log.info("stream %s: audio-only SETUP keeps "
                                 "failing; falling back to full-stream "
                                 "media mode", self.source.source_id)
            else:
                backoff = 1.0
                self._quick_exits = 0
            self.restarts += 1
            log.info("restarting stream %s in %.0fs (restart #%d)",
                     self.source.source_id, backoff, self.restarts)
            self._stop.wait(backoff)

    def _watch_silence(self, proc: subprocess.Popen) -> None:
        """Silence watchdog (stream.go silence timeout): the reader blocks
        in stdout.read(), so a stalled-but-alive ffmpeg (camera TCP session
        up, no PCM) would hang forever — kill it so the read unblocks and
        the supervisor restarts with backoff."""
        while not self._stop.is_set() and proc.poll() is None:
            if time.monotonic() - self.last_data > _SILENCE_TIMEOUT:
                self._silence_kills += 1
                log.warning("stream %s silent for >%.0fs: restarting ffmpeg",
                            self.source.source_id, _SILENCE_TIMEOUT)
                self._kill()
                return
            self._stop.wait(1.0)

    def _run_once(self) -> None:
        args = build_ffmpeg_args(self.url, self.sample_rate, self.transport,
                                 media_mode=self.media_mode)
        self._proc = subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            bufsize=0)
        carry = b""                       # partial-sample carry
        chunk_bytes = _CHUNK_SAMPLES * 2
        self.last_data = time.monotonic()
        watchdog = threading.Thread(
            target=self._watch_silence, args=(self._proc,),
            name=f"ffmpeg-watchdog-{self.source.source_id}", daemon=True)
        watchdog.start()
        while not self._stop.is_set():
            data = self._proc.stdout.read(chunk_bytes)
            if not data:
                rc = self._proc.poll()
                raise RuntimeError(f"ffmpeg exited rc={rc}")
            self.last_data = time.monotonic()
            self.bytes_received += len(data)
            buf = carry + data
            usable = len(buf) - (len(buf) % 2)
            carry = buf[usable:]
            pcm = np.frombuffer(buf[:usable], dtype="<i2")
            if len(pcm):
                self.engine.ingest(self.source.source_id, pcm)
        self._kill()
