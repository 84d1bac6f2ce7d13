"""The port's live sources (``audio/rtsp.py``, ``audio/capture.py``,
``audio/ffmpeg.py``) against the JAX package's, on the CPU.

Each case runs once through the JAX package's module and once through the
port's copy from the same inputs and records what it observes; ``_both``
asserts the two records equal. Bit for bit: the SDP parser on static,
dynamic and audio-less bodies; ``decode_payload`` (L16 mono and stereo,
PCMU, PCMA) and the G.711 tables; ``convert_to_s16`` for every format and
its refusal; ``resolve_device``; ``build_ffmpeg_args`` in every media
mode; ``probe_stream`` and ``analyze_channels`` with an injected ``run``
and without the binaries; ``FfmpegSource``'s media-mode fallback, its
quick-exit streak and its silence watchdog with a fake ``Popen``;
``SoundcardSource`` over a fake ``AlsaCapture``.

``RtspSource`` runs against real servers over loopback TCP: ``_MiniRtsp``
(a small RTSP/RTP server in this file: L16 or PCMU, a sample rate a
session, realtime pacing or as fast as the socket takes it, TEARDOWN
seen) and the port's native ``RtspLoadServer``. Each package's client
gets a server of its own, built from the same arguments, so both receive
the same samples: the PCMU session's, and the first 24,000 samples of a
load server session (whose waveform and phase follow from its seed and
its session count). Also through both: TEARDOWN on stop, backoff against
a port that closes every connection, the engine stream kept on a
reconnect at the same rate and rebuilt on a rate change, a response
closed mid-body, and an MPEG4-GENERIC track refused alike where the
AAC decoder is missing (``tests/test_torch_codecs.py`` decodes one). The
port's two divergences have tests of their own: a read's packets
ingested at once, and the RTP read along with PLAY's reply kept
(JAX's drops it; where that struck, the JAX side of a sample comparison
is run again, ``_both_sessions``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import socket
import struct
import subprocess
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{name}.{path}")
                              for k, path in (
        ("rtsp", "audio.rtsp"), ("capture", "audio.capture"),
        ("ffmpeg", "audio.ffmpeg"), ("native", "native"),
        ("sysmonitor", "utils.sysmonitor"))})


J, T = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])


def _plain(x):
    """A comparable value: dataclasses by class name and fields, enums by
    value, arrays as lists, tuples as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if hasattr(x, "value") and type(x).__module__.startswith(PACKAGES):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(case, *args):
    want, got = case(J, *args), case(T, *args)
    assert _plain(got) == _plain(want)
    return got


def _wait(cond, seconds: float = 10.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


class _Engine:
    """A stand-in engine: what sources register and ingest."""

    def __init__(self):
        self.events: list = []
        self.pcm: list[np.ndarray] = []
        self.lock = threading.Lock()

    def add_source(self, source) -> None:
        self.events.append(("add", source.source_id, source.sample_rate,
                            source.source_type.value))

    def remove_source(self, source_id) -> None:
        self.events.append(("remove", source_id))

    def ingest(self, source_id, pcm, timestamp=None) -> None:
        with self.lock:
            self.pcm.append(np.array(pcm))

    def samples(self) -> np.ndarray:
        with self.lock:
            return (np.concatenate(self.pcm) if self.pcm
                    else np.empty(0, np.int16))


# -- SDP and payloads ----------------------------------------------------------

SDPS = {
    "dynamic": ("v=0\r\nm=video 0 RTP/AVP 96\r\na=control:trackV\r\n"
                "m=audio 0 RTP/AVP 97\r\na=rtpmap:97 L16/48000/2\r\n"
                "a=fmtp:97 foo=1;Bar=two\r\na=control:trackA\r\n"
                "m=application 0 RTP/AVP 98\r\n"),
    "static_pcmu": "v=0\r\nm=audio 0 RTP/AVP 0\r\na=control:rtsp://x/a\r\n",
    "static_pcma": "m=audio 0 RTP/AVP 8\r\n",
    "static_l16": "m=audio 0 RTP/AVP 10\r\n",
    "aac": ("m=audio 0 RTP/AVP 96\r\na=rtpmap:96 mpeg4-generic/16000/1\r\n"
            "a=fmtp:96 mode=AAC-hbr;config=1408;sizeLength=13\r\n"),
    "unknown_pt": "m=audio 0 RTP/AVP 99\r\n",
    "no_audio": "v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(SDPS))
def test_parse_sdp_audio_as_jax(name):
    _both(lambda P: P.rtsp.parse_sdp_audio(SDPS[name]))


def _payloads():
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, 480).astype(np.int16)
    return {"L16": pcm.astype(">i2").tobytes() + b"\x07",   # odd byte
            "PCMU": rng.integers(0, 256, 333).astype(np.uint8).tobytes(),
            "PCMA": rng.integers(0, 256, 333).astype(np.uint8).tobytes()}


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("codec", ["L16", "PCMU", "PCMA"])
def test_decode_payload_bit_for_bit(codec, channels):
    payload = _payloads()[codec]
    out = _both(lambda P: P.rtsp.decode_payload(codec, payload, channels))
    assert out.dtype == np.int16


def test_g711_tables_and_refusal_as_jax():
    _both(lambda P: (P.rtsp.MULAW, P.rtsp.ALAW))
    for P in (J, T):
        with pytest.raises(ValueError, match="unsupported RTP codec"):
            P.rtsp.decode_payload("G722", b"\x00\x01", 1)


def test_aac_track_refused_as_jax_without_the_decoder(monkeypatch):
    """On a host without libavcodec both depacketizers raise the same
    ``ValueError`` (the decoding of an AAC track where both codec
    libraries have it is ``tests/test_torch_codecs.py``'s)."""
    import birdnet_go_tpu.native.lib as jlib
    import birdnet_go_tpu_torch.native.lib as tlib

    monkeypatch.setattr(jlib, "_load", lambda: None)
    monkeypatch.setattr(tlib, "_load_codecs", lambda: None)
    errors = []
    for P in (J, T):
        with pytest.raises(ValueError) as e:
            P.rtsp.AacDepacketizer(16000, 1, {"config": "1408"})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- capture --------------------------------------------------------------------

def _raw(fmt: str, channels: int) -> bytes:
    rng = np.random.default_rng(len(fmt) + channels)
    n = 301 * channels
    if fmt == "s16le":
        return rng.integers(-32768, 32768, n).astype("<i2").tobytes() + b"x"
    if fmt == "s24_3le":
        v = rng.integers(-(1 << 23), 1 << 23, n)
        return b"".join(struct.pack("<i", int(x))[:3] for x in v) + b"yz"
    if fmt in ("s24le", "s32le"):
        hi = 1 << (23 if fmt == "s24le" else 31)
        return rng.integers(-hi, hi, n).astype("<i4").tobytes() + b"abc"
    return (rng.standard_normal(n) * 0.7).astype("<f4").tobytes() + b"q"


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt", ["s16le", "s24_3le", "s24le", "s32le",
                                 "f32le"])
def test_convert_to_s16_as_jax(fmt, channels):
    raw = _raw(fmt, channels)
    out = _both(lambda P: P.capture.convert_to_s16(raw, fmt, channels))
    assert out.dtype == np.int16 and len(out) == 301


def test_convert_to_s16_refuses_as_jax():
    for P in (J, T):
        with pytest.raises(ValueError, match="unsupported capture format"):
            P.capture.convert_to_s16(b"\x00\x00", "u8")


CARDS = [{"index": 0, "id": "PCH", "alsa_name": "hw:0,0"},
         {"index": 3, "id": "Mic", "alsa_name": "hw:3,0",
          "usb_vendor": "0d8c", "usb_product": "0014",
          "usb_serial": "ABC123"}]


@pytest.mark.parametrize("spec", ["usb:0d8c", "usb:0d8c:0014",
                                  "usb:0d8c:0014:ABC123", "usb:0d8c::",
                                  "hw:1,0", "default", "usb:ffff",
                                  "usb:0d8c:9999", "usb:0d8c:0014:XYZ"])
def test_resolve_device_as_jax(spec, monkeypatch):
    def case(P):
        monkeypatch.setattr(P.sysmonitor, "audio_devices", lambda: CARDS)
        try:
            return P.capture.resolve_device(spec)
        except RuntimeError as e:
            return ("RuntimeError", str(e))

    _both(case)


class _FakeCapture:
    """``AlsaCapture``'s stand-in: hands out `chunks`, then fails as a
    device unplugged would."""

    opened: list = []

    def __init__(self, device="default", rate=48000, channels=1,
                 latency_us=100000):
        self.args = (device, rate, channels)
        self.chunks = [np.arange(k, k + 4800, dtype=np.int16) * 3
                       for k in range(0, 5 * 97, 97)] + [None]
        self.closed = False
        _FakeCapture.opened.append(self)

    def read(self, frames):
        if not self.chunks:
            raise RuntimeError("ALSA read failed")
        pcm = self.chunks.pop(0)
        return None if pcm is None else pcm[:frames]

    def close(self):
        self.closed = True


@pytest.mark.parametrize("device", ["hw:2,0", "usb:0d8c:0014"])
def test_soundcard_source_feeds_the_engine_as_jax(device, monkeypatch):
    """The chunks a capture reads reach the engine unchanged, and stop()
    closes the capture and removes the source."""
    def case(P):
        monkeypatch.setattr(P.native, "alsa_available", lambda: True)
        monkeypatch.setattr(P.native, "AlsaCapture", _FakeCapture)
        monkeypatch.setattr(P.sysmonitor, "audio_devices", lambda: CARDS)
        _FakeCapture.opened = []
        eng = _Engine()
        src = P.capture.SoundcardSource(eng, device=device, rate=32000,
                                        channels=2, chunk_seconds=0.05)
        src.start()
        src._thread.join(5)
        cap = _FakeCapture.opened[0]
        src.stop()
        return (src.source, src.chunk_frames, cap.args, cap.closed,
                eng.events, eng.pcm)

    got = _both(case)
    assert got[3] is True and len(got[5]) == 5


def test_soundcard_source_refuses_without_alsa(monkeypatch):
    for P in (J, T):
        monkeypatch.setattr(P.native, "alsa_available", lambda: False)
        src = P.capture.SoundcardSource(_Engine())
        with pytest.raises(RuntimeError, match="ALSA capture unavailable"):
            src.start()


# -- ffmpeg ---------------------------------------------------------------------

@pytest.mark.parametrize("url,kw", [
    ("rtsp://cam/1", {}),
    ("rtsp://cam/1", {"media_mode": "full"}),
    ("rtsp://cam/1", {"transport": "udp", "channels": 2,
                      "sample_rate": 32000}),
    ("http://cam/stream.mp3", {}),
    ("http://cam/stream.mp3", {"media_mode": "full"}),
])
def test_build_ffmpeg_args_as_jax(url, kw):
    _both(lambda P: P.ffmpeg.build_ffmpeg_args(url, **kw))


class _Ran:
    def __init__(self, rc, stdout=b"", stderr=b""):
        self.returncode, self.stdout, self.stderr = rc, stdout, stderr


PROBE = json.dumps({
    "streams": [{"codec_type": "video", "codec_name": "h264"},
                {"codec_type": "audio", "codec_name": "aac",
                 "sample_rate": "16000", "channels": 2}],
    "format": {"format_name": "rtsp"}}).encode()


def _timeout(cmd, **kw):
    raise subprocess.TimeoutExpired(cmd, 1)


PROBE_RUNS = {
    "ok": lambda cmd, **kw: _Ran(0, PROBE),
    "video_only": lambda cmd, **kw: _Ran(0, json.dumps(
        {"streams": [{"codec_type": "video"}]}).encode()),
    "failed": lambda cmd, **kw: _Ran(1, stderr=b"401 Unauthorized " * 40),
    "garbled": lambda cmd, **kw: _Ran(0, b"{not json"),
    "timeout": _timeout,
}


@pytest.mark.parametrize("url", ["rtsp://cam/1", "http://cam/a.mp3"])
@pytest.mark.parametrize("run", sorted(PROBE_RUNS))
def test_probe_stream_as_jax(run, url, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda n: f"/usr/bin/{n}")

    def case(P):
        calls = []

        def fake(cmd, **kw):
            calls.append((cmd, kw))
            return PROBE_RUNS[run](cmd, **kw)

        return P.ffmpeg.probe_stream(url, transport="udp", run=fake), calls

    _both(case)


def test_probes_without_the_binaries_as_jax(monkeypatch):
    """No ffprobe, no ffmpeg (the card's machine): both helpers answer
    ``ok: False`` with JAX's error, running nothing."""
    monkeypatch.setattr(shutil, "which", lambda n: None)

    def case(P):
        monkeypatch.setattr(P.ffmpeg, "ffmpeg_available", lambda: False)
        ran = []
        return (P.ffmpeg.probe_stream("rtsp://cam/1", run=ran.append),
                P.ffmpeg.analyze_channels("rtsp://cam/1", run=ran.append),
                ran)

    got = _both(case)
    assert got[0]["ok"] is False and got[1]["ok"] is False


def _channels_pcm(channels: int) -> bytes:
    n = 4800
    x = np.zeros((n, channels), np.int16)
    x[:, -1] = np.where(np.arange(n) % 2 == 0, 16000, -16000)
    if channels > 2:
        x[:, 1] = 40
    return x.tobytes() + b"\x01"


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("run", ["ok", "empty", "failed", "timeout"])
def test_analyze_channels_as_jax(run, channels, monkeypatch):
    runs = {"ok": lambda cmd, **kw: _Ran(0, _channels_pcm(channels)),
            "empty": lambda cmd, **kw: _Ran(0, b"", b"no audio"),
            "failed": lambda cmd, **kw: _Ran(1, b"", b"refused"),
            "timeout": _timeout}

    def case(P):
        monkeypatch.setattr(P.ffmpeg, "ffmpeg_available", lambda: True)
        calls = []

        def fake(cmd, **kw):
            calls.append((cmd, kw))
            return runs[run](cmd, **kw)

        return P.ffmpeg.analyze_channels("rtsp://cam/1", seconds=0.5,
                                         channels=channels, run=fake), calls

    _both(case)


class _NoWait:
    """A stop event whose waits return at once: the supervisor's backoff
    is recorded, not slept."""

    def __init__(self):
        self._set = False
        self.waits = []

    def is_set(self):
        return self._set

    def set(self):
        self._set = True

    def clear(self):
        self._set = False

    def wait(self, timeout=None):
        self.waits.append(timeout)
        return self._set


class _FakePopen:
    """A ffmpeg process that exits at once, after `data` chunks (none:
    a dataless quick exit)."""

    def __init__(self, args, data, log, src, launches):
        log.append("audio_only" if "-allowed_media_types" in args
                   else "full")
        if len(log) >= launches:
            src._stop.set()
        chunks = list(data)

        class _Out:
            @staticmethod
            def read(n):
                return chunks.pop(0) if chunks else b""

        self.stdout = _Out()

    def poll(self):
        return 1

    def terminate(self):
        pass

    def wait(self, timeout=None):
        return 1

    def kill(self):
        pass


@pytest.mark.parametrize("url", ["rtsp://cam/stream", "http://cam/a.mp3"])
@pytest.mark.parametrize("data,streak", [((), 0), ((), 4),
                                         ((b"\x00\x01" * 160,), 4)])
def test_ffmpeg_source_fallback_and_streak_as_jax(url, data, streak,
                                                  monkeypatch):
    """The supervisor over eight quick exits: dataless exits in
    audio-only mode switch an RTSP source to the full stream after two
    and tag the fifth; an exit with data breaks the streak. The modes
    launched, the backoffs, the streak and the samples ingested as
    JAX's."""
    def case(P):
        monkeypatch.setattr(P.ffmpeg, "_QUICK_EXIT_SECONDS", 10.0)
        eng = _Engine()
        src = P.ffmpeg.FfmpegSource(eng, url)
        src._stop = _NoWait()
        src._quick_exits = streak
        modes = []
        monkeypatch.setattr(P.ffmpeg.subprocess, "Popen",
                            lambda args, **kw: _FakePopen(
                                args, data, modes, src, 8))
        src._supervise()
        return (modes, src._stop.waits, src.media_mode, src._quick_exits,
                src.restarts, src.bytes_received, eng.pcm, src.source)

    _both(case)


def test_ffmpeg_silence_watchdog_as_jax(monkeypatch):
    def case(P):
        src = P.ffmpeg.FfmpegSource(_Engine(), "rtsp://cam/1",
                                    source_id="cam")
        src.last_data = time.monotonic() - 120
        killed = []
        src._kill = lambda: killed.append(True)
        src._watch_silence(SimpleNamespace(poll=lambda: None))
        return killed, src._silence_kills

    assert _both(case) == ([True], 1)


def test_ffmpeg_source_refuses_without_the_binary(monkeypatch):
    for P in (J, T):
        monkeypatch.setattr(P.ffmpeg, "ffmpeg_available", lambda: False)
        src = P.ffmpeg.FfmpegSource(_Engine(), "http://cam/a.mp3")
        with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
            src.start()


# -- RTSP over loopback ------------------------------------------------------------

def _mulaw_encode(pcm: np.ndarray, table: np.ndarray) -> bytes:
    """The nearest µ-law code of each sample (exact for table values)."""
    d = np.abs(table.astype(np.int32)[None, :] - pcm.astype(np.int32)[:, None])
    return d.argmin(axis=1).astype(np.uint8).tobytes()


class _MiniRtsp(threading.Thread):
    """OPTIONS, DESCRIBE, SETUP, PLAY and TEARDOWN over TCP, then
    interleaved RTP of `pcm` (L16 at payload type 97, or PCMU at 0): a
    session a connection, each on a thread of its own; `rates` gives each
    session's SDP rate (the last repeats); `one_shot` ends each session
    after its audio, so the client reconnects; `close_at_once` closes
    every connection at accept; `burst` sends a session's packets in one
    write, 0.2 s after PLAY's reply (as a pause every session has), and
    `coalesce` in the same write as that reply. It serves only its own
    path: under
    parallel test workers another worker's client may retry a port this
    server got from the OS after it, and is turned away."""

    def __init__(self, pcm: np.ndarray, codec: str = "L16",
                 rates=(8000,), packet: int = 160, realtime: bool = False,
                 one_shot: bool = False, close_at_once: bool = False,
                 burst: bool = False, coalesce: bool = False):
        super().__init__(daemon=True)
        self.pcm, self.codec, self.rates = pcm.astype(np.int16), codec, rates
        self.packet, self.realtime, self.one_shot = packet, realtime, one_shot
        self.close_at_once, self.burst = close_at_once, burst
        self.coalesce = coalesce
        self.sessions = 0
        self._lock = threading.Lock()
        self.path = f"/mini-{os.urandom(4).hex()}"
        self.teardown = threading.Event()
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()

    def url(self, user: str = "") -> str:
        return f"rtsp://{user}127.0.0.1:{self.port}{self.path}"

    def run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            if not self.close_at_once:
                self._session(conn)
        except OSError:
            pass
        finally:
            conn.close()

    def _session(self, conn):
        conn.settimeout(10)
        buf, rate = b"", None
        while not self._stop.is_set():
            while b"\r\n\r\n" not in buf:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            lines = head.decode(errors="replace").split("\r\n")
            method = lines[0].split(" ", 1)[0]
            if rate is None:
                if self.path not in lines[0]:
                    return
                with self._lock:
                    rate = self.rates[min(self.sessions,
                                          len(self.rates) - 1)]
                    self.sessions += 1
            cseq = next((ln.split(":", 1)[1].strip() for ln in lines
                         if ln.lower().startswith("cseq")), "0")
            body = ""
            if method == "DESCRIBE":
                pt = 97 if self.codec == "L16" else 0
                body = (f"v=0\r\nm=audio 0 RTP/AVP {pt}\r\n"
                        + (f"a=rtpmap:97 L16/{rate}/1\r\n" if pt else "")
                        + "a=control:track1\r\n")
            reply = (f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                     "Session: 1234;timeout=60\r\n"
                     + (f"Content-Length: {len(body)}\r\n" if body
                        else "") + "\r\n" + body).encode()
            if method == "PLAY" and self.coalesce:
                conn.sendall(reply + b"".join(self._frames()))
                time.sleep(0.2)
                continue
            conn.sendall(reply)
            if method == "TEARDOWN":
                self.teardown.set()
                return
            if method == "PLAY":
                if self._stream(conn, rate) or self.one_shot:
                    return

    def _frames(self) -> list[bytes]:
        """The session's '$'-framed RTP packets."""
        from birdnet_go_tpu_torch.audio.rtsp import MULAW

        out, ts = [], 0
        for seq, at in enumerate(range(0, len(self.pcm), self.packet)):
            chunk = self.pcm[at:at + self.packet]
            payload = (chunk.astype(">i2").tobytes() if self.codec == "L16"
                       else _mulaw_encode(chunk, MULAW))
            rtp = struct.pack(">BBHII", 0x80, 97 if self.codec == "L16"
                              else 0, seq & 0xFFFF, ts, 0xBEEF) + payload
            out.append(b"$\x00" + struct.pack(">H", len(rtp)) + rtp)
            ts += len(chunk)
        return out

    def _stream(self, conn, rate) -> bool:
        """Sends the audio; True when the client sent TEARDOWN."""
        import select

        time.sleep(0.2)          # the reply read apart from the packets
        frames = self._frames()
        if self.burst:
            conn.sendall(b"".join(frames))
            frames = []
        for frame in frames:
            if self._stop.is_set():
                return False
            if select.select([conn], [], [], 0)[0]:
                data = conn.recv(4096)
                if not data or b"TEARDOWN" in data:
                    self.teardown.set()
                    return True
            conn.sendall(frame)
            if self.realtime:
                time.sleep(self.packet / rate)
        time.sleep(0.2)
        return False

    def stop(self):
        self._stop.set()
        self._srv.close()


def _tone(n: int, rate: int) -> np.ndarray:
    t = np.arange(n) / rate
    return (9000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)


def _session(P, srv, n: int, source_id: str, user: str = "",
             seconds: float = 10.0):
    """The package's ``RtspSource`` on `srv` (started here, and stopped
    with the source) until it has ingested `n` samples or `seconds` have
    passed: (the engine, the
    source, whether a read brought RTP along with PLAY's reply, which
    JAX's client drops)."""
    srv.start()
    eng = _Engine()
    url = (srv.url(user) if isinstance(srv, _MiniRtsp)
           else f"rtsp://127.0.0.1:{srv.port}/cam0")
    src = P.rtsp.RtspSource(eng, url, source_id=source_id)
    extra = []
    read = src._read_response
    src._read_response = lambda sock: (r := read(sock), extra.append(
        len(r["_extra"])))[0]
    src.start()
    try:
        deadline = time.monotonic() + seconds
        while sum(map(len, eng.pcm)) < n and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        src.stop()
        srv.stop()
        if not isinstance(srv, _MiniRtsp):
            srv.close()
    return eng, src, any(extra)


def _both_sessions(run):
    """`run(P)` → (record, whether JAX's fault struck) through both
    packages, the records asserted equal. JAX's run is made again, up to
    three times, where its client read RTP along with PLAY's reply and
    dropped it (``test_rtsp_keeps_what_arrives_with_the_play_reply``);
    every such run is one more chance, not a pass."""
    for _ in range(3):
        want, dropped = run(J)
        if not dropped:
            break
    got, _ = run(T)
    assert _plain(got) == _plain(want)
    return got


@pytest.mark.parametrize("codec", ["L16", "PCMU"])
def test_rtsp_session_ingests_as_jax(codec):
    """A whole session from ``_MiniRtsp`` (Basic auth in the URL):
    the samples ingested, the source registered at the SDP rate, the
    codec and the packets as JAX's."""
    def run(P):
        srv = _MiniRtsp(_tone(8000 * 2, 8000), codec=codec)
        eng, src, dropped = _session(P, srv, 16000, "cam1", "cam:s3cret@")
        return (eng.samples(), eng.events[0], src.codec, src.packets,
                src.bytes_received, src._auth, src._clean_url
                .replace(str(srv.port), "<port>").replace(srv.path,
                                                          "<path>")), dropped

    got = _both_sessions(run)
    assert len(got[0]) == 16000 and got[3] == 100
    assert got[1] == ("add", "cam1", 8000, "rtsp")


def test_rtsp_keeps_what_arrives_with_the_play_reply():
    """The port's repair: a server that writes PLAY's reply and the first
    packets at once (a busy client then reads them together). The port's
    client ingests the whole session; JAX's starts its stream with what
    arrived with SETUP's reply, drops those packets, lands mid-packet and
    loses more before it resyncs."""
    pcm = _tone(8000 * 2, 8000)
    got = []
    for P in (J, T):
        eng, src, dropped = _session(
            P, _MiniRtsp(pcm, coalesce=True), 16000, "cam4",
            seconds=10.0 if P is T else 2.0)
        got.append(eng.samples())
        assert dropped
    np.testing.assert_array_equal(got[1], pcm)
    assert len(got[0]) < len(pcm)


def test_rtsp_ingests_what_a_read_holds_at_once():
    """The port's divergence: every whole packet a read holds goes to the
    engine in one ``ingest`` (JAX's: one a packet), so a source that fell
    behind catches up in a few turns of the engine's gate. A session sent
    in one burst: the same samples and packet count as JAX's, in fewer
    ingests than packets."""
    def run(P):
        srv = _MiniRtsp(_tone(8000 * 2, 8000), codec="PCMU", burst=True)
        eng, src, dropped = _session(P, srv, 16000, "cam3")
        return (eng.samples(), src.packets, len(eng.pcm)), dropped

    (want, n, calls), (got, n_got, calls_got) = run(J)[0], run(T)[0]
    np.testing.assert_array_equal(got, want)
    assert n == n_got == calls == 100 and calls_got < n_got


def test_rtsp_sources_ingest_a_load_server_session_as_jax():
    """Each client against a native ``RtspLoadServer`` of its own (same
    rate and seed: its first session gets the same waveform and phase):
    the first 24,000 samples ingested are equal."""
    from birdnet_go_tpu_torch.native.lib import RtspLoadServer

    def run(P):
        srv = RtspLoadServer(rate=48000, n_waveforms=4, seed=9, pkt_ms=20)
        eng, src, dropped = _session(P, srv, 24000, "load0")
        return (eng.samples()[:24000], eng.events[0], src.codec), dropped

    pcm = _both_sessions(run)[0]
    assert len(pcm) == 24000 and np.abs(pcm.astype(np.int32)).max() > 1000


def test_rtsp_stop_sends_teardown_as_jax():
    def case(P):
        srv = _MiniRtsp(np.zeros(8000 * 60, np.int16), realtime=True)
        srv.start()
        src = P.rtsp.RtspSource(_Engine(), srv.url(), source_id="cam2")
        src.start()
        try:
            _wait(lambda: src.packets >= 5)
            src.stop()
            seen = srv.teardown.wait(5)
        finally:
            srv.stop()
        return seen, src._thread is None

    assert _both(case) == (True, True)


def test_rtsp_backs_off_against_a_dead_port_as_jax(monkeypatch):
    """A server that closes every connection: each failure is a restart,
    and the backoff doubles from 2 s up to the cap (the waits recorded,
    not slept)."""
    def case(P):
        srv = _MiniRtsp(np.zeros(10, np.int16), close_at_once=True)
        srv.start()
        src = P.rtsp.RtspSource(_Engine(), srv.url(), source_id="dead")
        src._stop = _NoWait()
        runs = []
        real = src._run_once

        def once():
            runs.append(1)
            if len(runs) == 8:
                src._stop.set()
            real()

        src._run_once = once
        try:
            src._supervise()
        finally:
            srv.stop()
        return src.restarts, src._stop.waits

    restarts, waits = _both(case)
    assert restarts == 7 and waits == [2.0, 4.0, 8.0, 16.0, 32.0, 60.0,
                                       60.0]


@pytest.mark.parametrize("rates,removed", [((8000,), False),
                                           ((8000, 16000), True)])
def test_rtsp_reconnect_keeps_or_rebuilds_the_stream_as_jax(rates,
                                                            removed):
    """A session that ends makes the client reconnect: at the same SDP
    rate the engine's stream is kept (live HLS and pending clips hold its
    capture buffer); at another rate it is removed and added again at the
    new rate."""
    def case(P):
        srv = _MiniRtsp(_tone(1600, 8000), rates=rates, one_shot=True)
        srv.start()
        eng = _Engine()
        src = P.rtsp.RtspSource(eng, srv.url(), source_id="camR")
        src.start()
        try:
            _wait(lambda: src.restarts >= 1 and src.packets >= 15)
            events = list(eng.events)       # before stop() removes it
        finally:
            src.stop()
            srv.stop()
        return events[:3], src.source.sample_rate

    events, rate = _both(case)
    assert (("remove", "camR") in events) is removed
    assert rate == rates[-1]


def test_rtsp_response_closed_mid_body_raises_as_jax():
    class _Sock:
        def __init__(self):
            self.chunks = [b"RTSP/1.0 200 OK\r\nCSeq: 1\r\nContent-Length: "
                           b"100\r\n\r\npartial"]

        def recv(self, n):
            return self.chunks.pop(0) if self.chunks else b""

    for P in (J, T):
        src = P.rtsp.RtspSource.__new__(P.rtsp.RtspSource)
        with pytest.raises(ConnectionError, match="mid-body"):
            src._read_response(_Sock())


def test_rtsp_refuses_a_track_without_audio_as_jax():
    """DESCRIBE without an audio section: the session fails before SETUP
    and the source registers nothing."""
    class _NoAudio(_MiniRtsp):
        def _session(self, conn):
            conn.settimeout(5)
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += conn.recv(4096)
            conn.sendall(b"RTSP/1.0 200 OK\r\nCSeq: 1\r\n\r\n")
            buf = buf.partition(b"\r\n\r\n")[2]
            while b"\r\n\r\n" not in buf:
                buf += conn.recv(4096)
            body = SDPS["no_audio"]
            conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: 2\r\nContent-Length: "
                          f"{len(body)}\r\n\r\n{body}").encode())

    def case(P):
        srv = _NoAudio(np.zeros(1, np.int16))
        srv.start()
        eng = _Engine()
        src = P.rtsp.RtspSource(eng, srv.url(), source_id="v")
        try:
            with pytest.raises(ConnectionError, match="no supported audio"):
                src._run_once()
        finally:
            srv.stop()
        return eng.events, src.codec

    _both(case)
