"""Native RTSP/RTP audio client (TCP-interleaved) — ingest without FFmpeg.

Reference: internal/audiocore/ffmpeg delegates RTSP to an FFmpeg
subprocess; this client speaks the protocol directly so uncompressed /
G.711 camera audio works even without the binary (FFmpeg remains the
path for compressed codecs): OPTIONS → DESCRIBE (SDP audio track) →
SETUP (RTP/AVP/TCP interleaved) → PLAY, then '$'-framed RTP packets are
depacketized and decoded host-side.

Codecs: L16 (RFC 3551 network-order PCM), PCMU/PCMA (G.711 µ-law/A-law,
table-decoded), and dynamic rtpmap variants thereof. Supervision matches
FfmpegSource: reconnect with exponential backoff, quick-exit detection,
TEARDOWN on stop. Basic auth from the URL userinfo.

A copy of ``birdnet_go_tpu/audio/rtsp.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_sources.py`` holds it to the
original (the SDP parser, the payload decoder bit for bit, both clients
against one ``RtspLoadServer``, TEARDOWN, backoff, the stream kept on a
reconnect and rebuilt on a rate change, an MPEG4-GENERIC track through
the port's AAC decoder). Two divergences:

- ``_run_once`` starts the RTP stream with what arrived in the same read
  as PLAY's reply. JAX's passes on what arrived with SETUP's (nothing)
  and drops it: on a busy host, where the reply and the first packets
  are read together, its stream then starts mid-packet, resyncs at the
  next ``$`` and loses packets
  (``test_rtsp_keeps_what_arrives_with_the_play_reply``).
- ``_pump`` hands the engine every whole packet a read holds in one
  ``ingest`` (and counts ``packets`` as they go in), where JAX's ingests
  each packet. A source that fell behind (its audio waiting in the socket
  while the engine's gate or the GIL held it) then catches up in a few
  gate turns instead of one a packet. On an NVIDIA H100 80GB HBM3
  (700.00 W) host, in one of four runs of ``chip_smoke.py`` phase 19's
  app leg with a packet an ingest, the eight 44.1 kHz sources ended
  11.4 s behind their server and stayed there (the same samples arrive
  either way;
  ``test_rtsp_ingests_what_a_read_holds_at_once``).
"""

from __future__ import annotations

import base64
import logging
import socket
import struct
import threading
import time
from urllib.parse import urlparse, urlunparse

import numpy as np

from birdnet_go_tpu_torch.audio.source import AudioSource, SourceType, safe_string

log = logging.getLogger("birdnet_tpu.rtsp")

_QUICK_EXIT_SECONDS = 5.0
_MAX_BACKOFF = 60.0


def _g711_mulaw_table() -> np.ndarray:
    out = np.zeros(256, np.int16)
    for u in range(256):
        v = ~u & 0xFF
        sign = v & 0x80
        exp = (v >> 4) & 7
        mant = v & 0x0F
        sample = (((mant << 3) + 0x84) << exp) - 0x84
        out[u] = -sample if sign else sample
    return out


def _g711_alaw_table() -> np.ndarray:
    out = np.zeros(256, np.int16)
    for a in range(256):
        v = a ^ 0x55
        sign = v & 0x80
        exp = (v >> 4) & 7
        mant = v & 0x0F
        if exp == 0:
            sample = (mant << 4) + 8
        else:
            sample = ((mant << 4) + 0x108) << (exp - 1)
        # A-law sign bit SET means positive (G.711 / Sun g711.c convention)
        out[a] = sample if sign else -sample
    return out


MULAW = _g711_mulaw_table()
ALAW = _g711_alaw_table()


def decode_payload(codec: str, payload: bytes, channels: int) -> np.ndarray:
    """RTP payload → mono int16."""
    if codec == "L16":
        n = len(payload) & ~1
        pcm = np.frombuffer(payload[:n], dtype=">i2").astype(np.int16)
    elif codec == "PCMU":
        pcm = MULAW[np.frombuffer(payload, np.uint8)]
    elif codec == "PCMA":
        pcm = ALAW[np.frombuffer(payload, np.uint8)]
    else:
        raise ValueError(f"unsupported RTP codec {codec!r}")
    if channels > 1:
        k = len(pcm) // channels
        pcm = pcm[:k * channels].reshape(k, channels).mean(axis=1) \
            .astype(np.int16)
    return pcm


class AacDepacketizer:
    """RFC 3640 MPEG4-GENERIC (AAC-hbr) RTP depacketizer + decoder.

    Cameras commonly ship AAC audio; the reference leans on FFmpeg for
    this (stream.go media handling) — here the AU-headers section is
    parsed natively and each access unit decodes through ONE persistent
    libavcodec decoder (AAC's MDCT overlap-add means per-AU decoder
    instances would click at every frame boundary). fmtp keys honored:
    config (AudioSpecificConfig hex), sizeLength (13), indexLength (3),
    indexDeltaLength (3)."""

    def __init__(self, rate: int, channels: int, fmtp: dict[str, str]):
        from birdnet_go_tpu_torch.native import lib as native

        nlib = native._load_codecs()
        if nlib is None or not hasattr(nlib, "bn_aac_decoder_create") \
                or not nlib.bn_aac_available():
            raise ValueError("native AAC decoder unavailable for "
                             "MPEG4-GENERIC stream")
        self._lib = nlib
        self.channels = max(1, channels)
        self.size_len = int(fmtp.get("sizelength", 13))
        self.index_len = int(fmtp.get("indexlength", 3))
        self.index_delta_len = int(fmtp.get("indexdeltalength", 3))
        asc = bytes.fromhex(fmtp.get("config", ""))
        self._h = nlib.bn_aac_decoder_create(asc, len(asc), rate,
                                             self.channels)
        if not self._h:
            raise ValueError("AAC decoder init failed (bad config?)")
        self._out = np.zeros(8192 * self.channels, np.int16)
        self._out_ptr = native._i16_ptr(self._out)   # hot path: once

    def decode(self, payload: bytes) -> np.ndarray:
        """One RTP payload → mono int16 (possibly several AUs)."""
        if len(payload) < 2:
            return np.empty(0, np.int16)
        hdr_bits = int.from_bytes(payload[:2], "big")
        n_hdr_bytes = (hdr_bits + 7) // 8
        bits = int.from_bytes(payload[2:2 + n_hdr_bytes], "big")
        sizes = []
        consumed = 0
        first = True
        while True:
            # each AU header is sizeLength + (indexLength for the FIRST
            # AU, indexDeltaLength for the rest) bits — using a fixed
            # stride would drop the final AU whenever the two differ
            step = self.size_len \
                + (self.index_len if first else self.index_delta_len)
            if consumed + step > hdr_bits:
                break
            shift = n_hdr_bytes * 8 - consumed - self.size_len
            sizes.append((bits >> shift) & ((1 << self.size_len) - 1))
            consumed += step
            first = False
        data = payload[2 + n_hdr_bytes:]
        pcm_parts = []
        off = 0
        for sz in sizes:
            au = data[off:off + sz]
            off += sz
            if not au:
                break
            n = self._lib.bn_aac_decoder_decode(
                self._h, au, len(au), self._out_ptr,
                len(self._out) // self.channels)
            if n > 0:
                pcm = self._out[:n * self.channels]
                if self.channels > 1:
                    pcm = pcm.reshape(n, self.channels).mean(axis=1) \
                        .astype(np.int16)
                pcm_parts.append(pcm.copy())
        if not pcm_parts:
            return np.empty(0, np.int16)
        return np.concatenate(pcm_parts)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_aac_decoder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_STATIC_PT = {0: ("PCMU", 8000, 1), 8: ("PCMA", 8000, 1),
              10: ("L16", 44100, 2), 11: ("L16", 44100, 1)}


def parse_sdp_audio(sdp: str) -> dict | None:
    """First audio media section → {payload_type, codec, rate, channels,
    control}."""
    section = None
    for line in sdp.splitlines():
        line = line.strip()
        if line.startswith("m="):
            if line.startswith("m=audio"):
                parts = line.split()
                pt = int(parts[3]) if len(parts) > 3 else 0
                codec, rate, ch = _STATIC_PT.get(pt, (None, 0, 1))
                section = {"payload_type": pt, "codec": codec,
                           "rate": rate, "channels": ch, "control": "",
                           "fmtp": {}}
            elif section is not None:
                break                       # next media section: done
        elif section is not None:
            if line.startswith("a=rtpmap:"):
                body = line[len("a=rtpmap:"):]
                pt_s, _, enc = body.partition(" ")
                if int(pt_s) == section["payload_type"]:
                    fields = enc.split("/")
                    section["codec"] = fields[0].upper()
                    if len(fields) > 1:
                        section["rate"] = int(fields[1])
                    if len(fields) > 2:
                        section["channels"] = int(fields[2])
            elif line.startswith("a=control:"):
                section["control"] = line[len("a=control:"):]
            elif line.startswith("a=fmtp:"):
                body = line[len("a=fmtp:"):]
                pt_s, _, params = body.partition(" ")
                try:
                    pt_match = int(pt_s) == section["payload_type"]
                except ValueError:
                    pt_match = False
                if pt_match:
                    for kv in params.split(";"):
                        k, _, v = kv.strip().partition("=")
                        if k:
                            section["fmtp"][k.lower()] = v
    return section


class RtspSource:
    """Self-healing native RTSP source (FfmpegSource drop-in)."""

    def __init__(self, engine, url: str, source_id: str | None = None):
        u = urlparse(url)
        self.engine = engine
        self.url = url
        self._auth = None
        if u.username:
            cred = f"{u.username}:{u.password or ''}"
            self._auth = "Basic " + base64.b64encode(cred.encode()).decode()
            u = u._replace(netloc=u.hostname
                           + (f":{u.port}" if u.port else ""))
        self._clean_url = urlunparse(u)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 554
        self.source = AudioSource(
            source_id=source_id or safe_string(url),
            source_type=SourceType.RTSP,
            display_name=safe_string(url), uri=url,
            sample_rate=48000)            # updated from SDP at connect
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._registered = False
        self.restarts = 0
        self.packets = 0
        self.bytes_received = 0
        self.codec = ""

    # -- lifecycle -----------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._supervise, name=f"rtsp-{self.source.source_id}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._registered:
            self.engine.remove_source(self.source.source_id)
            self._registered = False

    def _supervise(self) -> None:
        backoff = 1.0
        while not self._stop.is_set():
            started = time.monotonic()
            try:
                self._run_once()
            except Exception as e:  # noqa: BLE001
                log.warning("rtsp %s failed: %s", self.source.source_id, e)
            if self._stop.is_set():
                return
            ran = time.monotonic() - started
            backoff = min(backoff * 2, _MAX_BACKOFF) \
                if ran < _QUICK_EXIT_SECONDS else 1.0
            self.restarts += 1
            self._stop.wait(backoff)

    # -- protocol ------------------------------------------------------------------

    def _request(self, sock, method: str, url: str, cseq: int,
                 extra: dict | None = None) -> dict:
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {cseq}",
                 "User-Agent: birdnet-tpu"]
        if self._auth:
            lines.append(f"Authorization: {self._auth}")
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        return self._read_response(sock)

    def _read_response(self, sock) -> dict:
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("RTSP connection closed")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode(errors="replace").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        body = rest
        clen = int(headers.get("content-length", 0))
        while len(body) < clen:
            chunk = sock.recv(4096)
            if not chunk:    # peer closed mid-body: recv returns b'' forever
                raise ConnectionError("RTSP connection closed mid-body")
            body += chunk
        if status != 200:
            raise ConnectionError(f"RTSP {lines[0]}")
        headers["_body"] = body[:clen].decode(errors="replace")
        headers["_extra"] = body[clen:]
        return headers

    def _run_once(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        sock.settimeout(15)
        try:
            cseq = 1
            self._request(sock, "OPTIONS", self._clean_url, cseq)
            cseq += 1
            resp = self._request(sock, "DESCRIBE", self._clean_url, cseq,
                                 {"Accept": "application/sdp"})
            audio = parse_sdp_audio(resp["_body"])
            if audio is None or not audio.get("codec"):
                raise ConnectionError("no supported audio track in SDP")
            self.codec = audio["codec"]
            control = audio["control"]
            setup_url = control if control.startswith("rtsp") \
                else (self._clean_url.rstrip("/") + "/" + control
                      if control else self._clean_url)
            cseq += 1
            resp = self._request(
                sock, "SETUP", setup_url, cseq,
                {"Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
            session = resp.get("session", "").split(";")[0]
            cseq += 1
            # the RTP that came in with PLAY's reply starts the stream
            # (JAX's passes on SETUP's leftover and drops it)
            resp = self._request(sock, "PLAY", self._clean_url, cseq,
                                 {"Session": session,
                                  "Range": "npt=0.000-"})

            # Register the source at the SDP rate (AudioSource is
            # immutable — rebuild it). On RECONNECT with an unchanged rate
            # the existing engine stream is reused: tearing it down would
            # orphan the CaptureBuffer that live HLS sessions and pending
            # clip exports hold, and would discard the capture pre-roll.
            import dataclasses as _dc

            if self._registered \
                    and self.source.sample_rate != audio["rate"]:
                self.engine.remove_source(self.source.source_id)
                self._registered = False
            if not self._registered:
                self.source = _dc.replace(self.source,
                                          sample_rate=audio["rate"])
                self.engine.add_source(self.source)
                self._registered = True
            log.info("rtsp %s: %s/%d Hz/%dch via TCP-interleaved",
                     self.source.source_id, self.codec, audio["rate"],
                     audio["channels"])

            leftover = resp.get("_extra", b"")
            sock.settimeout(1.0)          # stop() honored within a second
            self._pump(sock, leftover, audio)
            # graceful teardown — fire and forget (the connection closes
            # right after; many servers don't interleave the reply)
            try:
                cseq += 1
                sock.sendall(
                    (f"TEARDOWN {self._clean_url} RTSP/1.0\r\n"
                     f"CSeq: {cseq}\r\nSession: {session}\r\n\r\n").encode())
            except Exception:
                pass
        finally:
            sock.close()

    def _pump(self, sock, buf: bytes, audio: dict) -> None:
        """'$'-framed interleaved RTP → decode → engine.ingest, once for
        every whole packet read so far, before the next read waits."""
        channels = audio["channels"]
        aac = None
        if self.codec in ("MPEG4-GENERIC", "AAC"):
            aac = AacDepacketizer(audio["rate"], channels,
                                  audio.get("fmtp", {}))
        pending: list[np.ndarray] = []
        sizes = [0, 0]                      # packets, payload bytes pending

        def _ingest() -> None:
            if pending:
                self.engine.ingest(self.source.source_id,
                                   pending[0] if len(pending) == 1
                                   else np.concatenate(pending))
                self.packets += sizes[0]
                self.bytes_received += sizes[1]
                pending.clear()
                sizes[:] = [0, 0]

        def _recv() -> bytes:
            """Blocking read that still honors stop() (1 s sock timeout).
            An idle stream longer than the silence window is a failure —
            the supervisor reconnects (watchdog contract). What was
            decoded goes to the engine first."""
            _ingest()
            idle = 0.0
            while True:
                try:
                    chunk = sock.recv(65536)
                except TimeoutError:
                    if self._stop.is_set():
                        return b""
                    idle += 1.0
                    if idle >= 30.0:
                        raise ConnectionError("RTP silence timeout")
                    continue
                if not chunk:
                    raise ConnectionError("stream closed")
                return chunk

        try:
            while not self._stop.is_set():
                while len(buf) < 4:
                    chunk = _recv()
                    if not chunk:
                        return
                    buf += chunk
                if buf[0:1] != b"$":
                    # resync: RTSP keepalive responses may interleave
                    nl = buf.find(b"$")
                    if nl < 0:
                        buf = b""
                        continue
                    buf = buf[nl:]
                    continue
                chan = buf[1]
                (length,) = struct.unpack(">H", buf[2:4])
                while len(buf) < 4 + length:
                    chunk = _recv()
                    if not chunk:
                        return
                    buf += chunk
                packet = buf[4:4 + length]
                buf = buf[4 + length:]
                if chan != 0 or len(packet) < 12:
                    continue                    # RTCP / runt
                # RTP header: V(2) P X CC | M PT | seq | ts | ssrc | CSRCs
                cc = packet[0] & 0x0F
                has_ext = packet[0] & 0x10
                offset = 12 + 4 * cc
                if has_ext and len(packet) >= offset + 4:
                    (_, ext_len) = struct.unpack(">HH",
                                                 packet[offset:offset + 4])
                    offset += 4 + 4 * ext_len
                payload = packet[offset:]
                if packet[0] & 0x20 and payload:            # padding
                    pad = payload[-1]
                    # pad==0 is spec-invalid but seen in the wild; [:-0]
                    # would discard the whole payload — treat it as "no
                    # padding"
                    if 0 < pad <= len(payload):
                        payload = payload[:-pad]
                if not payload:
                    continue
                pcm = (aac.decode(payload) if aac is not None
                       else decode_payload(self.codec, payload, channels))
                if len(pcm):
                    pending.append(pcm)
                    sizes[0] += 1
                    sizes[1] += len(payload)
        finally:
            _ingest()
