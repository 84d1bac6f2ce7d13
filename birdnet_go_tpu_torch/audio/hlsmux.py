"""HLS live-audio muxer: fMP4 segments carrying AAC-LC (FLAC fallback).

Reference: internal/audiocore/hlsmux (hlsmux.go, segment.go, playlist.go,
codec_aac.go) — live audio → fMP4 segments + rolling playlist for browser
streaming. Segments carry AAC-LC (mp4a + esds, via the native encoder in
audio.aacenc — what stock Safari/Chrome MSE plays) through ONE persistent
stream encoder so segment joins are sample-exact. Hosts without an AAC
encoder, and the 256 kHz bat capture (no AAC sampling index), fall back
to RFC 9639 FLAC-in-ISO-BMFF ('fLaC' sample entry + 'dfLa'
FLACSpecificBox; each MP4 sample = one FLAC frame).

Layout served per source:
  playlist.m3u8   rolling live playlist (#EXT-X-MAP → init.mp4)
  init.mp4        ftyp + moov (track, sample description, mvex/trex)
  seg<N>.m4s      styp + moof (mfhd/tfhd/tfdt/trun) + mdat (FLAC frames)

Sessions auto-expire without heartbeats (audio_hls.go start/stop/heartbeat
contract).

A copy of ``birdnet_go_tpu/audio/hlsmux.py`` for the port, which imports
nothing of the JAX package; its AAC segments come from the port's codec
library (``audio/aacenc.py``). ``tests/test_torch_aux.py`` and
``tests/test_torch_codecs.py`` hold the module to the original.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import threading
import time
from collections import OrderedDict

import numpy as np

from birdnet_go_tpu_torch.audio.flac import _BLOCK, encode_flac_frames, streaminfo_block

log = logging.getLogger("birdnet_tpu.hls")

SEGMENT_SECONDS = 2.0
KEEP_SEGMENTS = 6
SESSION_TTL_SECONDS = 60.0


# ------------------------------------------------------------------ MP4 boxes

def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(kind, struct.pack(">B", version)
               + struct.pack(">I", flags)[1:] + payload)


def init_segment(sample_rate: int, codec: str = "flac",
                 asc: bytes = b"") -> bytes:
    """ftyp + moov for a single mono audio track (track_ID 1).

    codec "aac": mp4a + esds sample entry carrying the encoder's
    AudioSpecificConfig — what stock Safari/Chrome MSE plays (reference
    hlsmux/codec_aac.go). codec "flac": RFC 9639 fLaC-in-ISO-BMFF
    fallback for hosts without an AAC encoder."""
    ftyp = box(b"ftyp", b"iso5" + struct.pack(">I", 512) + b"iso6mp41")

    if codec == "aac":
        from birdnet_go_tpu_torch.audio.aacenc import mp4a_entry

        sample_entry = mp4a_entry(asc, sample_rate)
    else:
        # sample description: fLaC sample entry + dfLa (STREAMINFO)
        streaminfo = streaminfo_block(sample_rate, 0)
        dfla = full_box(b"dfLa", 0, 0,
                        bytes([0x80, 0, 0, len(streaminfo)]) + streaminfo)
        # SampleEntry rate is 16.16 fixed point — rates ≥ 65536 Hz (the
        # bat 256 kHz capture) can't be represented; per ISO/IEC 14496-12
        # the authoritative rate is the mdhd timescale, so clamp the
        # entry field.
        entry_rate = min(sample_rate, 0xFFFF)
        sample_entry = box(
            b"fLaC",
            b"\x00" * 6 + struct.pack(">H", 1)      # data ref idx
            + b"\x00" * 8                            # reserved
            + struct.pack(">HH", 1, 16)              # ch, bits
            + b"\x00" * 4
            + struct.pack(">I", entry_rate << 16)    # rate 16.16
            + dfla)
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stts = full_box(b"stts", 0, 0, struct.pack(">I", 0))
    stsc = full_box(b"stsc", 0, 0, struct.pack(">I", 0))
    stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, 0))
    stco = full_box(b"stco", 0, 0, struct.pack(">I", 0))
    stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
    url_ = full_box(b"url ", 0, 1, b"")
    dref = full_box(b"dref", 0, 0, struct.pack(">I", 1) + url_)
    dinf = box(b"dinf", dref)
    smhd = full_box(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    minf = box(b"minf", smhd + dinf + stbl)
    hdlr = full_box(b"hdlr", 0, 0,
                    b"\x00" * 4 + b"soun" + b"\x00" * 12 + b"SoundHandler\x00")
    # mdhd: timescale = sample rate so durations are in samples
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIII", 0, 0, sample_rate, 0)
                    + struct.pack(">HH", 0x55C4, 0))          # lang 'und'
    mdia = box(b"mdia", mdhd + hdlr + minf)
    tkhd = full_box(b"tkhd", 0, 7,
                    struct.pack(">IIII", 0, 0, 1, 0)          # track_ID 1
                    + struct.pack(">I", 0)                    # duration
                    + b"\x00" * 8
                    + struct.pack(">HHHH", 0, 0, 0x0100, 0)   # volume 1.0
                    + _unity_matrix() + struct.pack(">II", 0, 0))
    trak = box(b"trak", tkhd + mdia)
    mvhd = full_box(b"mvhd", 0, 0,
                    struct.pack(">IIII", 0, 0, 1000, 0)
                    + struct.pack(">I", 0x00010000)           # rate 1.0
                    + struct.pack(">H", 0x0100)               # volume
                    + b"\x00" * 10 + _unity_matrix()
                    + b"\x00" * 24 + struct.pack(">I", 2))    # next track
    trex = full_box(b"trex", 0, 0, struct.pack(">IIIII", 1, 1, 0, 0, 0))
    mvex = box(b"mvex", trex)
    moov = box(b"moov", mvhd + trak + mvex)
    return ftyp + moov


def _unity_matrix() -> bytes:
    return struct.pack(">9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                       0x40000000)


def media_segment(seq: int, base_decode_time: int,
                  frames: list[bytes], frame_durations: list[int]) -> bytes:
    """styp + moof + mdat for one segment (each FLAC frame = one sample)."""
    styp = box(b"styp", b"msdh" + struct.pack(">I", 0) + b"msdhmsix")
    mfhd = full_box(b"mfhd", 0, 0, struct.pack(">I", seq))
    # tfhd: default-base-is-moof (0x020000)
    tfhd = full_box(b"tfhd", 0, 0x020000, struct.pack(">I", 1))
    tfdt = full_box(b"tfdt", 1, 0, struct.pack(">Q", base_decode_time))
    # trun: data-offset + sample-duration + sample-size per sample
    n = len(frames)
    trun_payload = struct.pack(">I", n)
    trun_payload += struct.pack(">i", 0)            # patched below
    for dur, f in zip(frame_durations, frames):
        trun_payload += struct.pack(">II", dur, len(f))
    trun = full_box(b"trun", 0, 0x000301, trun_payload)
    traf = box(b"traf", tfhd + tfdt + trun)
    moof = box(b"moof", mfhd + traf)
    mdat = box(b"mdat", b"".join(frames))
    # data offset = from moof start to first mdat payload byte
    data_offset = len(moof) + 8
    # patch the trun data_offset field (moof: 8 hdr + mfhd + traf(8 hdr +
    # tfhd + tfdt + trun(12 hdr+ver+flags + 4 count -> offset)))
    off = (8 + len(mfhd) + 8 + len(tfhd) + len(tfdt)
           + 8 + 4 + 4)                             # into moof
    moof = moof[:off] + struct.pack(">i", data_offset) + moof[off + 4:]
    return styp + moof + mdat


# ------------------------------------------------------------------ sessions

@dataclasses.dataclass
class _Segment:
    seq: int
    data: bytes
    duration: float


class HlsSession:
    """One live source → rolling fMP4/FLAC segments."""

    def __init__(self, source_id: str, capture_buffer,
                 segment_seconds: float = SEGMENT_SECONDS,
                 codec: str | None = None):
        self.source_id = source_id
        self.capture = capture_buffer
        self.segment_seconds = segment_seconds
        self.sample_rate = capture_buffer.sample_rate
        # codec auto-select: AAC when the native encoder exists and the
        # rate has an AAC sampling index (the 256 kHz bat capture keeps
        # lossless FLAC); explicit codec= overrides for tests
        self._aac = None
        if codec is None:
            from birdnet_go_tpu_torch.audio import aacenc

            codec = ("aac" if aacenc.available()
                     and aacenc.supported_rate(self.sample_rate)
                     else "flac")
        self.codec = codec
        if codec == "aac":
            from birdnet_go_tpu_torch.audio.aacenc import AacStreamEncoder

            self._aac = AacStreamEncoder(self.sample_rate, 1, 96000)
            self.init = init_segment(self.sample_rate, "aac",
                                     self._aac.asc)
        else:
            self.init = init_segment(self.sample_rate)
        self._segments: "OrderedDict[int, _Segment]" = OrderedDict()
        self._seq = 0
        self._frame_no = 0
        self._decode_time = 0
        self._next_start: float | None = None
        self.last_heartbeat = time.time()
        self._lock = threading.Lock()

    def tick(self, now: float | None = None) -> bool:
        """Cut the next segment if enough wall clock has passed."""
        now = time.time() if now is None else now
        if self._next_start is None:
            self._next_start = now - self.segment_seconds
        if now - self._next_start < self.segment_seconds:
            return False
        start = self._next_start
        end = start + self.segment_seconds
        pcm = self.capture.read_segment(start, end)
        self._next_start = end
        if self._aac is not None:
            # persistent encoder: partial 1024-sample frames carry over,
            # so consecutive segments join sample-exactly (no per-segment
            # encoder reset / priming click)
            from birdnet_go_tpu_torch.audio.aacenc import AAC_FRAME_SAMPLES

            frames = self._aac.feed(pcm)
            if not frames:
                return False
            durations = [AAC_FRAME_SAMPLES] * len(frames)
            consumed = len(frames) * AAC_FRAME_SAMPLES
        else:
            frames = encode_flac_frames(pcm, self.sample_rate,
                                        first_frame_number=self._frame_no)
            if not frames:
                return False
            durations = []
            remaining = len(pcm)
            for _ in frames:
                durations.append(min(_BLOCK, remaining))
                remaining -= durations[-1]
            consumed = len(pcm)
        seg = media_segment(self._seq + 1, self._decode_time, frames,
                            durations)
        with self._lock:
            self._seq += 1
            self._segments[self._seq] = _Segment(
                self._seq, seg, self.segment_seconds)
            while len(self._segments) > KEEP_SEGMENTS:
                self._segments.popitem(last=False)
        self._frame_no += len(frames)
        self._decode_time += consumed
        return True

    def playlist(self) -> str:
        with self._lock:
            segs = list(self._segments.values())
        lines = ["#EXTM3U", "#EXT-X-VERSION:7",
                 f"#EXT-X-TARGETDURATION:{int(self.segment_seconds) + 1}",
                 f"#EXT-X-MEDIA-SEQUENCE:{segs[0].seq if segs else 1}",
                 '#EXT-X-MAP:URI="init.mp4"']
        for s in segs:
            lines.append(f"#EXTINF:{s.duration:.3f},")
            lines.append(f"seg{s.seq}.m4s")
        return "\n".join(lines) + "\n"

    def segment(self, seq: int) -> bytes | None:
        with self._lock:
            s = self._segments.get(seq)
            return s.data if s else None


class HlsManager:
    """Per-source sessions + the segmenter thread (hlsmux Manager role)."""

    def __init__(self, engine, segment_seconds: float = SEGMENT_SECONDS):
        self.engine = engine
        self.segment_seconds = segment_seconds
        self._sessions: dict[str, HlsSession] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start_session(self, source_id: str) -> HlsSession | None:
        cb = self.engine.capture_buffer(source_id)
        if cb is None:
            return None
        with self._lock:
            s = self._sessions.get(source_id)
            if s is None:
                s = HlsSession(source_id, cb, self.segment_seconds)
                self._sessions[source_id] = s
                log.info("HLS session started for %s", source_id)
            s.last_heartbeat = time.time()
        self._ensure_thread()
        return s

    def get(self, source_id: str) -> HlsSession | None:
        with self._lock:
            return self._sessions.get(source_id)

    def heartbeat(self, source_id: str) -> bool:
        with self._lock:
            s = self._sessions.get(source_id)
            if s is None:
                return False
            s.last_heartbeat = time.time()
            return True

    def stop_session(self, source_id: str) -> bool:
        with self._lock:
            return self._sessions.pop(source_id, None) is not None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _ensure_thread(self) -> None:
        # under the lock: a racing start_session during the old thread's
        # exit window must not be left untended
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="hls-segmenter", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        # the thread idles when no sessions exist (cheap: one wakeup per
        # quarter segment) instead of exiting — a self-exit races
        # start_session's is_alive() check and strands new sessions
        while not self._stop.wait(self.segment_seconds / 4):
            now = time.time()
            with self._lock:
                sessions = list(self._sessions.items())
            for sid, s in sessions:
                if now - s.last_heartbeat > SESSION_TTL_SECONDS:
                    self.stop_session(sid)
                    log.info("HLS session for %s expired", sid)
                    continue
                try:
                    s.tick(now)
                except Exception:
                    log.exception("HLS segment cut failed for %s", sid)
