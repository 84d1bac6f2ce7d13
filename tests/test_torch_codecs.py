"""The port's codecs (``csrc/codecs.cpp`` built by ``native/lib.py``
``build_codecs``, ``audio/opusogg.py``, ``audio/aacenc.py``) against the
JAX package's (``native/codecs.cpp``), on the CPU.

- The containers, pure Python in both, byte for byte: ``ogg_crc``, Ogg
  pages, the Ogg Opus muxer and page parser, ADTS, the ``esds`` and
  ``mp4a`` entries, the ``.m4a`` writer and reader, the HLS AAC init
  segment.
- Where both packages' libraries load a codec, its output for the same
  PCM and settings, byte for byte: the Opus packets and files, the live
  Ogg Opus stream, the MP3 bytes, the AAC access units, AudioSpecificConfig
  and priming, and the decoded PCM. Where either lacks it, the test skips
  and says which.
- Round trips through the port alone, at the thresholds of JAX's
  ``tests/test_native_codecs.py`` and ``tests/test_aac.py``: Opus SNR above
  25 dB (20 dB streamed), AAC correlation above 0.99 after the priming,
  MP3 frame sync, an ``.m4a`` clip loading at its length.
- The port's ``RtspSource`` on an MPEG4-GENERIC track from the fake
  server of ``tests/test_rtsp_e2e.py`` makes JAX's windows.
- The port's ``codecs.cpp`` includes no FFmpeg, Opus or LAME header, and
  builds with the compiler and ``-ldl`` alone.
"""

from __future__ import annotations

import importlib
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_rtsp_e2e import MiniRtspServer

PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")
REPO = Path(__file__).resolve().parents[1]


def _pkg(name: str) -> SimpleNamespace:
    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("opusogg", "audio.opusogg"), ("aacenc", "audio.aacenc"),
        ("encode", "audio.encode"), ("hlsmux", "audio.hlsmux"),
        ("rtsp", "audio.rtsp"), ("engine", "audio.engine"),
        ("registry", "models.registry"))}
    return SimpleNamespace(name=name, **mod)


J, T = (_pkg(n) for n in PACKAGES)


def _both(case, *args):
    """`case` through both packages: the two results, asserted equal."""
    want, got = case(J, *args), case(T, *args)
    assert _eq(got, want), (got, want)
    return got


def _eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    return a == b


def _signal(rate: int, seconds: float, seed: int = 0,
            channels: int = 1) -> np.ndarray:
    """A 1 kHz tone (0.4 of full scale) over noise (0.01), int16,
    interleaved for two channels (the second a fifth higher)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    chans = [0.4 * np.sin(2 * np.pi * 1000 * k * t)
             + 0.01 * rng.standard_normal(len(t))
             for k in (1.0, 1.5)[:channels]]
    return (np.stack(chans, axis=1).reshape(-1) * 32767).astype(np.int16)


def _need(codec: str) -> None:
    """Skip unless both packages' codec libraries have `codec`."""
    probe = {"opus": lambda P: P.opusogg.opus_available(),
             "mp3": lambda P: P.opusogg.mp3_available(),
             "aac": lambda P: P.aacenc.available()}[codec]
    missing = [P.name for P in (J, T) if not probe(P)]
    if missing:
        pytest.skip(f"{codec} is missing from the codec library of "
                    f"{', '.join(missing)}")


def _snr(ref: np.ndarray, got: np.ndarray) -> float:
    n = min(len(ref), len(got))
    r, d = ref[:n].astype(np.float64), got[:n].astype(np.float64)
    return float(10 * np.log10((r ** 2).sum() / ((r - d) ** 2).sum()))


# -- the containers ------------------------------------------------------------------

def test_ogg_crc_and_pages_equal_jax():
    rng = np.random.default_rng(1)
    blobs = [b"", b"OggS", bytes(rng.integers(0, 256, 5000, np.uint8))]
    assert _both(lambda P: [P.opusogg.ogg_crc(b) for b in blobs])[1] == \
        0x5FB0A94F
    pkts = [bytes(rng.integers(0, 256, n, np.uint8))
            for n in (0, 1, 254, 255, 256, 510, 700)]
    pages = _both(lambda P: [
        P.opusogg._page(7, 3, 12345, pkts),
        P.opusogg._page(7, 0, 0, pkts[:1], bos=True),
        P.opusogg._page(7, 9, -1, pkts[3:], eos=True, continued=True)])
    _both(lambda P: P.opusogg.parse_ogg_pages(b"".join(pages)))


@pytest.mark.parametrize("n_packets,total", [(1, 100), (50, 48000),
                                             (123, 117000)])
def test_ogg_opus_mux_equal_jax(n_packets, total):
    rng = np.random.default_rng(n_packets)
    pkts = [bytes(rng.integers(0, 256, int(rng.integers(1, 400)),
                               np.uint8)) for _ in range(n_packets)]
    blob = _both(lambda P: P.opusogg.mux_ogg_opus(
        pkts, channels=1, preskip_48k=312, input_rate=48000,
        total_samples_48k=total))
    pages = _both(lambda P: P.opusogg.parse_ogg_pages(blob))
    assert [p for pg in pages[2:] for p in pg["packets"]] == pkts
    with pytest.raises(ValueError, match="CRC"):
        T.opusogg.parse_ogg_pages(blob[:40] + bytes([blob[40] ^ 1])
                                  + blob[41:])


@pytest.mark.parametrize("rate,channels", [(48000, 1), (44100, 2),
                                           (32000, 1), (8000, 1)])
def test_aac_containers_equal_jax(tmp_path, rate, channels):
    """ADTS both ways, the ``esds``/``mp4a`` entry, the ``.m4a`` written
    and read back, and the HLS AAC init segment, for synthetic access
    units and an ASC of the rate and channels."""
    rng = np.random.default_rng(rate + channels)
    pkts = [bytes(rng.integers(0, 256, int(rng.integers(5, 600)),
                               np.uint8)) for _ in range(40)]
    fi = T.aacenc._FREQ_INDEX[rate]
    asc = bytes([(2 << 3) | (fi >> 1), ((fi & 1) << 7) | (channels << 3)])
    adts = _both(lambda P: P.aacenc.adts_bytes(pkts, rate, channels))
    assert _both(lambda P: P.aacenc.parse_adts(adts)) == pkts
    _both(lambda P: [P.aacenc._esds(asc, 64000),
                     P.aacenc.mp4a_entry(asc, rate, channels),
                     P.aacenc.supported_rate(rate),
                     P.aacenc.supported_rate(rate + 1)])
    files = _both(lambda P: [P.aacenc.write_m4a(
        tmp_path / f"{P.name}{k}.m4a", pkts, asc, rate, channels,
        priming=k).read_bytes() for k in (0, 1024)])
    got = _both(lambda P: P.aacenc.read_m4a(tmp_path / f"{P.name}1024.m4a"))
    assert got == (pkts, asc, rate, 1024) and files[0] != files[1]
    _both(lambda P: P.hlsmux.init_segment(rate, "aac", asc))


# -- the codecs, where both libraries have them -------------------------------------------

@pytest.mark.parametrize("rate", [48000, 16000])
def test_opus_equal_jax(tmp_path, rate):
    _need("opus")
    pcm = _signal(rate, 2.0, seed=2)
    packets, preskip = _both(lambda P: P.opusogg.encode_opus_packets(
        pcm, rate))
    assert len(packets) == -(-len(pcm) // (rate // 50))
    _both(lambda P: P.opusogg.decode_opus_packets(packets, rate))
    _both(lambda P: P.opusogg.encode_ogg_opus(
        pcm, rate, tmp_path / f"{P.name}.opus").read_bytes())
    with pytest.raises(RuntimeError, match="opus-invalid rate"):
        T.opusogg.encode_opus_packets(pcm, 44100)


def test_ogg_opus_streamer_equal_jax():
    """The live stream of uneven chunks: the same Ogg bytes."""
    _need("opus")
    pcm = _signal(48000, 1.5, seed=3)
    edges = [0, 1000, 1017, 9600, 24000, 30001, 52000, len(pcm)]

    def stream(P):
        st = P.opusogg.OggOpusStreamer(48000)
        out = [st.feed(pcm[a:b]) for a, b in zip(edges, edges[1:])]
        st.close()
        return out

    parts = _both(stream)
    pages = T.opusogg.parse_ogg_pages(b"".join(parts))
    assert pages[0]["packets"][0][:8] == b"OpusHead"


@pytest.mark.parametrize("rate", [48000, 44100])
def test_mp3_equal_jax(tmp_path, rate):
    _need("mp3")
    pcm = _signal(rate, 1.0, seed=4)
    _both(lambda P: P.opusogg.encode_mp3(
        pcm, rate, tmp_path / f"{P.name}.mp3").read_bytes())


@pytest.mark.parametrize("rate,channels", [(48000, 1), (44100, 2),
                                           (16000, 1), (8000, 1)])
def test_aac_equal_jax(rate, channels):
    """The access units, the ASC and the priming of a one-shot encode and
    of a stream fed uneven chunks, and the PCM each decoder makes of
    them."""
    _need("aac")
    pcm = _signal(rate, 2.0, seed=5, channels=channels)
    packets, asc, priming = _both(
        lambda P: P.aacenc.encode_aac_with_priming(pcm, rate, channels))
    assert priming == 1024 and len(asc) == 5

    def streamed(P):
        enc = P.aacenc.AacStreamEncoder(rate, channels)
        out = []
        for off in range(0, len(pcm), 7001 * channels):
            out += enc.feed(pcm[off:off + 7001 * channels])
        out += enc.flush()
        enc.close()
        return out

    assert _both(streamed) == packets
    _both(lambda P: P.aacenc.decode_aac(packets, asc, rate, channels))


def test_aac_depacketizer_equal_jax():
    """RFC 3640 payloads of one and of two access units through each
    package's persistent decoder: the same PCM."""
    _need("aac")
    pcm = _signal(48000, 1.0, seed=6)
    packets, asc = J.aacenc.encode_aac(pcm, 48000)
    fmtp = {"config": asc.hex(), "sizelength": "13", "indexlength": "3",
            "indexdeltalength": "3"}

    def payload(aus):
        return ((16 * len(aus)).to_bytes(2, "big")
                + b"".join((len(a) << 3).to_bytes(2, "big") for a in aus)
                + b"".join(aus))

    def case(P):
        dep = P.rtsp.AacDepacketizer(48000, 1, fmtp)
        out = [dep.decode(payload([p])) for p in packets[:10]]
        out.append(dep.decode(payload(packets[10:12])))
        dep.close()
        return out

    out = _both(case)
    assert len(out[-1]) == 2048


# -- round trips through the port --------------------------------------------------------

def test_opus_round_trip_snr():
    if not T.opusogg.opus_available():
        pytest.skip("libopus is missing from the port's codec library")
    pcm = _signal(48000, 2.0, seed=7)
    packets, preskip = T.opusogg.encode_opus_packets(pcm, 48000)
    decoded = T.opusogg.decode_opus_packets(packets, 48000)
    assert _snr(pcm, decoded[preskip:]) > 25
    st = T.opusogg.OggOpusStreamer(48000)
    blob = b"".join(st.feed(pcm[a:a + 4801]) for a in range(0, len(pcm),
                                                            4801))
    st.close()
    pages = T.opusogg.parse_ogg_pages(blob)
    audio = [p for pg in pages[2:] for p in pg["packets"]]
    decoded = T.opusogg.decode_opus_packets(audio, 48000)
    assert _snr(pcm, decoded[st.preskip_48k:]) > 20
    grans = [p["granule"] for p in pages[2:]]
    assert all(a < b for a, b in zip(grans, grans[1:]))


def _aligned_corr(decoded, original, search=4096):
    """``tests/test_aac.py``'s: the correlation after the best shift."""
    d = decoded.astype(np.float64)
    o = original.astype(np.float64)
    n = min(len(o), len(d) - search)
    best = max(range(0, search, 32),
               key=lambda k: float(np.dot(d[k:k + n], o[:n])))
    return float(np.corrcoef(d[best:best + n], o[:n])[0, 1])


def test_aac_and_mp3_round_trips(tmp_path):
    """AAC: correlation above 0.99, and an ``.m4a`` clip loading at its
    length once the priming is trimmed; MP3: a frame sync."""
    if not T.aacenc.available():
        pytest.skip("libavcodec is missing from the port's codec library")
    pcm = _signal(48000, 2.0, seed=8)
    packets, asc, priming = T.aacenc.encode_aac_with_priming(pcm, 48000)
    decoded = T.aacenc.decode_aac(packets, asc, 48000)
    assert _aligned_corr(decoded, pcm) > 0.99 and priming == 1024
    out = T.encode.encode_clip(pcm, 48000, tmp_path / "c.m4a", fmt="aac")
    samples, rate = T.encode.load_clip_audio(out)
    assert out.suffix == ".m4a" and rate == 48000
    assert len(pcm) <= len(samples) < len(pcm) + 1024
    assert _aligned_corr((samples * 32768).astype(np.int16), pcm) > 0.99
    if T.opusogg.mp3_available():
        data = T.opusogg.encode_mp3(pcm, 48000, tmp_path / "c.mp3") \
            .read_bytes()
        sync = re.search(rb"\xff[\xe0-\xff]", data)
        assert sync is not None and len(data) > 4000


# -- RTSP ------------------------------------------------------------------------------------

class _PausedServer(MiniRtspServer):
    """``tests/test_rtsp_e2e.py``'s server, waiting 0.2 s after PLAY's reply
    before its first packet: JAX's client drops RTP that arrives with the
    reply (the port keeps it; ``tests/test_torch_sources.py``), so both
    clients read the whole track only when it comes apart from it."""

    def _stream(self, conn):
        time.sleep(0.2)
        super()._stream(conn)


def _aac_windows(P, pcm) -> list[np.ndarray]:
    spec = P.registry.ModelSpec(model_id="M8K", display_name="m",
                                sample_rate=8000, clip_seconds=1.0,
                                num_species=3)
    srv = _PausedServer(pcm, rate=8000, codec="MPEG4-GENERIC")
    srv.start()
    eng = P.engine.AudioEngine([spec])
    src = P.rtsp.RtspSource(eng, srv.url, source_id="cam1")
    src.start()
    windows = []
    try:
        deadline = time.time() + 15
        while time.time() < deadline and len(windows) < 3:
            windows += eng.collect_ready()
            time.sleep(0.05)
    finally:
        src.stop()
        srv.stop()
    assert src.codec == "MPEG4-GENERIC" and len(windows) >= 3
    return [w[1] for w in windows[:3]]


def test_rtsp_aac_track_windows_equal_jax():
    """An MPEG4-GENERIC (AAC-hbr) track at 8 kHz, one access unit a
    packet: the port's client makes JAX's first three windows."""
    _need("aac")
    t = np.arange(8000 * 3) / 8000.0
    pcm = (9000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    windows = _both(_aac_windows, pcm)
    spec = np.abs(np.fft.rfft(windows[1].astype(np.float64)))
    spec[0] = 0
    assert abs(np.argmax(spec) * 8000 / len(windows[1]) - 440) < 5


# -- the source -----------------------------------------------------------------------------

def test_codecs_source_includes_no_codec_header():
    src = (REPO / "birdnet_go_tpu_torch" / "csrc" / "codecs.cpp").read_text()
    included = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", src,
                          re.M)
    assert included and not [h for h in included if re.match(
        r"(libav|libsw|opus|lame|mp3lame)", h)], included
    assert "extern \"C\" {\n#include" not in src


def test_codec_library_builds_with_the_compiler_alone(tmp_path,
                                                      monkeypatch):
    """``build_codecs`` into a fresh directory: g++ and ``-ldl``, nothing
    else, and the library reports its codecs (whichever the host has)."""
    from birdnet_go_tpu_torch.native import lib

    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(lib, "_CODECS_PATH", tmp_path / "libcodecs.so")
    path = lib.build_codecs()
    assert path == tmp_path / "libcodecs.so" and path.is_file()
    import ctypes

    so = ctypes.CDLL(str(path))
    assert {so.bn_opus_available(), so.bn_mp3_available(),
            so.bn_aac_available()} <= {0, 1}
    assert lib.build_codecs() == path            # up to date: no rebuild
    assert not list(tmp_path.glob("libcodecs.so.*"))


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises, and leaves no library."""
    from birdnet_go_tpu_torch.native import lib

    bad = tmp_path / "codecs.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lib, "_CODECS_SRC", bad)
    monkeypatch.setattr(lib, "_CODECS_PATH",
                        tmp_path / "build" / "libcodecs.so")
    with pytest.raises(RuntimeError, match="codec build failed"):
        lib.build_codecs()
    assert not list((tmp_path / "build").glob("libcodecs.so*"))
