"""The port's offline analysis path against the JAX package's, on the CPU.

The same seeded numpy inputs go through each JAX function and its port:
resampling (and the ``resample_48k_32k`` golden fingerprint, read only),
window slicing, 1/3-octave sound levels, WAV reading and writing, labels
and eBird codes, the Raven and CSV tables, and ``OfflineAnalyzer`` as a
whole on tiny float32 models whose weights the JAX ``init`` made.
Tolerances: resampling 1e-6 absolute (float32 sums in another order),
sound levels 1e-3 dB, analyzer confidences 1e-5 (indices equal except
among values tied to 1e-5), table confidences 1e-4 (their 4 decimals).
"""

import dataclasses
import io
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_go_tpu.analysis import offline as joff
from birdnet_go_tpu.analysis import raven as jraven
from birdnet_go_tpu.analysis import results as jresults
from birdnet_go_tpu.audio import wav as jwav
from birdnet_go_tpu.inference.backend import JaxClassifier
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.models.perch_v2 import PerchV2 as JPerchV2
from birdnet_go_tpu.ops import resample as jresample
from birdnet_go_tpu.ops import soundlevel as jsoundlevel
from birdnet_go_tpu.ops import windows as jwindows
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu.taxonomy import labels as jlabels
from birdnet_go_tpu_torch.analysis import offline as toff
from birdnet_go_tpu_torch.analysis import raven as traven
from birdnet_go_tpu_torch.analysis import results as tresults
from birdnet_go_tpu_torch.audio import wav as twav
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import registry as treg
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import BlockSpec as TBlock
from birdnet_go_tpu_torch.models.efficientnet import EfficientNetConfig as TNet
from birdnet_go_tpu_torch.ops import resample as tresample
from birdnet_go_tpu_torch.ops import soundlevel as tsoundlevel
from birdnet_go_tpu_torch.ops import windows as twindows
from birdnet_go_tpu_torch.ops.melspec import MelConfig as TMel
from birdnet_go_tpu_torch.taxonomy import labels as tlabels

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


def _signal(shape, seed, rate=48000):
    """A tone per row plus white noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / rate
    f = rng.uniform(200.0, rate / 2.5, (*shape[:-1], 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


# -- resampling ----------------------------------------------------------------

@pytest.mark.parametrize("in_rate,out_rate,shape", [
    (48000, 32000, (9600,)), (32000, 48000, (6400,)),
    (48000, 48000, (1000,)), (48000, 32000, (2, 3, 4801)),
    (32000, 48000, (2, 3, 3201)),
    # 44.1 → 48 kHz is L/M = 160/147 (7,681 taps): 0.25 s of input only,
    # the JAX conv is slow on the CPU
    (44100, 48000, (2, 11025)), (22050, 48000, (3000,))])
def test_polyphase_resample_matches_jax(in_rate, out_rate, shape):
    x = _signal(shape, in_rate + len(shape), in_rate)
    jcfg = jresample.ResampleConfig(in_rate, out_rate)
    tcfg = tresample.ResampleConfig(in_rate, out_rate)
    assert tcfg.ratio == jcfg.ratio
    assert tcfg.out_len(shape[-1]) == jcfg.out_len(shape[-1])
    want = np.asarray(jresample.polyphase_resample(jnp.asarray(x), jcfg))
    got = tresample.polyphase_resample(torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6


def test_resample_filter_equals_jax():
    for l, m in ((2, 3), (3, 2), (160, 147)):
        np.testing.assert_array_equal(
            tresample._design_filter(l, m, 24, 8.6, 0.97),
            jresample._design_filter(l, m, 24, 8.6, 0.97))


def test_resample_matches_golden_fingerprint():
    """The fingerprint ``tests/test_golden_parity.py`` records for the JAX
    resampler, read (never written) and compared at its tolerances."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(48000).astype(np.float32) * 0.3
    y = tresample.polyphase_resample(
        torch.from_numpy(x), tresample.ResampleConfig(48000, 32000)).numpy()
    want = json.loads((GOLDEN / "resample_48k_32k.json").read_text())
    flat = y.astype(np.float64).ravel()
    assert want["shape"] == list(y.shape)
    np.testing.assert_allclose(np.linalg.norm(flat), want["norm"], rtol=1e-3)
    np.testing.assert_allclose(flat[want["sample_idx"]], want["sample"],
                               rtol=1e-3, atol=1e-4)


# -- windows -------------------------------------------------------------------

@pytest.mark.parametrize("clip,overlap,rate,clip_seconds", [
    (144000, 0.0, 48000, None), (144000, 1.5, 48000, None),
    (144000, 2.9, 48000, None), (144000, 5.0, 48000, None),
    (144000, -1.0, 48000, None), (160000, 1.5, 32000, 5.0),
    (160000, 2.9, 32000, 5.0), (30, 2.0, 10, None), (1, 2.9, 48000, None)])
def test_window_hop_samples_equals_jax(clip, overlap, rate, clip_seconds):
    args = (clip, overlap, rate, 3.0, clip_seconds)
    assert (twindows.window_hop_samples(*args)
            == jwindows.window_hop_samples(*args))


def test_num_windows_equals_jax():
    for total in (-1, 0, 1, 99, 100, 101, 250, 1000):
        for hop in (1, 30, 100, 150):
            for pad in (True, False):
                assert (twindows.num_windows(total, 100, hop, pad)
                        == jwindows.num_windows(total, 100, hop, pad))


@pytest.mark.parametrize("shape,clip,hop,pad_final", [
    ((50,), 100, 30, True),           # shorter than a clip
    ((50,), 100, 30, False),          # ... without padding: no window
    ((100,), 100, 30, True),          # exactly one clip
    ((1000,), 100, 100, True),        # whole clips, no tail
    ((1010,), 100, 100, True),        # a padded tail
    ((1010,), 100, 100, False),
    ((150000,), 144000, 4800, True),  # overlap 2.9 s at 48 kHz
    ((2, 3, 777), 100, 33, True), ((0,), 100, 30, True)])
def test_slice_overlapped_windows_equals_jax(shape, clip, hop, pad_final):
    x = _signal(shape, 3) if shape[-1] else np.zeros(shape, np.float32)
    want = np.asarray(jwindows.slice_overlapped_windows(
        jnp.asarray(x), clip, hop, pad_final))
    xt = torch.from_numpy(x)
    got = twindows.slice_overlapped_windows(xt, clip, hop, pad_final)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[-1] and (shape[-1] - clip) % hop == 0 and shape[-1] >= clip:
        # no padded tail: the windows are a view of the signal
        assert got.untyped_storage().data_ptr() == \
            xt.untyped_storage().data_ptr()


# -- sound levels --------------------------------------------------------------

@pytest.mark.parametrize("shape,cfg", [
    ((2, 48000), {}),
    ((3, 2, 24000), dict(sample_rate=32000, n_fft=2048, fmax=16000.0)),
    ((20000,), dict(n_fft=1024, fmin=100.0))])
def test_band_levels_db_matches_jax(shape, cfg):
    rate = cfg.get("sample_rate", 48000)
    x = _signal(shape, 11, rate)
    want, wc = jsoundlevel.band_levels_db(
        jnp.asarray(x), jsoundlevel.SoundLevelConfig(**cfg))
    got, tc = tsoundlevel.band_levels_db(
        torch.from_numpy(x), tsoundlevel.SoundLevelConfig(**cfg))
    np.testing.assert_array_equal(tc, wc)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-3


def test_third_octave_centers_equal_jax():
    for lo, hi in ((25.0, 20000.0), (100.0, 8000.0), (1.0, 1e5)):
        np.testing.assert_array_equal(tsoundlevel.third_octave_centers(lo, hi),
                                      jsoundlevel.third_octave_centers(lo, hi))


# -- WAV -----------------------------------------------------------------------

def _riff(tag, channels, rate, bits, data, sub_tag=None, odd_chunk=False):
    """A RIFF/WAVE file: fmt (extensible when `sub_tag` is set), an
    optional odd-sized chunk (word-aligned), then data."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, rate, rate * block, block,
                      bits)
    if sub_tag is not None:
        fmt += struct.pack("<HHIH", 22, bits, 0, sub_tag) + bytes(14)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if odd_chunk:
        body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _wav_cases():
    rng = np.random.default_rng(7)
    f = rng.uniform(-0.9, 0.9, 2400).astype("<f4")
    i16 = rng.integers(-32768, 32768, 2400).astype("<i2")
    i32 = rng.integers(-2 ** 31, 2 ** 31, 2400).astype("<i4")
    u8 = rng.integers(0, 256, 2400).astype(np.uint8)
    i24 = rng.integers(0, 256, 2400 * 3).astype(np.uint8).tobytes()
    silent32 = np.concatenate([np.zeros(2000, "<i4"), i32[:400]])
    return {
        "u8 mono": _riff(1, 1, 8000, 8, u8.tobytes()),
        "i16 stereo": _riff(1, 2, 44100, 16, i16.tobytes()),
        "i16 odd chunk": _riff(1, 1, 48000, 16, i16.tobytes(), odd_chunk=True),
        "i24 mono": _riff(1, 1, 48000, 24, i24),
        "i24 extensible 3 ch": _riff(0xFFFE, 3, 96000, 24, i24, sub_tag=1),
        "i32": _riff(1, 1, 48000, 32, i32.tobytes()),
        "i32 silent head": _riff(1, 1, 48000, 32, silent32.tobytes()),
        "f32 stereo": _riff(3, 2, 32000, 32, f.tobytes()),
        "f32 labelled pcm": _riff(1, 1, 48000, 32, f.tobytes()),
        "f32 extensible": _riff(0xFFFE, 2, 48000, 32, f.tobytes(), sub_tag=3),
    }


@pytest.mark.parametrize("name", list(_wav_cases()))
def test_read_wav_equals_jax(name):
    blob = _wav_cases()[name]
    for mono in (True, False):
        want, winfo = jwav.read_wav(io.BytesIO(blob), mono=mono)
        got, tinfo = twav.read_wav(io.BytesIO(blob), mono=mono)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert dataclasses.astuple(tinfo) == dataclasses.astuple(winfo)


def test_read_wav_rejects_like_jax(tmp_path):
    bad = {"not riff": b"RIFX" + bytes(40),
           "no data": _riff(1, 1, 48000, 16, b"")[:-8],
           "12-bit": _riff(1, 1, 48000, 12, bytes(30))}
    for name, blob in bad.items():
        for mod in (jwav, twav):
            with pytest.raises(ValueError):
                mod.read_wav(io.BytesIO(blob))
    path = tmp_path / "x.wav"
    path.write_bytes(_wav_cases()["i16 stereo"])
    np.testing.assert_array_equal(twav.read_wav(path)[0],
                                  jwav.read_wav(path)[0])


def test_write_wav_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    for samples in (rng.uniform(-1.2, 1.2, 1001).astype(np.float32),
                    rng.integers(-32768, 32768, 999).astype(np.int16)):
        blobs = []
        for mod in (jwav, twav):
            buf = io.BytesIO()
            mod.write_wav(buf, samples, 22050)
            path = tmp_path / f"{mod.__name__}.wav"
            mod.write_wav(path, samples, 22050)
            assert path.read_bytes() == buf.getvalue()
            blobs.append(buf.getvalue())
        assert blobs[0] == blobs[1]


# -- labels --------------------------------------------------------------------

def _pairs(labelset):
    return [(s.scientific, s.common) for s in labelset.species]


def _same_labels(t, j):
    assert _pairs(t) == _pairs(j)
    assert (t.locale, t.codes) == (j.locale, j.codes)


@pytest.mark.parametrize("locale", ["en_us", "de", "xx"])
def test_load_labels_equals_jax(locale):
    data = REPO / "data" / "taxonomy"
    t = tlabels.load_labels(data, locale=locale)
    j = jlabels.load_labels(data, locale=locale)
    assert len(t) == 6522 and len(t.codes) > 6000
    _same_labels(t, j)
    for i in (0, 17, 6521):
        assert t.code_for(t[i]) == j.code_for(j[i])
    assert tlabels.load_ebird_codes(data) == jlabels.load_ebird_codes(data)
    assert (tlabels.load_genus_taxonomy(data)
            == jlabels.load_genus_taxonomy(data))


def test_synthetic_labels_fallback_equals_jax(tmp_path, monkeypatch):
    data = REPO / "data" / "taxonomy"
    cases = [dict(data_dir=tmp_path), dict(data_dir=data, expected_count=19),
             dict(data_dir=data, model_id="Perch_V2", expected_count=4)]
    for kw in cases:
        t, j = tlabels.load_labels(**kw), jlabels.load_labels(**kw)
        assert t.codes is None
        _same_labels(t, j)
        assert [t.code_for(s) for s in t.species] == \
            [j.code_for(s) for s in j.species]
    # labels installed beside a model under $BIRDNET_TPU_MODELS
    staged = tmp_path / "models" / "Perch_V2" / "labels"
    staged.mkdir(parents=True)
    (staged / "en_us.txt").write_text("Parus major_Great Tit\nHuman vocal_"
                                      "Human vocal\n", encoding="utf-8")
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path / "models"))
    t = tlabels.load_labels(data, model_id="Perch_V2")
    _same_labels(t, jlabels.load_labels(data, model_id="Perch_V2"))
    assert _pairs(t) == [("Parus major", "Great Tit"),
                         ("Human vocal", "Human vocal")]
    assert tlabels.resolve_data_dir(None) == jlabels.resolve_data_dir(None)


# -- tables --------------------------------------------------------------------

def _detections(mod, species_mod):
    rows = [("Poecile atricapillus", "Black-capped Chickadee", 0.9016, 0.0,
             "bkcchi"),
            ('Strix "aluco"', "Tawny, Owl", 0.123456, 10.5, "tawowl1"),
            ("Human vocal", "Human vocal", 0.99995, 123.45, "humanvocal"),
            ("Ünïcode sp", "Ñandú", 0.00005, 1.25, "")]
    return [mod.Detection(species=species_mod.Species(sci, common),
                          confidence=conf, begin_seconds=begin,
                          end_seconds=begin + 3.0, model_id="BirdNET_V2.4",
                          window_index=i * 3, species_code=code)
            for i, (sci, common, conf, begin, code) in enumerate(rows)]


def test_tables_equal_jax(tmp_path):
    t = _detections(tresults, tlabels)
    j = _detections(jresults, jlabels)
    assert traven.format_raven_table(t, "a b.wav") == \
        jraven.format_raven_table(j, "a b.wav")
    assert traven.format_csv(t) == jraven.format_csv(j)
    assert traven.format_csv([]) == jraven.format_csv([])
    for tw, jw in ((traven.write_raven_table, jraven.write_raven_table),
                   (traven.write_csv, jraven.write_csv)):
        a = tw(t, "in/field.rec.wav", tmp_path / "t")
        b = jw(j, "in/field.rec.wav", tmp_path / "j")
        assert a.name == b.name and a.read_bytes() == b.read_bytes()


# -- the slice as a whole ------------------------------------------------------

def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _tiny_pair(family):
    """(JaxClassifier, TorchClassifier) of one tiny float32 model, the JAX
    ``init`` weights carried over: the v2.4 and Perch models of
    ``tests/test_offline_analysis.py``."""
    if family == "v24":
        n, rate, blocks, emb, seed = 19, 48000, ((1, 8, 3, 2, 1),
                                                  (4, 16, 3, 2, 1)), 32, 0
        jm = JBirdNETv24(num_species=n, mel=JMel(sample_rate=rate, n_fft=512,
                                                 hop=4096, n_mels=32),
                         compute_dtype=jnp.float32)
        spec = treg.BIRDNET_V24
    else:
        n, rate, blocks, emb, seed = 4, 32000, ((1, 8, 3, 2, 1),), 16, 3
        jm = JPerchV2(num_species=n, mel=JMel(sample_rate=rate, n_fft=512,
                                              hop=4096, n_mels=32),
                      compute_dtype=jnp.float32)
        spec = treg.PERCH_V2
    jm.net = JNet(blocks=tuple(JBlock(*b) for b in blocks),
                  embedding_dim=emb, num_classes=n)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = MelCnnModel(n, TMel(**dataclasses.asdict(jm.mel)),
                     TNet(blocks=tuple(TBlock(*b) for b in blocks),
                          embedding_dim=emb, num_classes=n), torch.float32)
    tm.spec = spec
    load_jax_params(tm.backbone, _np_tree(params))
    return JaxClassifier(jm, params), TorchClassifier(tm, "cpu")


@pytest.fixture(scope="module")
def tiny():
    return {f: _tiny_pair(f) for f in ("v24", "perch")}


def _assert_topk_match(v1, i1, v2, i2, tol=1e-5):
    """Values allclose; indices equal, as sets within runs of tied values
    (a tied run at the end may be cut differently by the two top-k's)."""
    np.testing.assert_allclose(v1, v2, atol=tol)
    for r in range(len(v1)):
        k = len(v1[r])
        start = 0
        for pos in range(1, k + 1):
            if pos < k and abs(v1[r, pos] - v1[r, pos - 1]) <= tol:
                continue
            if pos < k or pos - start == 1:
                assert set(i1[r, start:pos]) == set(i2[r, start:pos]), r
            start = pos


def _raven_rows(text):
    return [ln.split("\t") for ln in text.splitlines()]


# family, WAV rate, seconds, config, range mask (every third species out)
_ANALYZER_CASES = {
    "v24 resampled 32k overlap 1.5": (
        "v24", 32000, 7.3, dict(threshold=0.0, overlap=1.5, batch_size=3),
        False),
    "v24 all results": (
        "v24", 48000, 10.0, dict(threshold=0.05, batch_size=4,
                                 all_results=True), False),
    "v24 range mask": (
        "v24", 48000, 6.5, dict(threshold=0.0, overlap=2.9, batch_size=8),
        True),
    "v24 shorter than a clip": (
        "v24", 44100, 0.2, dict(threshold=0.0, batch_size=2), False),
    "perch resampled 48k": (
        "perch", 48000, 12.0, dict(threshold=0.0, batch_size=2), False),
}


@pytest.mark.parametrize("case", list(_ANALYZER_CASES))
def test_offline_analyzer_matches_jax(case, tiny, tmp_path):
    family, rate, seconds, cfg, masked = _ANALYZER_CASES[case]
    jc, tc = tiny[family]
    n = tc.num_species
    labels = tlabels.synthetic_labels(n)
    jlabelset = jlabels.synthetic_labels(n)
    mask = (np.arange(n) % 3 != 1).astype(np.float32) if masked else None
    jc.set_range_mask(mask)
    tc.set_range_mask(mask)
    wav = tmp_path / "field.wav"
    rng = np.random.default_rng(len(case))
    twav.write_wav(wav, (rng.standard_normal(int(rate * seconds)) * 0.2
                         ).astype(np.float32), rate)
    want = joff.OfflineAnalyzer(jc, jlabelset,
                                joff.OfflineConfig(**cfg)).analyze_file(wav)
    an = toff.OfflineAnalyzer(tc, labels, toff.OfflineConfig(**cfg))
    got = an.analyze_file(wav)

    assert got.duration_seconds == want.duration_seconds
    assert len(got.windows) == len(want.windows) > 0
    for g, w in zip(got.windows, want.windows):
        assert (g.window_index, g.begin_seconds, g.end_seconds,
                g.model_id) == (w.window_index, w.begin_seconds,
                                w.end_seconds, w.model_id)
    _assert_topk_match(np.array([w.confidences for w in got.windows]),
                       np.array([w.indices for w in got.windows]),
                       np.array([w.confidences for w in want.windows]),
                       np.array([w.indices for w in want.windows]))
    if masked:
        assert not np.isin([w.indices[0] for w in got.windows],
                           np.flatnonzero(mask == 0)).any()

    # the Raven rows: equal, confidences to their 4 decimals
    trows = _raven_rows(traven.format_raven_table(got.detections, wav.name))
    jrows = _raven_rows(jraven.format_raven_table(want.detections, wav.name))
    assert len(trows) == len(jrows) > 1
    assert trows[0] == jrows[0]
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:8] == j[:8]
        assert abs(float(t[10]) - float(j[10])) <= 1e-4
        if t[8:10] != j[8:10]:
            # another species only where the JAX top-k ties at its value
            win = want.windows[int(j[0]) - 1]
            ties = [c for c in win.confidences
                    if abs(c - float(j[10])) <= 1e-5]
            assert len(ties) > 1, (t, j)


@pytest.mark.parametrize("rate,seconds,overlap", [
    (48000, 0.0, 0.0), (48000, 1.0, 0.0), (48000, 3.0, 0.0),
    (48000, 10.0, 0.0), (48000, 10.0, 2.9), (32000, 7.0, 1.5)])
def test_device_windows_equal_host_slice(rate, seconds, overlap, tiny):
    """The analyzer's device windows equal the JAX analyzer's host windows:
    the zero-padded tail, and one window for a signal shorter than a clip
    (an empty one included)."""
    jc, tc = tiny["v24"]
    x = _signal((int(rate * seconds),), 21, rate)
    an = toff.OfflineAnalyzer(tc, tlabels.synthetic_labels(19))
    hop = twindows.window_hop_samples(an.clip_samples, overlap, 48000)
    got = an._device_windows(x, rate, hop).numpy()
    y = x
    if rate != 48000:
        y = np.asarray(jresample.polyphase_resample(
            jnp.asarray(x), jresample.ResampleConfig(rate, 48000)))
    want = joff.OfflineAnalyzer._host_slice(y, an.clip_samples, hop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
