"""The port's Geomodel, range filter and range mask against the JAX
package's, on the CPU.

Parameters come from the JAX ``init`` at ``PRNGKey(7)`` through
``params_from_jax``; the ``geomodel_seed7_scores`` golden fingerprint is
read, never written. Scores are float32 on both sides: rtol 1e-5 (the two
frameworks sum the 512-wide products in other orders).
"""

import argparse
import dataclasses
import datetime
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import birdnet_go_tpu.inference.loader as jloader
from birdnet_go_tpu.cli import main as jcli
from birdnet_go_tpu.inference.backend import JaxRangeFilter
from birdnet_go_tpu.models.geomodel import Geomodel as JGeomodel
from birdnet_go_tpu.models.geomodel import GeomodelConfig as JConfig
from birdnet_go_tpu.models.geomodel import birdnet_week as j_week
from birdnet_go_tpu_torch.inference.backend import (
    TorchClassifier,
    TorchRangeFilter,
    range_mask,
)
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import registry
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.efficientnet import (
    BlockSpec,
    EfficientNetConfig,
)
from birdnet_go_tpu_torch.models.geomodel import (
    Geomodel,
    GeomodelConfig,
    birdnet_week,
)
from birdnet_go_tpu_torch.ops.melspec import MelConfig

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
N_SPECIES = 512
# the golden's coordinates (tests/test_golden_parity.py): Helsinki in week
# 23, Sydney in week 2, and the equator without seasonality
GOLDEN_COORDS = [[60.17, 24.94, 23.0], [-33.9, 151.2, 2.0], [0.0, 0.0, -1.0]]


def _jax(num_species=N_SPECIES):
    g = JGeomodel(JConfig(num_species=num_species))
    params = g.init(jax.random.PRNGKey(7))
    return g, params


def _port(params, num_species=N_SPECIES):
    tree = jax.tree_util.tree_map(np.asarray, params)
    return load_jax_params(Geomodel(GeomodelConfig(num_species=num_species)),
                           tree).eval()


@pytest.fixture(scope="module")
def pair():
    g, params = _jax()
    return g, params, _port(params)


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-90, 90, n)
    lon = rng.uniform(-180, 180, n)
    week = rng.integers(-1, 49, n).astype(np.float64)
    coords = np.stack([lat, lon, week], 1).astype(np.float32)
    # the edges of both ranges and of the year
    coords[:4] = [[90.0, 180.0, 1.0], [-90.0, -180.0, 48.0],
                  [0.0, 0.0, 0.0], [45.5, -73.6, -1.0]]
    return coords


def test_geomodel_matches_jax(pair):
    g, params, tm = pair
    coords = _coords(64, 0)
    ref = np.asarray(jax.jit(g.apply)(params, jnp.asarray(coords)))
    feats = np.asarray(jax.jit(g.encode)(jnp.asarray(coords)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(coords))
        got_feats = tm.encode(torch.from_numpy(coords))
    assert got.shape == (64, N_SPECIES) and got.dtype == torch.float32
    assert tm.feature_dim == g.feature_dim == 96
    np.testing.assert_allclose(got_feats.numpy(), feats, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    # week < 0 zeroes the seasonal block
    assert not got_feats[3, 64:].any() and got_feats[3, :64].any()


def test_geomodel_matches_golden_scores(pair):
    """The JAX package's seed-7 fingerprint, read only."""
    _, _, tm = pair
    path = GOLDEN / "geomodel_seed7_scores.json"
    assert path.is_file(), f"golden {path} is missing"
    want = json.loads(path.read_text())
    with torch.inference_mode():
        scores = tm(torch.tensor(GOLDEN_COORDS)).numpy()
    flat = scores.astype(np.float64).ravel()
    assert list(scores.shape) == want["shape"]
    np.testing.assert_allclose(np.linalg.norm(flat), want["norm"],
                               rtol=1e-3)
    np.testing.assert_allclose(flat[np.asarray(want["sample_idx"])],
                               np.asarray(want["sample"]), rtol=1e-3,
                               atol=1e-4)


def test_birdnet_week_equals_jax_over_a_leap_year():
    day = datetime.date(2024, 1, 1)
    weeks = set()
    while day.year == 2024:
        assert birdnet_week(day) == j_week(day), day
        weeks.add(birdnet_week(day))
        day += datetime.timedelta(days=1)
    assert weeks == set(range(1, 49))


def test_range_filter_matches_jax(pair):
    g, params, tm = pair
    jrf, trf = JaxRangeFilter(g, params), TorchRangeFilter(tm, "cpu")
    assert trf.device == torch.device("cpu")
    for lat, lon, week in GOLDEN_COORDS:
        np.testing.assert_allclose(trf.predict(lat, lon, int(week)),
                                   jrf.predict(lat, lon, int(week)),
                                   rtol=1e-5, atol=1e-7)
    coords = _coords(40, 1)
    got = trf.predict_batch(coords)
    assert got.shape == (40, N_SPECIES) and got.dtype == np.float32
    np.testing.assert_allclose(got, jrf.predict_batch(coords), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("lat,lon", [(90.5, 0.0), (-91.0, 10.0),
                                     (0.0, 180.01), (10.0, -200.0)])
def test_range_filter_validate_raises(pair, lat, lon):
    g, params, tm = pair
    for rf in (JaxRangeFilter(g, params), TorchRangeFilter(tm, "cpu")):
        with pytest.raises(ValueError):
            rf.predict(lat, lon, 10)


def test_range_mask_equals_the_cli_mask(pair, monkeypatch):
    """The mask of ``cli/main.py::_range_mask_if_located`` (today's week,
    the configured threshold) on the same weights, and the classifier that
    takes it."""
    g, params, tm = pair
    monkeypatch.setattr(jloader, "load_geomodel",
                        lambda num_species: (g, params))
    trf = TorchRangeFilter(tm, "cpu")
    week = birdnet_week(datetime.date.today())
    for lat, lon, thr in ((60.17, 24.94, 0.01), (-33.9, 151.2, 0.5)):
        args = argparse.Namespace(latitude=lat, longitude=lon,
                                  rf_threshold=thr)
        want = jcli._range_mask_if_located(args, N_SPECIES)
        got = range_mask(trf, lat, lon, week, threshold=thr)
        assert got.dtype == np.float32 and got.shape == (N_SPECIES,)
        np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < N_SPECIES
    mask_default = range_mask(trf, lat, lon, week)
    np.testing.assert_array_equal(
        mask_default, (trf.predict(lat, lon, week) >= 0.01).astype(
            np.float32))


def test_range_mask_reaches_the_classifier(pair):
    """Species outside the mask get no confidence from the classifier."""
    _, _, tm = pair
    mask = range_mask(TorchRangeFilter(tm, "cpu"), -33.9, 151.2, 2, 0.5)
    net = EfficientNetConfig(blocks=(BlockSpec(1, 16, 3, 1, 1),),
                             stem_channels=16, embedding_dim=32,
                             num_classes=N_SPECIES)
    m = MelCnnModel(N_SPECIES, MelConfig(), net, torch.float32)
    m.spec = dataclasses.replace(registry.BIRDNET_V24, clip_seconds=1.0,
                                 num_species=N_SPECIES)
    m.init(torch.Generator().manual_seed(0))
    clf = TorchClassifier(m, "cpu")
    clf.set_range_mask(mask)
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((2, 48000)) * 0.1).astype(np.float32)
    vals, idx = clf.predict_topk(pcm, k=20)
    inside = mask[idx] == 1.0
    assert inside[vals > 0].all() and (vals[~inside] == 0).all()
