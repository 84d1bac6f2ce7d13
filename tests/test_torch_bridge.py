"""``convert_jax_checkpoint.py``: orbax checkpoints of the JAX package served
by the port's loader, on the CPU.

JAX ``train --tiny`` writes an orbax checkpoint; the script converts it and
the port's ``load_model`` serves the result, given as ``--checkpoint`` and
installed under ``$BIRDNET_TPU_MODELS``, within 1e-5 of the JAX
``load_model``'s logits. A Geomodel tree saved by the JAX package is
converted with ``--geomodel`` and read by the port's ``load_geomodel``
within rtol 1e-5 of the jitted JAX Geomodel. The port's loader still
refuses the orbax directory and names the script.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import birdnet_go_tpu.inference.loader as jloader
from birdnet_go_tpu.cli import main as jcli
from birdnet_go_tpu.inference.checkpoint import save_params as jsave_params
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.models.geomodel import Geomodel as JGeomodel
from birdnet_go_tpu.models.geomodel import GeomodelConfig as JGeoConfig
from birdnet_go_tpu.ops.melspec import MelConfig as JMel
from birdnet_go_tpu_torch.cli import main as tcli
from birdnet_go_tpu_torch.inference import loader as tloader

from tests.test_torch_cli import _tone_dataset

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "convert_jax_checkpoint.py"
sys.path.insert(0, str(REPO))
import convert_jax_checkpoint as bridge  # noqa: E402


@pytest.fixture(scope="module")
def tiny_orbax(tmp_path_factory):
    """JAX ``train --tiny`` on the two-tone dataset: its orbax dir."""
    root = tmp_path_factory.mktemp("bridge")
    ds = _tone_dataset(root / "ds")
    out = root / "orbax"
    assert jcli.main(["train", str(ds), "--output", str(out), "--tiny",
                      "--epochs", "2", "--batch-size", "4"]) == 0
    return out


def _jax_tiny_logits(orbax_dir: Path, pcm: np.ndarray) -> np.ndarray:
    jm, params = jloader.load_model(
        "BirdNET_V2.4", checkpoint=str(orbax_dir), num_species=2,
        mel=JMel(sample_rate=48000, n_fft=512, hop=4096, n_mels=32),
        compute_dtype=jnp.float32)
    jm.net = JNet(blocks=(JBlock(1, 8, 3, 2, 1), JBlock(4, 16, 3, 2, 1)),
                  embedding_dim=32, num_classes=2)
    return np.asarray(jax.jit(jm.apply)(params, jnp.asarray(pcm))["logits"])


def _pcm(seed: int, n: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(48000 * 3) / 48000.0
    freqs = rng.uniform(300.0, 9000.0, n)
    return (0.4 * np.sin(2 * np.pi * freqs[:, None] * t)
            + 0.01 * rng.standard_normal((n, len(t)))).astype(np.float32)


@pytest.mark.parametrize("where", ["given", "installed"])
def test_train_tiny_checkpoint_served_by_the_port(tiny_orbax, where,
                                                  tmp_path, monkeypatch):
    """The converted ``train --tiny`` checkpoint: ``params.npz`` and the
    labels, served given or installed with logits within 1e-5 of the JAX
    loader's on the orbax original."""
    out = tmp_path / "converted"
    assert bridge.main([str(tiny_orbax), str(out), "--tiny"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["labels.json",
                                                     "params.npz"]
    assert json.loads((out / "labels.json").read_text()) == \
        json.loads((tiny_orbax / "labels.json").read_text()) == \
        ["hightone", "lowtone"]
    monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path / "home"))
    tiny = tcli._tiny_v24(2)
    kw = dict(mel=tiny.mel, net=tiny.backbone.cfg,
              compute_dtype=torch.float32)
    if where == "given":
        model = tloader.load_model("BirdNET_V2.4", checkpoint=str(out), **kw)
    else:
        shutil.copytree(out, tmp_path / "home" / "BirdNET_V2.4")
        model = tloader.load_model("BirdNET_V2.4", **kw)
    assert model.num_species == 2
    pcm = _pcm(1)
    with torch.inference_mode():
        got = model.apply(torch.from_numpy(pcm))["logits"].numpy()
    want = _jax_tiny_logits(tiny_orbax, pcm)
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loader_refusal_names_the_script(tiny_orbax):
    """The port keeps refusing orbax and points at the bridge."""
    with pytest.raises(NotImplementedError,
                       match="convert_jax_checkpoint.py"):
        tloader.load_model("BirdNET_V2.4", checkpoint=str(tiny_orbax))


@pytest.mark.parametrize("hidden", [(512, 512, 512), (64, 32)])
def test_geomodel_tree_served_by_the_port(hidden, tmp_path, monkeypatch):
    """A Geomodel tree saved by the JAX package, converted with
    ``--geomodel`` (in a process of its own, as a user runs it): the
    port's ``load_geomodel`` at the default width, and the converted
    module at any width, score a grid within rtol 1e-5 of jitted JAX."""
    jg = JGeomodel(JGeoConfig(num_species=24, hidden=hidden))
    params = jg.init(jax.random.PRNGKey(3))
    jsave_params(params, tmp_path / "orbax")
    out = tmp_path / "geo"
    proc = subprocess.run([sys.executable, str(SCRIPT), "--geomodel",
                           str(tmp_path / "orbax"), str(out)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (out / "params.npz").is_file()
    rng = np.random.default_rng(4)
    coords = np.stack([rng.uniform(-90, 90, 64), rng.uniform(-180, 180, 64),
                       rng.integers(-1, 49, 64).astype(np.float64)],
                      axis=-1).astype(np.float32)
    want = np.asarray(jax.jit(jg.apply)(params, jnp.asarray(coords)))
    if hidden == (512, 512, 512):
        monkeypatch.setenv("BIRDNET_TPU_MODELS", str(tmp_path / "home"))
        shutil.copytree(out, tmp_path / "home" / "Geomodel")
        g = tloader.load_geomodel()
        assert tloader.geomodel_weights_installed()
    else:
        g = bridge._geomodel(bridge._numpy_tree(params))
        g.load_state_dict(tloader.read_params(out), strict=True)
    assert g.cfg.num_species == 24 and g.cfg.hidden == hidden
    with torch.inference_mode():
        got = g.eval()(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
