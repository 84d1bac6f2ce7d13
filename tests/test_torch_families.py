"""The port's BirdNET v3.0 and Perch v2 families and the fused backbone
against the JAX package, on the CPU.

Narrow models (stem 32, three stages, 64 classes) with the mel configs of
v2.4, v3.0 and Perch v2 run a 1 s int16 clip end to end through both
packages, with ``fused_blocks`` on: the port's wrappers take their plain
versions on the CPU, and the JAX package's ``mbconv_fused`` is patched to
run its Pallas kernels in interpret mode (``apply_efficientnet`` looks the
name up when it is called). Weights come from the JAX init through
``params_from_jax``.

Tolerances: float32 at rtol/atol 1e-4; bf16 at |Δlogit| <= 0.02 ·
max(1, max |ref|), since bf16 rounds at other places in the two frameworks.
The float32 models run their fused blocks with float32 matrix operands on
both sides. With the default bf16 operands, a float32 value one ulp apart in
the two frameworks now and then rounds to the other bf16 neighbour, and the
narrow v2.4 logits then differ by 3.3e-4 at a scale of 9.5 (1.6e-5 with
float32 operands); ``tests/test_torch_mbconv.py`` holds that path at the
block level.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import birdnet_go_tpu.ops.pallas_mbconv as JM
from birdnet_go_tpu.models.birdnet_v3 import BirdNETv3 as JBirdNETv3
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24 as JBirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec as JBlock
from birdnet_go_tpu.models.efficientnet import EfficientNetConfig as JNet
from birdnet_go_tpu.models.efficientnet import apply_efficientnet
from birdnet_go_tpu.models.perch_v2 import PerchV2 as JPerchV2
from birdnet_go_tpu_torch import models as tmodels
from birdnet_go_tpu_torch.inference.params import load_jax_params
from birdnet_go_tpu_torch.models import efficientnet as TE
from birdnet_go_tpu_torch.models.base import MelCnnModel
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.ops.melspec import MelConfig

torch.set_num_threads(1)

N_CLASSES = 64
# (family, JAX class, port class, blocks of the narrow net)
B0_NARROW = ((1, 16, 3, 1, 1), (6, 24, 3, 2, 2), (6, 40, 5, 2, 1))
B1_NARROW = ((1, 16, 3, 1, 2), (6, 24, 3, 2, 2), (6, 40, 5, 2, 1))
FAMILIES = {
    "v24": (JBirdNETv24, BirdNETv24, B0_NARROW),
    "v3": (JBirdNETv3, BirdNETv3, B1_NARROW),
    "perch": (JPerchV2, PerchV2, B1_NARROW),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pcm16(n, rate, seed):
    """1 s per row: a tone at field level over noise, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(rate) / rate
    tones = np.sin(2 * np.pi * rng.uniform(300, 9000, (n, 1)) * t)
    x = 0.1 * tones + 0.02 * rng.standard_normal((n, rate))
    return (x * 32767).astype(np.int16)


def _net(cls, blocks):
    """A narrow EfficientNetConfig of either package."""
    spec = JBlock if cls is JNet else TE.BlockSpec
    return cls(blocks=tuple(spec(*b) for b in blocks), stem_channels=32,
               embedding_dim=48, num_classes=N_CLASSES)


@functools.lru_cache(maxsize=None)
def _jax_family(name):
    """(JAX model, its params as numpy) for a narrow family, float32."""
    jcls, _, blocks = FAMILIES[name]
    jm = jcls(num_species=N_CLASSES, compute_dtype=jnp.float32)
    jm.net = _net(JNet, blocks)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3)))
    return jm, params


@functools.lru_cache(maxsize=None)
def _jax_fused(name, dt):
    """The JAX package's fused backbone on the XLA mel of the family's
    clip: float32 logits as numpy."""
    jm, params = _jax_family(name)
    jdt = DTYPES[dt][0]
    pcm = _pcm16(2, jm.mel.sample_rate, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "mbconv_fused", functools.partial(
            JM.mbconv_fused, interpret=True, dot_dtype=jdt))

        @jax.jit
        def run(params, pcm):
            feats = jm.features(pcm.astype(jnp.float32) / 32768.0)
            return apply_efficientnet(params, feats.astype(jdt), jm.net,
                                      compute_dtype=jdt,
                                      fused_blocks=True)["logits"]

        return pcm, np.asarray(run(params, jnp.asarray(pcm)))


def _port(name, dt, fused):
    jm, params = _jax_family(name)
    net = _net(TE.EfficientNetConfig, FAMILIES[name][2])
    tm = MelCnnModel(N_CLASSES, MelConfig(**dataclasses.asdict(jm.mel)), net,
                     DTYPES[dt][1])
    load_jax_params(tm.backbone, params)
    tm.fused_blocks = fused
    return tm.eval()


def _assert_logits(got, ref, dt):
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - ref).max()
        assert err <= 0.02 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_narrow_fused_model_matches_jax(name, dt, monkeypatch):
    pcm, ref = _jax_fused(name, dt)
    tm = _port(name, dt, fused=True)
    calls = []
    orig = TE.mbconv_fused

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw, dot_dtype=DTYPES[dt][1])

    monkeypatch.setattr(TE, "mbconv_fused", counted)
    with torch.inference_mode():
        got = tm.apply_int16(torch.from_numpy(pcm))["logits"]
    assert got.dtype == torch.float32 and got.shape == (2, N_CLASSES)
    # 1 s clips: v2.4 fuses blocks 0 and 2; the B1 nets blocks 0, 1 and 3
    assert len(calls) == (2 if name == "v24" else 3)
    _assert_logits(got.numpy(), ref, dt)


def test_narrow_bf16_step_matches_jax():
    """The unfused bf16 v2.4 step; its SE and classifier Dense layers keep
    JAX's float32 accumulator."""
    jm, params = _jax_family("v24")
    jm16 = JBirdNETv24(num_species=N_CLASSES, compute_dtype=jnp.bfloat16)
    jm16.net, jm16.use_fused_frontend = jm.net, False
    pcm = _pcm16(2, 48000, 2)
    ref = np.asarray(jax.jit(jm16.apply_int16)(params, jnp.asarray(pcm))[
        "logits"])
    with torch.inference_mode():
        got = _port("v24", "bf16", fused=False).apply_int16(
            torch.from_numpy(pcm))["logits"].numpy()
    _assert_logits(got, ref, "bf16")


@pytest.mark.parametrize("jcls,tcls", [(JBirdNETv3, BirdNETv3),
                                       (JPerchV2, PerchV2)])
def test_family_configs_equal_jax(jcls, tcls):
    jm, tm = jcls(), tcls()
    assert dataclasses.asdict(tm.mel) == dataclasses.asdict(jm.mel)
    assert dataclasses.asdict(tm.net) == dataclasses.asdict(jm.net)
    assert tm.num_species == jm.num_species == jm.spec.num_species
    assert dataclasses.asdict(tm.spec) == dataclasses.asdict(jm.spec)
    assert tm.compute_dtype == torch.bfloat16 and not tm.fused_blocks
    assert getattr(tmodels, tcls.__name__) is tcls


@pytest.mark.parametrize("cls,n_fused", [(BirdNETv24, 8), (BirdNETv3, 13),
                                         (PerchV2, 13)])
def test_full_width_fused_block_count(cls, n_fused, monkeypatch):
    """Which blocks the gate admits at full width, on shapes alone (meta
    tensors; the unfused block stands in for the fused one)."""
    model = cls().to("meta")
    blocks = list(model.backbone.blocks)
    calls = []

    def stand_in(blk, h, *, kernel, compute_dtype):
        calls.append(blocks.index(blk))
        return blk(h, compute_dtype)

    monkeypatch.setattr(TE, "mbconv_fused", stand_in)
    frames = model.mel.num_frames(model.spec.clip_samples)
    feats = torch.zeros((1, frames, model.mel.n_mels, 1),
                        dtype=model.compute_dtype, device="meta")
    out = model.backbone(feats, fused_blocks=True)
    assert out["logits"].shape == (1, model.num_species)
    assert len(calls) == n_fused
    if cls is BirdNETv24:
        assert calls == [0, 2, 4, 6, 7, 8, 9, 10]


def test_jax_params_load_without_warnings():
    jm, params = _jax_family("v3")
    assert not all(a.flags.writeable for a in jax.tree_util.tree_leaves(
        params))
    tm = MelCnnModel(N_CLASSES, MelConfig(**dataclasses.asdict(jm.mel)),
                     _net(TE.EfficientNetConfig, B1_NARROW))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        load_jax_params(tm.backbone, params)
