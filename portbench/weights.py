"""Seeded weights for a configuration, made on the device in a few large
calls and handed, the same tensors, to the program and to the reference.

Convolution and dense weights are fan-in scaled normals clipped at two
standard deviations (the port's and Keras' initialiser), drawn from one
``torch.Generator`` on the device in one call. Batch norm's scale and bias
are drawn beside them; its mean and variance are set from a calibration
batch of the cell's own audio run through the plain reference, so that
every layer's output is near unit scale, as in a trained network (random
statistics make the activations vanish through the depth, and every window
then scores alike). The classifier is scaled so that the calibration
batch's logits have standard deviation 1, and shifted so that its median
window's best included species has the logit -1: most windows score low
and a few high, which is what the threshold calibration of the served
cells needs (at a larger scale many windows saturate the sigmoid and no
threshold separates 1.5% of them).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import model as ref


def shapes(net: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """Every weight's name → (shape, fan-in); names as the port's
    ``EfficientNet`` state dict has them."""
    out = {"stem_conv.w": ((net["stem_channels"], 1, 3, 3), 9)}
    for i, b in enumerate(ref.block_layout(net)):
        q = f"blocks.{i}"
        if b["expand"] != 1:
            out[f"{q}.expand_conv.w"] = ((b["cmid"], b["cin"], 1, 1),
                                         b["cin"])
        out[f"{q}.dw.w"] = ((b["cmid"], 1, b["k"], b["k"]), b["k"] ** 2)
        out[f"{q}.se.reduce.w"] = ((b["squeeze"], b["cmid"]), b["cmid"])
        out[f"{q}.se.expand.w"] = ((b["cmid"], b["squeeze"]), b["squeeze"])
        out[f"{q}.project_conv.w"] = ((b["cout"], b["cmid"], 1, 1),
                                      b["cmid"])
    cin = ref.block_layout(net)[-1]["cout"]
    out["head_conv.w"] = ((net["embedding_dim"], cin, 1, 1), cin)
    out["classifier.w"] = ((net["num_classes"], net["embedding_dim"]),
                           net["embedding_dim"])
    return out


def bn_names(net: dict) -> dict[str, int]:
    out = {"stem_bn": net["stem_channels"]}
    for i, b in enumerate(ref.block_layout(net)):
        q = f"blocks.{i}"
        if b["expand"] != 1:
            out[f"{q}.expand_bn"] = b["cmid"]
        out[f"{q}.dw_bn"] = b["cmid"]
        out[f"{q}.project_bn"] = b["cout"]
    out["head_bn"] = net["embedding_dim"]
    return out


def make(net: dict, mel: dict, seed: int, device: torch.device,
         calibration_pcm: torch.Tensor,
         mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """The parameters of `net` from `seed` on `device`, float32, keyed by
    the port's backbone names. `calibration_pcm` [K, clip] float32 sets the
    batch-norm statistics and the classifier's scale and shift; `mask`,
    the range filter's included species, the species the shift looks at."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ws = shapes(net)
    bns = bn_names(net)
    n_w = sum(math.prod(s) for s, _ in ws.values())
    n_bn = sum(bns.values())
    flat = torch.randn(n_w + 2 * n_bn, generator=g, device=device)
    p: dict[str, torch.Tensor] = {}
    pos = 0
    for name, (shape, fan_in) in ws.items():
        n = math.prod(shape)
        w = flat[pos:pos + n].view(shape).clamp(-2.0, 2.0)
        p[name] = w * math.sqrt(2.0 / max(fan_in, 1))
        pos += n
    for name, c in bns.items():
        p[f"{name}.scale"] = 1.0 + 0.1 * flat[pos:pos + c].clamp(-2, 2)
        p[f"{name}.bias"] = 0.1 * flat[pos + c:pos + 2 * c].clamp(-2, 2)
        p[f"{name}.mean"] = torch.zeros(c, device=device)
        p[f"{name}.var"] = torch.ones(c, device=device)
        pos += 2 * c
    for i, b in enumerate(ref.block_layout(net)):
        q = f"blocks.{i}"
        p[f"{q}.se.reduce.b"] = torch.zeros(b["squeeze"], device=device)
        p[f"{q}.se.expand.b"] = torch.zeros(b["cmid"], device=device)
    p["classifier.b"] = torch.zeros(net["num_classes"], device=device)

    def set_stats(name, x):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        p[f"{name}.mean"] = mean
        p[f"{name}.var"] = var

    with torch.no_grad():
        feats = ref.mel_features(calibration_pcm.to(device), mel)
        logits = ref.backbone(feats, p, net, bn_hook=set_stats)
        scale = 1.0 / logits.std().clamp(min=1e-12)
        scaled = logits * scale
        if mask is not None:
            scaled = scaled.masked_fill(mask[None] == 0, float("-inf"))
        shift = -1.0 - scaled.max(dim=1).values.median()
        p["classifier.w"] = p["classifier.w"] * scale
        p["classifier.b"] = p["classifier.b"] + shift
    return {k: v.contiguous() for k, v in p.items()}
