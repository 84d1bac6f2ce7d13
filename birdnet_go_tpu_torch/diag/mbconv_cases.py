"""The fused MBConv kernels' cases: the distinct fused block shapes of a
full-width step of BirdNET v2.4, v3.0 and Perch v2, read off the models,
and random inputs of kernels A and B at one of them, batch ``BATCH``.
Used by ``chip_smoke.py`` and ``diag.mbconv_breakdown``."""

from __future__ import annotations

import torch

from birdnet_go_tpu_torch.models import efficientnet
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.models.layers import BatchNorm
from birdnet_go_tpu_torch.models.perch_v2 import PerchV2
from birdnet_go_tpu_torch.ops.pallas_mbconv import fold_bn, pack_fragments

BATCH = 256                  # realtime.max_batch default
FAMILIES = (BirdNETv24, BirdNETv3, PerchV2)
ARGS_A = ("x", "wexp", "kexp", "bexp", "dwk", "kdw", "bdw")
ARGS_B = ("y", "se", "wproj", "kpr", "bpr", "res")


def bn_consts(c: int, gen: torch.Generator, dev: torch.device):
    """Folded BN (k, b) [1, c] from random statistics."""
    bn = BatchNorm(c)
    with torch.no_grad():
        for p, lo, hi in ((bn.scale, 0.5, 1.5), (bn.var, 0.5, 2.0)):
            p.copy_(lo + (hi - lo) * torch.rand(c, generator=gen))
        for p in (bn.bias, bn.mean):
            p.copy_(0.1 * torch.randn(c, generator=gen))
    return tuple(t.to(dev) for t in fold_bn(bn))


def mbconv_inputs(shape: tuple, seed: int, dev: torch.device,
                  dt: torch.dtype) -> tuple[dict, dict]:
    """Random inputs of kernels A and B at one block shape (C, Cm, k, H,
    W, C'), by argument name (``ARGS_A``, ``ARGS_B``)."""
    c, cm, k, h, w, c2 = shape
    gen = torch.Generator().manual_seed(seed)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=dgen, device=dev) * scale

    kexp, bexp = bn_consts(cm, gen, dev)
    kdw, bdw = bn_consts(cm, gen, dev)
    kpr, bpr = bn_consts(c2, gen, dev)
    a = dict(x=randn(BATCH, h * w, c).to(dt),
             wexp=randn(c, cm, scale=c ** -0.5) if cm != c else None,
             kexp=kexp, bexp=bexp, dwk=randn(k * k, cm, scale=1.0 / k),
             kdw=kdw, bdw=bdw)
    b = dict(y=randn(BATCH, h * w, cm).to(dt),
             se=torch.sigmoid(randn(BATCH, cm)),
             wproj=randn(cm, c2, scale=cm ** -0.5), kpr=kpr, bpr=bpr,
             res=randn(BATCH, h * w, c2).to(dt) if c2 == c else None)
    return a, b


def packed_kwargs(a: dict, b: dict) -> tuple[dict, dict]:
    """The two wrappers' weights packed once, as the glue passes them."""
    return ({} if a["wexp"] is None
            else {"wexp_frags": pack_fragments(a["wexp"])},
            {"wproj_frags": pack_fragments(b["wproj"])})


def fused_block_shapes(cls) -> list[tuple[tuple, int]]:
    """(C, Cm, k, H, W, C') of each distinct fused block of a full-width
    step of `cls`, in order, and how many blocks have it (Cm == C: no
    expand; C' == C: identity residual). Read off one step on meta tensors,
    with the unfused block standing in for the fused one."""
    model = cls().to("meta")
    shapes: dict[tuple, int] = {}

    def record(blk, h, *, kernel, compute_dtype):
        key = (h.shape[1], blk.dw.w.shape[0], kernel, h.shape[2],
               h.shape[3], blk.project_conv.w.shape[0])
        shapes[key] = shapes.get(key, 0) + 1
        return blk(h, compute_dtype)

    frames = model.mel.num_frames(model.spec.clip_samples)
    orig = efficientnet.mbconv_fused
    efficientnet.mbconv_fused = record
    try:
        model.backbone(torch.zeros((1, frames, model.mel.n_mels, 1),
                                   dtype=model.compute_dtype, device="meta"),
                       fused_blocks=True)
    finally:
        efficientnet.mbconv_fused = orig
    return list(shapes.items())
