"""Stage by stage: what the timed path computed inside a few of the
window's steps, each stage against the plain reference fed the same input.

A ``Capture`` wraps the port's mel front end (``models.base``'s
``melspec_fused`` for the served int16 step, ``melspec`` for the offline
float32 one) and, on a step it takes, hooks the backbone's blocks and the
backbone for that step alone: it keeps a few rows of the step's PCM, its
mel rows, every block's input and output, and the logits. Steps are taken
only while ``armed`` (the window), every ``every``-th from a seeded phase,
up to ``batches`` of them, ``rows`` seeded rows each.

``errors`` then compares each stage with the reference's, fed the
program's own input to that stage: the mel front end from the PCM, the stem
from the program's mel, each block from the program's input to it, the head
from the last block's output. A stage's own rounding does not grow through
the depth there, as it does end to end (``check.py``), so a step in a lower
precision than the configuration states reads apart from the program's:

- ``mel_err``: the widest gap of a mel element, over the reference's value
  or a ten-thousandth of its row's largest, whichever is larger;
- ``net_err``: the widest relative gap, ``||program − reference|| /
  ||reference||`` of a row, over the stem, the blocks and the head.

Given a `precision`, the same numbers are read for the reference put in the
program's place in that precision (the controls): the mel front end in
"tf32" or "bf16", the backbone in "int8" or "fp8".
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref

MEL_FLOOR = 1e-4


class Capture:
    def __init__(self, model, seed: int, every: int, batches: int,
                 rows: int):
        self.model = model
        self.every, self.batches, self.rows = every, batches, rows
        rng = np.random.default_rng(seed + 17)
        self.phase = int(rng.integers(every))
        self.row_seed = int(rng.integers(2 ** 31))
        self.armed = False
        self.steps = 0
        self.records: list[dict] = []
        self._hooks: list = []
        self._restore: list = []

    def install(self) -> None:
        from birdnet_go_tpu_torch.models import base

        for name in ("melspec_fused", "melspec"):
            fn = getattr(base, name)
            setattr(base, name, self._wrap(fn))
            self._restore.append((base, name, fn))

    def uninstall(self) -> None:
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore.clear()
        self._drop_hooks()

    def _wrap(self, fn):
        def mel(pcm, cfg, *a, **k):
            out = fn(pcm, cfg, *a, **k)
            if self.armed and len(self.records) < self.batches:
                self.steps += 1
                if (self.steps - 1) % self.every == self.phase:
                    self._take(pcm, out)
            return out
        return mel

    def _take(self, pcm, mel) -> None:
        b = pcm.shape[0]
        g = np.random.default_rng(self.row_seed + len(self.records))
        idx = torch.as_tensor(np.sort(g.choice(b, min(self.rows, b),
                                               replace=False)),
                              device=pcm.device)
        cur = {"pcm": pcm[idx].clone(), "mel": mel[idx].clone(),
               "blocks": [], "logits": None}

        def on_block(_mod, args, out):
            cur["blocks"].append((args[0][idx].clone(), out[idx].clone()))

        def on_backbone(_mod, _args, out):
            cur["logits"] = out["logits"][idx].clone()
            self.records.append(cur)
            self._drop_hooks()

        bb = self.model.backbone
        self._hooks = [blk.register_forward_hook(on_block)
                       for blk in bb.blocks]
        self._hooks.append(bb.register_forward_hook(on_backbone))

    def _drop_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    @property
    def n_rows(self) -> int:
        return sum(len(r["pcm"]) for r in self.records)


def _pcm_float(pcm: torch.Tensor) -> torch.Tensor:
    if pcm.dtype == torch.int16:
        return pcm.to(torch.float32) / 32768.0
    return pcm.to(torch.float32)


def _mel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64), want.to(torch.float64)
    top = want.abs().flatten(1).amax(1).clamp(min=1e-30)
    floor = (MEL_FLOOR * top)[:, None, None]
    return float(((got - want).abs() / torch.maximum(want.abs(), floor))
                 .max())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got = got.to(torch.float64).flatten(1)
    want = want.to(torch.float64).flatten(1)
    return float(((got - want).norm(dim=1)
                  / want.norm(dim=1).clamp(min=1e-30)).max())


def errors(records: list[dict], params: dict, cfg: dict,
           precision: str | None = None) -> dict[str, float]:
    """``mel_err``, ``net_err`` and each stage's widest gap (``by_stage``)
    of the program's records, or with `precision` of the reference put in
    the program's place in it: "tf32" and "bf16" read the mel front end's
    control, "int8" and "fp8" the backbone's."""
    if not records:
        return {"mel_err": float("inf"), "net_err": float("inf"),
                "by_stage": {}}
    layout = ref.block_layout(cfg["net"])
    mel_prec = precision if precision in ("tf32", "bf16") else None
    net_prec = precision if precision in ("int8", "fp8") else None
    stages: dict[str, float] = {}

    def keep(name, v):
        stages[name] = max(stages.get(name, 0.0), v)

    with torch.inference_mode():
        for r in records:
            pcm = _pcm_float(r["pcm"])
            want = ref.mel_features(pcm, cfg["mel"])
            if precision is None:
                got = r["mel"]
            elif mel_prec:
                got = ref.mel_features(pcm, cfg["mel"], mel_prec)
                # in the program's place: its output type
                got = got.to(r["mel"].dtype).to(torch.float32)
            else:
                got = None
            if got is not None:
                keep("mel", _mel_gap(got, want))
            if mel_prec:
                continue
            p = net_prec or "float32"
            # the stem: the program's mel in, its first block's input out
            mel = r["mel"].to(torch.float32)
            want = ref.stem(mel, params)
            got = (ref.stem(mel, params, p) if net_prec
                   else r["blocks"][0][0])
            keep("stem", _rel(got, want))
            for i, (x, y) in enumerate(r["blocks"]):
                want = ref.block(x, params, i, layout[i])
                got = ref.block(x, params, i, layout[i], p) if net_prec else y
                keep(f"block{i}", _rel(got, want))
            last = r["blocks"][-1][1]
            want = ref.head(last, params)
            got = ref.head(last, params, p) if net_prec else r["logits"]
            keep("head", _rel(got, want))
    net = [v for k, v in stages.items() if k != "mel"]
    return {"mel_err": stages.get("mel", float("nan")),
            "net_err": max(net) if net else float("nan"),
            "by_stage": stages}
