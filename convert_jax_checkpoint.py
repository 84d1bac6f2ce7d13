#!/usr/bin/env python3
"""Convert a JAX package orbax checkpoint into the PyTorch port's format.

    python3 convert_jax_checkpoint.py <orbax_dir> <out_dir> [--tiny]
    python3 convert_jax_checkpoint.py --geomodel <orbax_dir> <out_dir>

The JAX package's ``train`` writes its classifier as an orbax checkpoint
(BirdNET v2.4, the only family it trains) with ``labels.json`` beside it;
its loader also reads a Geomodel tree from orbax. The port reads neither:
orbax's OCDBT layout needs orbax and tensorstore, which a card's machine
may lack. This script runs where both packages and orbax are installed.
It reads the tree with ``birdnet_go_tpu.inference.checkpoint.load_params``,
builds the port's module with the checkpoint's head width (``--tiny``: the
narrow float32 net of ``train --tiny``), carries the weights across with
``birdnet_go_tpu_torch.inference.params.load_jax_params`` and writes
``<out_dir>/params.npz`` with the port's ``save_params``, copying
``labels.json`` across. The port's ``load_model`` (``--checkpoint
<out_dir>``, or installed as ``$BIRDNET_TPU_MODELS/BirdNET_V2.4/``) and
``load_geomodel`` serve the result.

It is the one file of the repository that imports both packages.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np


def _numpy_tree(tree):
    """The restored tree with numpy leaves (orbax gives jax arrays)."""
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _classifier(tree, tiny: bool):
    from birdnet_go_tpu_torch.cli.main import _tiny_v24
    from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24

    width = int(np.shape(tree["classifier"]["w"])[-1])
    return _tiny_v24(width) if tiny else BirdNETv24(num_species=width)


def _geomodel(tree):
    from birdnet_go_tpu_torch.models.geomodel import (
        Geomodel,
        GeomodelConfig,
    )

    shapes = [np.shape(layer["w"]) for layer in tree["mlp"]]
    cfg = GeomodelConfig(num_species=int(shapes[-1][1]),
                         num_frequencies=int(shapes[0][0]) // 6,
                         hidden=tuple(int(s[1]) for s in shapes[:-1]))
    return Geomodel(cfg)


def convert(src: str | Path, dst: str | Path, geomodel: bool = False,
            tiny: bool = False) -> Path:
    """Convert the orbax checkpoint at `src` into ``<dst>/params.npz``
    (and ``<dst>/labels.json`` where `src` has one); returns `dst`."""
    from birdnet_go_tpu.inference.checkpoint import load_params
    from birdnet_go_tpu_torch.inference.checkpoint import save_params
    from birdnet_go_tpu_torch.inference.params import load_jax_params

    src, dst = Path(src), Path(dst)
    tree = _numpy_tree(load_params(src))
    if geomodel:
        module = load_jax_params(_geomodel(tree), tree)
    else:
        module = _classifier(tree, tiny)
        load_jax_params(module.backbone, tree)
    save_params(module, dst)
    if (src / "labels.json").is_file():
        shutil.copyfile(src / "labels.json", dst / "labels.json")
    return dst


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="convert a JAX orbax checkpoint (BirdNET v2.4 from "
                    "train, or a Geomodel) into the PyTorch port's "
                    "params.npz directory")
    p.add_argument("orbax_dir")
    p.add_argument("out_dir")
    kind = p.add_mutually_exclusive_group()
    kind.add_argument("--geomodel", action="store_true",
                      help="the checkpoint is a Geomodel tree")
    kind.add_argument("--tiny", action="store_true",
                      help="the checkpoint is train --tiny's narrow net")
    args = p.parse_args(argv)
    out = convert(args.orbax_dir, args.out_dir, geomodel=args.geomodel,
                  tiny=args.tiny)
    print(f"converted {args.orbax_dir} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
