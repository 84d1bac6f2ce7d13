"""Profile the served device step on the card with ``torch.profiler``.

    python3 -m birdnet_go_tpu_torch.diag.profile_step [--steps N]

Runs the unfused bf16 step (as the server runs it: int16 PCM → mel kernel →
backbone → sigmoid, top-10) of BirdNET v2.4 at [256, 144000] and BirdNET
v3.0 at [256, 160000], random weights from seed 0, and the served step of
an imported graph (float32 PCM → the graph → sigmoid, top-10): the v2.4
replica of ``diag/replicas.py`` at the batches 1 and 16 the smoke runs it
at. Prints per model the step's wall time, the device time of its
kernels, the device's idle share over the profiled steps, and the kernels
that take the most device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from birdnet_go_tpu_torch.diag import replicas
from birdnet_go_tpu_torch.inference.loader import ImportedModel
from birdnet_go_tpu_torch.inference.tflite_import import load_tflite
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu_torch.ops.postprocess import (
    sigmoid_confidence,
    top_k_results,
)


def _pcm(shape: tuple[int, int], rate: int, seed: int = 0) -> np.ndarray:
    """A -26 dBFS tone over -40 dBFS noise per row, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[1], dtype=np.float32) / rate
    f = rng.uniform(200.0, 12000.0, (shape[0], 1)).astype(np.float32)
    x = 0.05 * np.sin(2 * np.pi * f * t)
    x += rng.standard_normal(shape, dtype=np.float32) * 0.01
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(cls, clip: int, rate: int, steps: int, card: str) -> None:
    dev = torch.device("cuda", 0)
    model = cls().init(torch.Generator().manual_seed(0)).to(dev).eval()
    pcm = torch.from_numpy(_pcm((256, clip), rate)).to(dev)
    _profile(lambda: model.apply_int16(pcm),
             f"{model.spec.model_id} unfused bf16 [256, {clip}]", steps,
             card)


def profile_imported(batch: int, steps: int, card: str) -> None:
    """The v2.4 replica built at `batch`, as ``TorchModelBatcher`` serves
    an imported graph (float32 PCM, TF32 off in the graph's executor)."""
    dev = torch.device("cuda", 0)
    buf = replicas.v24_tflite(np.random.default_rng(424), batch=batch)
    model = ImportedModel(load_tflite(buf), "BirdNET_V2.4").to(dev)
    pcm = torch.from_numpy(_pcm((batch, replicas.CLIP), 48000)).to(dev)
    _profile(lambda: model.apply(pcm.float() / 32768.0),
             f"imported v2.4 replica float32 [{batch}, {replicas.CLIP}]",
             steps, card)


def _profile(apply, label: str, steps: int, card: str) -> None:
    def step():
        logits = apply()["logits"]
        return top_k_results(sigmoid_confidence(logits, 1.0), 10)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"profile {label}, {steps} steps: "
          f"wall {wall_ms / steps:.4f} ms/step, device {busy_ms / steps:.4f} "
          f"ms/step in {n_kernels / steps:.0f} kernels, device idle share "
          f"{max(0.0, 1.0 - busy_ms / wall_ms):.4f} [{card}]")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  {_device_us(e) / 1e3 / steps:9.4f} ms/step  "
              f"x{e.count / steps:5.1f}  {e.key[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    profile(BirdNETv24, 144000, 48000, args.steps, card)
    profile(BirdNETv3, 160000, 32000, args.steps, card)
    for batch in (1, 16):
        profile_imported(batch, args.steps, card)


if __name__ == "__main__":
    main()
