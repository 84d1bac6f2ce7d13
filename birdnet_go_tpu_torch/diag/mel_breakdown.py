"""Break the mel kernel's time down by stage on the card.

    python3 -m birdnet_go_tpu_torch.diag.mel_breakdown

Builds ``csrc/melspec.cu`` as it is and in variants that each leave one
part of the work out (their output is wrong; only their time is of use),
and times every build in turns at BirdNET v2.4's [256, 144000] and v3.0's
[256, 160000] configs, bf16 out, by CUDA events. A part's cost is the full
kernel's time less the variant's. The variants edit the source as text and
fail loudly when an edit no longer applies.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from birdnet_go_tpu_torch.diag.profile_step import _pcm
from birdnet_go_tpu_torch.ops import _build
from birdnet_go_tpu_torch.ops.melspec import MelConfig
from birdnet_go_tpu_torch.ops.pallas_melspec import (
    _MAG_MODES,
    _device_consts,
)

# variant → [(text in csrc/melspec.cu, its stand-in)]
VARIANTS = {
    "full": [],
    "no stage 1": [
        ("if (tid < kStage1Threads) {\n      // the window",
         "if (false) {\n      // the window")],
    "no stage-2 MMAs": [
        ("            mma3(part[m][e], ah, al, bcur[e][0], bcur[e][1]);",
         "            part[m][e][0] += bcur[e][0].x + bcur[e][1].y + "
         "__uint_as_float(ah[0] ^ al[1]);")],
    "no stage-2 B loads": [
        ("          b[e][0] = __ldg(bp + static_cast<size_t>(k0) * bw + "
         "e * j2);\n          b[e][1] = __ldg(bp + static_cast<size_t>"
         "(k0 + 4) * bw + e * j2);",
         "          b[e][0] = make_float2(k0, e);\n"
         "          b[e][1] = make_float2(e, k0);")],
    "no mel MMAs": [
        ("for (int m = 0; m < 2; ++m) mma3(mel[i][m], ah[m], al[m], b0, "
         "b1v);",
         "mel[i][0][0] += b0.x + b1v.y + __uint_as_float(ah[0][0] ^ "
         "al[1][1]);")],
}
CONFIGS = [
    ("v2.4", dict(sample_rate=48000, n_fft=2048, hop=512, n_mels=96,
                  fmax=15000.0, mag_scale="nonlinear"), 144000),
    ("v3.0", dict(sample_rate=32000, n_fft=2048, hop=640, n_mels=128,
                  fmax=15000.0, mag_scale="nonlinear"), 160000),
]
REPS = 10


def build_variants() -> dict[str, ctypes.CDLL]:
    """Every variant compiled at once, one nvcc each."""
    src = (_build.CSRC / "melspec.cu").read_text()
    out = _build.BUILD_DIR / "mel_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: edit no longer "
                                   f"applies: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (out / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"v{i}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        _build._declare_melspec(lib)
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mel_breakdown: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    dev = torch.device("cuda", 0)
    for label, kw, clip in CONFIGS:
        cfg = MelConfig(**kw)
        x = torch.from_numpy(_pcm((256, clip), cfg.sample_rate)).to(dev)
        (win, wpk, bg2, fbg2), j2 = _device_consts(cfg, dev)
        n_frames = cfg.num_frames(clip)
        out = torch.empty((256, n_frames, cfg.n_mels), dtype=torch.bfloat16,
                          device=dev)

        def run(lib):
            err = lib.melspec_fused_launch(
                x.data_ptr(), 256, clip, cfg.hop, n_frames, win.data_ptr(),
                wpk.data_ptr(), bg2.data_ptr(), fbg2.data_ptr(), j2,
                cfg.n_mels, _MAG_MODES[cfg.mag_scale], cfg.log_offset,
                out.data_ptr(), 1, torch.cuda.current_stream().cuda_stream)
            _build.check(lib, err, "melspec variant")

        times = {name: [] for name in libs}
        for lib in libs.values():
            run(lib)
        torch.cuda.synchronize()
        for _ in range(REPS):
            for name, lib in libs.items():
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run(lib)
                e.record()
                e.synchronize()
                times[name].append(s.elapsed_time(e))
        full = float(np.median(times["full"]))
        for name, ts in times.items():
            ms = float(np.median(ts))
            cost = "" if name == "full" else f", part's cost {full - ms:.4f}"
            print(f"mel breakdown {label} [256, {clip}] bf16: {name} "
                  f"{ms:.4f} ms{cost} [{card}]")


if __name__ == "__main__":
    main()
