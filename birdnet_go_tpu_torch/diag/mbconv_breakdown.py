"""Break kernel A's time (``expand_dw_pool``) down by part on the card.

    python3 -m birdnet_go_tpu_torch.diag.mbconv_breakdown

Builds ``csrc/mbconv.cu`` as it is and in variants that each leave one
part of kernel A out (their output is wrong; only their time is of use):
the x copy, the expand MMAs, the depthwise taps (the centre value
instead), the two swishes, the y stores; and one that puts back the exact
swish (``expf`` and ``__frcp_rn`` in place of ``__expf`` and
``__fdividef``). Every build is timed in turns at each fused block shape of
one BirdNET v3.0 step (``diag/mbconv_cases``), bf16, B = 256, by CUDA
events around the replay of a CUDA graph of 10 calls (``diag/timing``),
through the wrapper with the variant's library in place of the built one. A part's cost is the full
kernel's time less the variant's. The variants edit the source as text and
fail loudly when an edit no longer applies.
"""

from __future__ import annotations

import ctypes
import subprocess
from unittest import mock

import torch

from birdnet_go_tpu_torch.diag.mbconv_cases import (
    ARGS_A,
    BATCH,
    fused_block_shapes,
    mbconv_inputs,
    packed_kwargs,
)
from birdnet_go_tpu_torch.diag.timing import graph_ms
from birdnet_go_tpu_torch.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu_torch.ops import _build
from birdnet_go_tpu_torch.ops import pallas_mbconv as M

# variant → [(text in csrc/mbconv.cu, its stand-in)]
VARIANTS = {
    "full": [],
    "no x copy": [
        ("    const int npos = n * width;\n    unsigned char* buf",
         "    if (width > 0) return;\n"
         "    const int npos = n * width;\n    unsigned char* buf")],
    "no expand MMAs": [
        ("          mma_bf16(acc[0], a, bk[0]);\n"
         "          mma_bf16(acc[1], a, bk[32]);",
         "          acc[0][0] += __uint_as_float(a[0] ^ bk[0].x);\n"
         "          acc[1][3] += __uint_as_float(a[3] ^ bk[32].y);")],
    "no depthwise taps": [
        ("          for (int dx = 0; dx < K; ++dx)\n"
         "#pragma unroll\n"
         "            for (int s = 0; s < kStrip; ++s)\n"
         "              acc[t][s] = fmaf(v[s + dx], taps[dy * K + dx], "
         "acc[t][s]);",
         "          if (dy == R)\n"
         "#pragma unroll\n"
         "            for (int s = 0; s < kStrip; ++s) acc[t][s] = v[s + R];")],
    "no swishes": [
        ("  return __fmul_rn(v, __fdividef(1.0f, 1.0f + __expf(-v)));",
         "  return v;")],
    "no y stores": [
        ("          store(y + (static_cast<size_t>(b) * s_len +",
         "          if (v == -1.2345e-37f) store(y + (static_cast<size_t>(b) "
         "* s_len +")],
    "exact swish": [
        ("  return __fmul_rn(v, __fdividef(1.0f, 1.0f + __expf(-v)));",
         "  return __fmul_rn(v, __frcp_rn(1.0f + expf(-v)));")],
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """Every variant compiled at once, one nvcc each."""
    src = (_build.CSRC / "mbconv.cu").read_text()
    mel = _build.CSRC / "melspec.cu"      # for the error-string symbol
    out = _build.BUILD_DIR / "mbconv_breakdown"
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
             str(out / f"v{i}.so"), str(cu), str(mel)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        _build._declare(lib)
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mbconv_breakdown: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    step = dict.fromkeys(libs, 0.0)
    for seed, (shape, n) in enumerate(fused_block_shapes(BirdNETv3)):
        c, cm, k, h, w, _ = shape
        a, b = mbconv_inputs(shape, seed, dev, dt)
        ka, _ = packed_kwargs(a, b)
        args = [a[name] for name in ARGS_A]
        kw = dict(height=h, width=w, kernel=k, out_dtype=dt, dot_dtype=dt,
                  **ka)
        times = {}
        for _ in range(2):                 # two rounds, in turns
            for name, lib in libs.items():
                with mock.patch.object(M._build, "load", lambda lib=lib: lib):
                    ms = graph_ms(lambda: M.expand_dw_pool(*args, **kw))
                times.setdefault(name, []).append(ms)
        full = min(times["full"])
        for name, ts in times.items():
            ms = min(ts)
            step[name] += n * ms
            cost = "" if name == "full" else f", part's cost {full - ms:.4f}"
            print(f"mbconv breakdown A x{n} (C {c}, Cm {cm}, k{k}, {h}x{w}) "
                  f"[{BATCH}] bf16: {name} {ms:.4f} ms{cost} [{card}]")
    for name, ms in step.items():
        cost = ("" if name == "full"
                else f", part's cost {step['full'] - ms:.4f}")
        print(f"mbconv breakdown A over one BirdNET_V3.0 step's fused "
              f"blocks: {name} {ms:.4f} ms{cost} [{card}]")


if __name__ == "__main__":
    main()
