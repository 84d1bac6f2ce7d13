"""Phase 18's API leg from this tree and another, in turns.

    python3 -m birdnet_go_tpu_torch.diag.api_ab --other DIR [--burn 0,6]
        [--cap 400]

Run from the repository's root on a machine with a card, where DIR holds
another tree of the repository (unpack one with ``git archive`` into a
directory that ``.gitignore`` lists). For each spinning count K of
``--burn``, it runs ``chip_smoke.py --api-leg`` four times, each in a
process of its own beside K processes that spin a CPU core each: DIR's,
this tree's, this tree's, DIR's. Each tree builds its own kernels first.
Each leg prints the HLS segments' zero tails (the samples a segment ends
with that its session read before the source delivered them), how far
the tones' capture buffers end behind the wall clock at the leg's end
(where the tree records it), v2.4's latency, the largest ingest stalls,
and which of this tree's phase 18 gates (``chip_smoke._api_gates``) the
record fails. Records and logs go to ``build/api_ab/``; nothing is gated.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "api_ab"


def _build(tree: Path) -> float:
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c",
                           "import chip_smoke; chip_smoke.phase_build()"],
                          cwd=tree, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return time.monotonic() - t0


def _leg(tree: Path, out: Path, burn: int, cap: float) -> tuple:
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    record = out / "api.json"
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(burn)]
    t0 = time.monotonic()
    try:
        with open(out / "api.log", "w") as log:
            proc = subprocess.run(
                [sys.executable, str(tree / "chip_smoke.py"), "--api-leg",
                 str(record)], stdout=log, stderr=log, cwd=tree,
                timeout=cap)
    finally:
        for b in burners:
            b.kill()
            b.wait()
    wall = time.monotonic() - t0
    rec = json.loads(record.read_text()) if proc.returncode == 0 else None
    return proc.returncode, wall, rec


def _failed_gate(chip_smoke, rec: dict, wall: float, kind: str) -> str:
    """The first of phase 18's gates that `rec` fails, or ``held``."""
    rec = dict(rec)
    rec.setdefault("capture_behind_s", "not recorded")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            chip_smoke._api_gates(rec, wall, kind)
    except AssertionError as e:
        frame = traceback.extract_tb(e.__traceback__)[-1]
        return f"fails `{frame.line}` ({str(e)[:300]})"
    return "held"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--burn", default="0,6")
    ap.add_argument("--cap", type=float, default=400.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]).splitlines()[0]
    kind = chip_smoke.torch.cuda.get_device_name(0)
    trees = {"other": args.other.resolve(), "this": REPO}
    for name, tree in trees.items():
        print(f"build {name} ({tree}): {_build(tree):.1f} s", flush=True)
    k = 0
    for burn in (int(b) for b in args.burn.split(",")):
        for name in ("other", "this", "this", "other"):
            code, wall, rec = _leg(trees[name], OUT / f"leg{k}_{name}",
                                   burn, args.cap)
            head = (f"leg {k} {name}, {burn} spinning: exit {code} in "
                    f"{wall:.1f} s [{card}]")
            k += 1
            if rec is None:
                print(f"{head}; no record", flush=True)
                continue
            stalls = rec["gate"]["largest_stalls"]
            print(f"{head}\n  HLS zero tails "
                  f"{[h['zero_tail'] for h in rec['hls']]} samples; tones' "
                  f"capture behind the wall clock at the end (s) "
                  f"{rec.get('capture_behind_s', 'not recorded')}; v2.4 "
                  f"latency (ms) {rec['latency_ms']['BirdNET_V2.4']}; "
                  f"windows dropped {rec['windows_dropped']}; largest "
                  f"stalls (ms) {({w: v['ms'] for w, v in stalls.items()})}"
                  f"; warm-ups (ms) {rec['gate']['warmup_ms']}; closings "
                  f"meeting one {rec['gate']['closings_overlapping_warmup']}"
                  f"\n  phase 18's gates: "
                  f"{_failed_gate(chip_smoke, rec, wall, kind)}",
                  flush=True)


if __name__ == "__main__":
    main()
