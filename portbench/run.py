"""The port's benchmark: one cell, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

``BENCHMARK.json`` names the cell; ``portbench/workloads/<cell>.json``
holds its configuration, traffic kind, parameters and limits;
``portbench/configs/<config>.json`` the model's sizes;
``portbench/traffic/<kind>.py`` the generator that drives the program;
``portbench/metrics/<metric>.py`` the reader of each per-layer metric.
The last line of standard output is the result; the compared numbers and
their limits are the last lines of standard error. A run needs a CUDA
card and never falls back to the CPU.

``--control 1`` (not part of a measured run) also puts the reference in
the program's place, one step below the precision the configuration
states, on the same windows and stage inputs, and prints its numbers under
``control``: the backbone with int8 and with float8 operands (every
compared number), the mel front end in TF32 and in bfloat16 (``mel_err``).
The limits are set against these.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a traffic generator gets: the configuration and the cell's
    parameters, the device, the seed, the window's length, whether to
    trace, the limits of the compared numbers."""

    cfg: dict
    params: dict
    device: object
    seed: int
    seconds: float
    trace: bool
    limits: dict
    t_start: float
    setup_s: float | None = None

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start


def _cuda_or_exit(chips: int):
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "false); no result", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path | None = None,
             cfg_override: dict | None = None,
             params_override: dict | None = None,
             limits_override: dict | None = None,
             control: bool = False) -> tuple[dict, list, dict]:
    """Run one cell; returns (result line, checks, record). `device`
    None asks for the card (the benchmark's runs); tests pass the CPU and
    small overrides."""
    from portbench import harness

    root = root or harness.ROOT.parent
    bench = harness.manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: unknown workload {workload!r}")
    cell = cells[workload]
    base = root / "portbench"
    wl = harness.load_json(harness.workload_file(workload, base))
    cfg = harness.load_json(harness.config_file(cell["config"], base))
    if cfg_override:
        cfg = {**cfg, **cfg_override}
    prm = {**wl["params"], **(params_override or {})}
    if device is None:
        device = _cuda_or_exit(cell["chips"])
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cfg=cfg, params=prm, device=device, seed=seed,
                  seconds=seconds, trace=trace,
                  limits={**wl["limits"], **(limits_override or {})},
                  t_start=T_START)
    gen = harness.traffic_module(wl["kind"], base)
    rec = gen.run(ctx)
    rec["setup_s"] = ctx.setup_s
    checks = rec.pop("checks")
    pcm, weights, mask, sens, records = rec.pop("control_inputs")
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) \
        and rec["attempted"] > 0
    if trace:
        names = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    else:
        names = [m for m in bench["end_to_end"]
                 if workload in m.get("workloads", [workload])]
    metrics = {}
    for m in names:
        if trace:
            v = harness.read_metric(m["name"], rec, base)
        else:
            v = rec.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace and rec["trace"]:
        dev_rec["busy_s"] = rec["trace"]["busy_s"]
        dev_rec["window_s"] = rec["trace"]["window_s"]
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": dev_rec}
    if trace and rec["trace"]:
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    if control:
        result["control"] = _control(pcm, weights, mask, sens, records, cfg,
                                     device)
    return result, checks, rec


def _control(pcm, weights, mask, sens, records, cfg, device) -> dict:
    """The reference in the program's place in each control precision:
    its top-10 of the same windows compared as the program's are, and its
    stages fed the program's same stage inputs."""
    from portbench import check, stages

    conf32 = check.reference_confidences(pcm, weights, cfg, mask, device,
                                         sensitivity=sens)
    out = {}
    for prec in ("int8", "fp8"):
        conf = check.reference_confidences(pcm, weights, cfg, mask, device,
                                           precision=prec, sensitivity=sens)
        vals, idx = check.served_topk(conf, 10)
        out[prec] = {**check.compare(vals, idx, conf32),
                     "net_err": stages.errors(records, weights, cfg,
                                              prec)["net_err"]}
    for prec in ("tf32", "bf16"):
        out[prec] = {"mel_err": stages.errors(records, weights, cfg,
                                              prec)["mel_err"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from portbench import harness

    result, checks, rec = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace),
                                   control=bool(args.control))
    card = harness.card_line()
    summary = {k: rec[k] for k in (
        "offered_windows_per_s", "lost_windows", "threshold",
        "sensitivity", "approved", "critical_dropped",
        "rows", "compared", "widest", "stage_rows", "by_stage",
        "windows_done", "batch_fill", "window_s", "quiet_s",
        "quiet_lost_windows", "served_per_s_quartiles",
        "analysis_s_quartiles", "setup_s") if k in rec}
    print(f"portbench {args.workload} seed {args.seed}: card {card}; "
          f"{summary}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
