"""Recordings analysed one after another through the port's
``OfflineAnalyzer.analyze_samples`` (closed loop), at the CLI's defaults.

Parameters (the cell's file): ``recordings`` field recordings of
``recording_seconds`` each, made at set-up from the seed, the first half at
``rates[0]`` (resampled on the device) and the rest at ``rates[1]``;
``batch_size``, ``overlap``, ``threshold`` (``OfflineConfig``);
``sample_windows`` windows compared with the reference; ``stage_every``,
``stage_batches`` and ``stage_rows`` (the steps whose stages are compared,
``stages.py``).

The window: recordings are analysed whole, in turn, from its opening; it
closes when the first analysis that ends after ``--seconds`` ends, so that
``offline_audio_s_per_s`` is all the audio analysed over all the time. A
traced run profiles the analyses of the window's last stretch, at least
``min(3, 0.3 · --seconds)`` seconds of them after the profiler's slow
start, and reads its counters from the analyses before them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, program, sources, stages, weights
from portbench.harness import Spans
from portbench.reference import model as ref
from portbench.trace import profiled


def run(ctx) -> dict:
    from birdnet_go_tpu_torch.analysis.offline import (
        OfflineAnalyzer,
        OfflineConfig,
    )
    from birdnet_go_tpu_torch.taxonomy.labels import synthetic_labels

    cfg, prm, dev, seed = ctx.cfg, ctx.params, ctx.device, ctx.seed
    rate, clip = cfg["sample_rate"], cfg["clip_samples"]
    spans = Spans(ctx.trace)
    n_rec = prm["recordings"]
    rates = [prm["rates"][0] if i < n_rec // 2 else prm["rates"][1]
             for i in range(n_rec)]
    recs = [sources.field_recording(prm["recording_seconds"], r,
                                    seed + 7919 * i, dev)
            for i, r in enumerate(rates)]
    cal = []                                   # 8 windows a recording
    for k in range(n_rec):
        y = ref.resample(torch.from_numpy(recs[k][:rates[k] * 30]).to(dev),
                         rates[k], rate).cpu().numpy()
        cal.append(np.resize(y, (8, clip)))
    cal = np.concatenate(cal)
    params = weights.make(cfg["net"], cfg["mel"], seed, dev,
                          torch.from_numpy(cal))
    model = program.build_model(cfg, params)
    clf = program.classifier(model, dev, None)
    capture = stages.Capture(model, seed, prm.get("stage_every", 16),
                             prm.get("stage_batches", 16),
                             prm.get("stage_rows", 2))
    capture.install()
    analyzer = OfflineAnalyzer(
        clf, synthetic_labels(cfg["net"]["num_classes"]),
        OfflineConfig(threshold=prm["threshold"],
                      batch_size=prm["batch_size"],
                      overlap=prm["overlap"]))
    analyze = spans.wrap("analyze", analyzer.analyze_samples)
    for r in sorted(set(rates)):                  # warm each rate's shapes
        i = rates.index(r)
        analyzer.analyze_samples(recs[i], rates[i])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()          # the recordings and weights: never garbage

    rng = np.random.default_rng(seed)
    trace: dict = {}
    reports = []                       # (recording, report) in the window
    took: list[float] = []             # seconds of each analysis
    prof_s = min(3.0, ctx.seconds * 0.3) if ctx.trace else 0.0
    ctx.setup_done()
    spans.open = True
    capture.armed = True
    t_open = time.perf_counter()
    deadline = t_open + ctx.seconds
    quiet = None                       # (seconds, windows) before profiling
    prof_cm = None
    audio_s, i = 0.0, 0
    while True:
        now = time.perf_counter()
        if quiet is None and now >= deadline - prof_s:
            quiet = (now - t_open,
                     sum(len(rep.windows) for _, rep in reports))
            spans.open = False
            capture.armed = False
            if ctx.trace:
                prof_cm = profiled(True, dev, trace, spans)
                prof_cm.__enter__()          # the profiler's start is slow
                deadline = max(deadline, time.perf_counter() + prof_s)
        k = i % n_rec
        t_a = time.perf_counter()
        rep = analyze(recs[k], rates[k])
        took.append(time.perf_counter() - t_a)
        audio_s += rep.duration_seconds
        reports.append((k, rep))
        i += 1
        if time.perf_counter() >= deadline:
            break
    if prof_cm is not None:
        prof_cm.__exit__(None, None, None)
    t_close = time.perf_counter()
    spans.open = False
    capture.armed = False
    window_s = t_close - t_open
    if quiet is None:
        quiet = (window_s, sum(len(rep.windows) for _, rep in reports))
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    n_win = sum(len(rep.windows) for _, rep in reports)
    rec = {
        "offline_audio_s_per_s": audio_s / window_s,
        "window_s": window_s,
        "attempted": len(reports), "failed": 0,
        "memory_peak_bytes": int(mem_peak),
        # the quiet stretch: the whole window, or a traced run's part
        # before the profiler
        "spans": {k: {"seconds": spans.total[k], "calls": spans.calls[k]}
                  for k in spans.total},
        "quiet_s": quiet[0],
        "windows_done": quiet[1],
        "windows_in_window": n_win,
        "analysis_s_quartiles": [float(v) for v in np.quantile(
            took, [0.25, 0.5, 0.75])],
        "trace": trace,
        "cfg": cfg,
        "offline": True,
    }

    # -- correctness: sampled windows against the reference ----------------
    capture.uninstall()
    del analyzer, clf, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    flat = [(j, w) for j, (_, rep) in enumerate(reports)
            for w in range(len(rep.windows))]
    pick = rng.choice(len(flat), min(prm["sample_windows"], len(flat)),
                      replace=False)
    by_rec: dict[int, list] = {}
    for p in sorted(pick.tolist()):
        j, w = flat[p]
        by_rec.setdefault(reports[j][0], []).append((j, w))
    pcm, vals, idx = [], [], []
    expected = 0
    for k, items in sorted(by_rec.items()):
        x = torch.from_numpy(recs[k]).to(dev)
        y = ref.resample(x, rates[k], rate)
        n_clip = max(1, -(-len(y) // clip))
        expected += sum(1 for j, _ in items
                        if len(reports[j][1].windows) == n_clip)
        y = torch.nn.functional.pad(y, (0, n_clip * clip - len(y)))
        for j, w in items:
            pcm.append(y[w * clip:(w + 1) * clip].cpu().numpy())
            wr = reports[j][1].windows[w]
            vals.append(np.asarray(wr.confidences, np.float32))
            idx.append(np.asarray(wr.indices, np.int64))
        del x, y
    pcm_a = np.stack(pcm) if pcm else np.zeros((0, clip), np.float32)
    conf = check.reference_confidences(pcm_a, params, cfg, None, dev)
    cmp = check.compare(np.stack(vals) if vals else np.zeros((0, 10)),
                        np.stack(idx) if idx else np.zeros((0, 10), int),
                        conf)
    st = stages.errors(capture.records, params, cfg)
    rec["compared"] = len(pcm)
    rec["stage_rows"] = capture.n_rows
    rec["by_stage"] = st["by_stage"]
    rec["widest"] = {k: v for k, v in cmp.items()
                     if k not in ("conf_p75", "rank_gap_p75")}
    rec["checks"] = [
        ("conf_p75", cmp["conf_p75"], ctx.limits["conf_p75"]),
        ("rank_gap_p75", cmp["rank_gap_p75"], ctx.limits["rank_gap_p75"]),
        ("mel_err", st["mel_err"], ctx.limits["mel_err"]),
        ("net_err", st["net_err"], ctx.limits["net_err"]),
        ("windows_compared_short", float(max(0, ctx.limits["min_compared"]
                                             - len(pcm))), 0.0),
        ("stage_rows_short", float(max(0, ctx.limits["min_stage_rows"]
                                       - capture.n_rows)), 0.0),
        ("window_count_off", float(len(pcm) - expected), 0.0),
    ]
    rec["control_inputs"] = (pcm_a, params, None, 1.0, capture.records)
    return rec
