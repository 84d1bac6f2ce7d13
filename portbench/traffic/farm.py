"""Streams from the port's native stream farm through the served loop.

The assembly is the one ``scheduler/soak.py`` ``run_soak`` and the app
wire: ``native/lib.py`` ``StreamFarm`` (the benchmark's waveform bank, set
before it starts) packs ready windows straight into the pinned staging
buffers of a ``TorchModelBatcher`` through ``DeviceLoop.add_fill_provider``;
the batcher runs ``MelCnnModel.apply_int16`` (the mel kernel, the unfused
bf16 backbone, sigmoid, range mask, top-10); its ``on_batch`` hands each
batch to ``Processor.submit_batch``, whose approvals go through the
``JobQueue`` to a ``DatabaseAction`` on a SQLite ``Datastore`` in
``TMPDIR``.

Parameters (the cell's file): ``streams`` at ``timescale`` times real time
(a backlog cell offers more than the loop serves, and the rings overwrite
what it cannot take; a live cell offers realtime streams below the knee),
``ring_seconds`` of stream time a ring, ``stagger_hops``, ``max_batch``,
``pipeline_depth``, the loop's ``tick_seconds``, ``min_tick_seconds`` and
``max_dispatches_per_tick``, ``detect_share`` (the threshold is set so
that this share of the calibration windows' top-1 clears it, the soak's
``--calibrate-rate`` rule, which also cuts the sigmoid's sensitivity
tenfold while the scores saturate), ``calibration_windows``,
``preroll_seconds``, ``range_share`` (species the range mask keeps),
``sample_every`` and ``sample_max`` (the windows compared with the
reference), ``stage_every``, ``stage_batches`` and ``stage_rows`` (the
steps whose stages are compared, ``stages.py``), and ``drain_seconds`` (how
long after the close a window due in the window may still arrive).

The window: ``windows_per_s`` counts every window whose batch fanned out
inside it; ``window_p95_ms`` takes every window whose last sample became
ready inside it, timed from that moment to its batch's ``on_batch``, with
each window lost in the rings or never served as a miss (infinite). A
traced run profiles the window's last stretch and reads its spans and
counters from the stretch before it, which the profiler does not slow.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import check, program, sources, stages, weights
from portbench.harness import SpanEvent, Spans
from portbench.trace import profiled


def run(ctx) -> dict:
    from birdnet_go_tpu_torch.analysis.actions import DatabaseAction
    from birdnet_go_tpu_torch.analysis.jobqueue import JobQueue, RetryConfig
    from birdnet_go_tpu_torch.analysis.processor import FlushLoop, Processor
    from birdnet_go_tpu_torch.config.settings import ModelSettings, Settings
    from birdnet_go_tpu_torch.datastore.sqlite import Datastore
    from birdnet_go_tpu_torch.native.lib import StreamFarm
    from birdnet_go_tpu_torch.scheduler.loop import (
        DeviceLoop,
        TorchModelBatcher,
    )
    from birdnet_go_tpu_torch.taxonomy.labels import synthetic_labels

    cfg, prm, dev, seed = ctx.cfg, ctx.params, ctx.device, ctx.seed
    rate, clip = cfg["sample_rate"], cfg["clip_samples"]
    hop = clip // 2
    rt_dur = clip / rate
    live = prm["timescale"] == 1.0
    spans = Spans(ctx.trace)

    # -- inputs and weights, from the seed ---------------------------------
    bank = sources.waveform_bank(seed, prm["n_waveforms"], rate, dev)
    # two windows of every waveform at seeded phases set the weights'
    # batch-norm statistics: a waveform left out scores out of scale
    phases = np.random.default_rng(seed + 1).integers(0, bank.shape[1],
                                                      2 * len(bank))
    cal_pcm = torch.from_numpy(np.stack([
        np.resize(np.roll(bank[i % len(bank)], -int(ph)), clip)
        for i, ph in enumerate(phases)])).to(torch.float32) / 32768.0
    mask = sources.range_mask(seed, cfg["net"]["num_classes"],
                              prm["range_share"], dev)
    params = weights.make(cfg["net"], cfg["mel"], seed, dev, cal_pcm, mask)
    model = program.build_model(cfg, params)
    clf = program.classifier(model, dev, mask)
    capture = stages.Capture(model, seed, prm.get("stage_every", 4),
                             prm.get("stage_batches", 16),
                             prm.get("stage_rows", 2))
    capture.install()

    # -- the served path ---------------------------------------------------
    batcher = TorchModelBatcher(clf, max_batch=prm["max_batch"],
                                pipeline_depth=prm["pipeline_depth"])
    spec = batcher.spec
    settings = Settings()
    settings.models = [ModelSettings(model_id=spec.model_id,
                                     threshold=1.01)]   # muted until set
    labels = {spec.model_id: synthetic_labels(cfg["net"]["num_classes"])}
    db_dir = tempfile.TemporaryDirectory(prefix="portbench_db_")
    store = Datastore(os.path.join(db_dir.name, "birds.db"))
    jobqueue = JobQueue()
    counters = {"approved": 0, "db": 0}
    counters_lock = threading.Lock()

    def on_approved(d, item):
        counters["approved"] += 1
        act = DatabaseAction(detection=d, store=store)

        def run_db():
            act.execute()
            with counters_lock:
                counters["db"] += 1

        jobqueue.enqueue(run_db, f"save {d.species.scientific}",
                         retry=RetryConfig(enabled=False),
                         category="composite")

    processor = Processor(settings, labels, on_approved=on_approved)
    flusher = FlushLoop(processor)
    submit = spans.wrap("submit", processor.submit_batch)

    farm = StreamFarm(prm["streams"], rate, clip, hop,
                      ring_seconds=prm["ring_seconds"],
                      n_waveforms=prm["n_waveforms"],
                      seed=seed % (2 ** 63), timescale=prm["timescale"],
                      stagger_hops=prm["stagger_hops"])
    for i, w in enumerate(bank):
        if not farm.set_waveform(i, w):
            raise RuntimeError(f"farm refused waveform {i}")
    names = [f"farm:{s}" for s in range(prm["streams"])]

    # the compared windows: every sample_every-th window taken in the
    # window from a seeded offset, up to sample_max (the farm serves
    # streams unevenly under a backlog, so a sample by stream would see
    # few of some)
    sample_at = int(np.random.default_rng(seed).integers(
        prm["sample_every"]))
    state = {"phase": "calibrate", "t_open": math.inf, "t_close": math.inf,
             "epoch": 0.0, "skip": 0, "q": None}
    cal_top1: list[np.ndarray] = []
    taken = {"all": 0, "window": 0}
    rows: dict[tuple[str, float], np.ndarray] = {}
    served = {"all": 0, "window": 0}
    lat_chunks: list[np.ndarray] = []
    results: dict[tuple[str, float], tuple] = {}
    meta_buf = np.empty((max(1024, prm["max_batch"]), 3), np.int64)

    def fill(view):
        n = farm.collect(view, meta_buf)
        if n == 0:
            return 0, (), ()
        m = meta_buf[:n]
        sts = state["epoch"] + m[:, 2] / 1e9 - rt_dur
        sids = [names[s] for s in m[:, 0].tolist()]
        taken["all"] += n
        if state["phase"] == "window":
            first = taken["window"]
            taken["window"] += n
            k = prm["sample_every"]
            j = (sample_at - first) % k
            while j < n and len(rows) < prm["sample_max"]:
                rows[(sids[j], float(sts[j]))] = view[j].copy()
                j += k
        return n, sids, sts

    def on_batch(meta, vals, idx, cv):
        now = time.time()
        n = len(meta)
        served["all"] += n
        if state["phase"] == "calibrate":
            if state["skip"] > 0:         # dispatched at the old sensitivity
                state["skip"] -= 1
                return
            # a stream's first window starts before the farm's epoch and
            # is half zeros; the threshold is set on windows of sound
            st = np.fromiter((w.start_time for w in meta), np.float64, n)
            cal_top1.append(np.asarray(vals[:, 0])[st >= state["epoch"]])
            if sum(len(c) for c in cal_top1) >= prm["calibration_windows"]:
                q = float(np.quantile(np.concatenate(cal_top1),
                                      1.0 - prm["detect_share"]))
                if q > 0.998 and batcher.sensitivity > 1e-4:
                    # the soak's rule: scores saturate the sigmoid, so
                    # no threshold separates them; spread them and sample
                    # again
                    batcher.sensitivity *= 0.1
                    cal_top1.clear()
                    state["skip"] = batcher.pipeline_depth + 1
                else:
                    state["q"] = q
            return
        t_wall = time.perf_counter()
        if state["t_open"] <= t_wall <= state["t_close"]:
            served["window"] += n
        starts = np.fromiter((w.start_time for w in meta), np.float64, n)
        ready = starts + rt_dur
        lat_chunks.append(np.stack([ready, np.full(n, now)]))
        if rows:
            for j, w in enumerate(meta):
                key = (w.source_id, w.start_time)
                if key in rows and key not in results:
                    results[key] = (np.array(vals[j]), np.array(idx[j]))
        submit(spec.model_id, [w.source_id for w in meta],
               [w.start_time for w in meta],
               np.fromiter((w.end_time for w in meta), np.float64, n),
               vals, idx, ultrasonic_cv=cv)

    batcher.on_batch = on_batch
    batcher._launch = spans.wrap("launch", batcher._launch)
    batcher.harvest = spans.wrap("harvest", batcher.harvest)
    loop = DeviceLoop(tick_seconds=prm["tick_seconds"],
                      max_dispatches_per_tick=prm["max_dispatches_per_tick"],
                      min_tick_seconds=prm["min_tick_seconds"])
    loop._stop = SpanEvent(spans)
    loop.run_tick = spans.wrap("tick", loop.run_tick)
    loop.add_batcher(batcher)
    loop.add_fill_provider(spec.model_id, spans.wrap("collect", fill))
    batcher.warmup()
    processor.prewarm()
    jobqueue.start()
    flusher.start()
    gc.collect()
    gc.freeze()

    # -- pre-roll: calibrate the threshold, then run until steady ----------
    try:
        loop.start()
        state["epoch"] = time.time()
        farm.start()
        deadline = time.monotonic() + 120.0
        while state["q"] is None:
            if time.monotonic() > deadline:
                raise RuntimeError("calibration windows did not arrive")
            time.sleep(0.02)
        thr = float(np.clip(state["q"], 0.05, 0.999))
        settings.models[0].threshold = thr
        state["phase"] = "preroll"
        time.sleep(prm["preroll_seconds"])

        # -- the measured window -----------------------------------------------
        # a traced run profiles its last stretch; spans and counters are
        # read from the quiet stretch before it
        trace: dict = {}
        prof_s = min(3.0, ctx.seconds * 0.3) if ctx.trace else 0.0

        def counters_now():
            return (batcher.stats.windows_processed,
                    batcher.stats.batches_dispatched, loop.ticks,
                    farm.stats()["samples_lost"], time.perf_counter())

        fs0, dropped0 = farm.stats(), loop.windows_dropped
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.setup_done()
        q0 = counters_now()
        state["t_open"] = q0[-1]
        t_open_wall = time.time()
        spans.open = True
        capture.armed = True
        state["phase"] = "window"
        time.sleep(max(0.0, ctx.seconds - prof_s))
        q1 = counters_now()
        spans.open = False
        capture.armed = False
        if ctx.trace:
            with profiled(True, dev, trace, spans):
                time.sleep(prof_s)
        time.sleep(max(0.0, state["t_open"] + ctx.seconds
                       - time.perf_counter()))
        state["t_close"] = time.perf_counter()
        t_close_wall = time.time()
        window_s = state["t_close"] - state["t_open"]
        fs1, dropped1 = farm.stats(), loop.windows_dropped
        time.sleep(prm["drain_seconds"])
    finally:
        state["phase"] = "closed"
        farm.stop()
        # end the loop's thread first and wait for it however long its
        # last tick takes: DeviceLoop.stop gives up after 10 s and drains
        # the batcher beside a tick still running
        thread = loop._thread
        loop._stop.set()
        if thread is not None:
            thread.join()
        loop.stop()
    batcher.dispatch()                # what the last tick staged
    batcher.harvest_all()
    if live:
        # serve what is left in the rings: a window due in the window and
        # still there is late, not lost, and its latency counts
        while loop.run_tick():
            pass
        loop.drain()
    flusher.stop()
    processor.flush(now=time.time() + 1e6)
    jobqueue.stop(drain=True, timeout=60.0)
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    rows_db = store.count_detections()
    jq = jobqueue.stats
    critical_dropped = sum(v["dropped"] for c, v in jq.by_category.items()
                           if c in ("clip", "database", "composite"))
    store.close()
    db_dir.cleanup()
    farm.close()

    # -- end-to-end numbers ------------------------------------------------
    lat = (np.concatenate(lat_chunks, axis=1) if lat_chunks
           else np.zeros((2, 0)))
    due = (lat[0] >= t_open_wall) & (lat[0] <= t_close_wall)
    lat_ms = (lat[1][due] - lat[0][due]) * 1e3
    lost_w = (fs1["samples_lost"] - fs0["samples_lost"]) // hop
    unserved = taken["all"] - served["all"]       # taken, never fanned out
    misses = lost_w + unserved if live else unserved
    p95 = (float(np.percentile(np.concatenate(
        [lat_ms, np.full(int(misses), np.inf)]), 95))
        if len(lat_ms) else math.inf)
    windows_done, batches, ticks = (b - a for a, b in zip(q0[:3], q1[:3]))
    # windows fanned out in each whole second of the window: how steady
    # the rate is inside a run
    fan = lat[1][(lat[1] >= t_open_wall) & (lat[1] < t_close_wall)]
    per_s = np.bincount((fan - t_open_wall).astype(np.int64),
                        minlength=int(window_s))[:max(1, int(window_s))]
    offered = prm["streams"] * prm["timescale"] / (hop / rate)
    rec = {
        "windows_per_s": served["window"] / window_s,
        "window_p95_ms": p95,
        "window_s": window_s,
        "offered_windows_per_s": offered,
        "lost_windows": int(lost_w),
        "attempted": int(len(lat_ms) + misses if live else taken["window"]),
        "failed": int(unserved + (dropped1 - dropped0) + critical_dropped
                      + (lost_w if live else 0)),
        "threshold": thr,
        "critical_dropped": int(critical_dropped),
        "approved": counters["approved"], "rows": rows_db,
        "db_jobs": counters["db"],
        "memory_peak_bytes": int(mem_peak),
        # the quiet stretch: the whole window, or a traced run's part
        # before the profiler
        "spans": {k: {"seconds": spans.total[k], "calls": spans.calls[k]}
                  for k in spans.total},
        "ticks": ticks,
        "batch_fill": (windows_done / (batches * prm["max_batch"])
                       if batches else None),
        "windows_done": windows_done,
        "quiet_s": q1[-1] - q0[-1],
        "quiet_lost_windows": int((q1[3] - q0[3]) // hop),
        "served_per_s_quartiles": [float(v) for v in np.quantile(
            per_s, [0.25, 0.5, 0.75])],
        "trace": trace,
        "cfg": cfg,
        "max_batch": prm["max_batch"],
        "offline": False,
    }

    # -- correctness: the sampled windows against the reference ------------
    keys = [k for k in rows if k in results]
    batcher_sensitivity = batcher.sensitivity
    capture.uninstall()
    del batcher, clf, model, loop, processor
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pcm = (np.stack([rows[k] for k in keys]).astype(np.float32) / 32768.0
           if keys else np.zeros((0, clip), np.float32))
    vals = np.stack([results[k][0] for k in keys]) if keys else np.zeros(
        (0, 10), np.float32)
    idx = np.stack([results[k][1] for k in keys]) if keys else np.zeros(
        (0, 10), np.int64)
    ok_rows = bank_slices_ok(pcm, keys, names, bank, hop, clip)
    sens = batcher_sensitivity
    conf = check.reference_confidences(pcm, params, cfg, mask, dev,
                                       sensitivity=sens)
    cmp = check.compare(vals, idx, conf)
    st = stages.errors(capture.records, params, cfg)
    rec["compared"] = len(keys)
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
                                             - len(keys))), 0.0),
        ("stage_rows_short", float(max(0, ctx.limits["min_stage_rows"]
                                       - capture.n_rows)), 0.0),
        ("rows_not_from_input", float(len(keys) - ok_rows), 0.0),
        # every approval is a row, or a critical job the queue dropped
        # and counted (a failure above)
        ("rows_unaccounted", float(abs(rows_db + critical_dropped
                                       - counters["approved"])), 0.0),
    ]
    rec["sensitivity"] = sens
    rec["control_inputs"] = (pcm, params, mask, sens, capture.records)
    return rec


def bank_slices_ok(pcm: np.ndarray, keys, names, bank: np.ndarray,
                   hop: int, clip: int) -> int:
    """How many sampled rows are what their stream's waveform holds: the
    row's fresh hop is a contiguous, looped stretch of waveform
    ``stream % len(bank)`` (the farm's assignment), and its first part is
    the same stream's previous hop or zeros."""
    ok = 0
    for row, (sid, _) in zip(pcm, keys):
        s = int(sid.rsplit(":", 1)[1])
        w = bank[s % len(bank)].astype(np.float32) / 32768.0
        ext = np.resize(w, len(w) + hop)
        fresh = row[clip - hop:]
        hits = np.flatnonzero(ext[:len(w)] == fresh[0])
        if any(np.array_equal(ext[h:h + hop], fresh) for h in hits):
            ok += 1
    return ok
