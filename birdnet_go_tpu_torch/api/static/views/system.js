/* System page: health checks, resources, processes, disks, temperature,
   inference + scheduler status, recent errors, control signals, restart,
   support bundle, devices. */

import { api, el, fmtNum, toast, t, table, onCleanup } from "../app.js";
import { sparkline } from "../charts.js";
import { renderAdminPanels } from "./admin.js";

export async function systemView(outlet) {
  outlet.append(el("h1", {}, t("system")));

  const actions = el("div", { class: "row", style: "margin-bottom:14px" },
    el("a", { class: "btn", href: "/api/v2/support/dump" }, "⬇ " + t("support_dump")),
    el("button", { class: "danger", onclick: restart }, "⟳ " + t("restart_server")));
  outlet.append(actions);

  const grid = el("div", { class: "grid cols-2" });
  outlet.append(grid);

  const card = (title, node) =>
    el("div", { class: "card" }, el("h2", {}, title), node);

  // health checks
  try {
    const h = await api("/health");
    grid.append(card(`${t("health")} — ${h.status}`, table(
      [t("check"), t("state"), t("detail")],
      (h.checks || []).map((c) => [c.name,
        el("span", { class: "pill " + (c.healthy ? "good" : "bad") },
           c.healthy ? "ok" : "failing"), c.detail]))));
  } catch (e) { grid.append(card(t("health"), err(e))); }

  // resources
  try {
    const r = await api("/system/resources");
    const temp = await api("/system/temperature/cpu");
    grid.append(card(t("resources"), el("div", { class: "grid cols-2" },
      tile("Load (1m)", r.cpu?.load_1m),
      tile(t("memory_used"), r.memory?.used_percent != null
           ? r.memory.used_percent + "%" : "–"),
      tile(t("disk_used"), r.disk?.used_percent != null
           ? r.disk.used_percent + "%" : "–"),
      tile("CPU temp", temp.available ? temp.celsius + " °C" : "n/a"))));
  } catch (e) { grid.append(card(t("resources"), err(e))); }

  // resource history sparklines (system metrics history)
  try {
    const { samples = [] } = await api("/system/metrics/history?limit=120");
    if (samples.length > 1) {
      const row = (label, key) => el("div", { class: "row" },
        el("span", { class: "sub", style: "width:90px" }, label),
        sparkline(samples.map((s) => s[key] ?? 0)));
      grid.append(card(t("history"),
        el("div", {},
          row("load", "load_1m"),
          row("memory %", "memory_pct"),
          row("disk %", "disk_pct"))));
    }
  } catch (e) { /* optional */ }

  // inference status (list of per-model batcher stats) + the span
  // ring's recent dispatch-latency trace (reference SystemInference)
  try {
    const inf = await api("/system/inference");
    const models = Array.isArray(inf) ? inf : inf.models || [];
    const body = el("div", {}, table(
      [t("model"), t("backend"), t("batch"), t("windows"), "Latency (ms)"],
      models.map((m) => [
        m.model_id || "?", m.backend || "jax",
        String(m.batch_size ?? "–"), fmtNum(m.windows_processed ?? 0),
        String(m.last_latency_ms != null
               ? Math.round(m.last_latency_ms) : "–")])));
    try {
      const { summary = {}, spans = [] } = await api("/system/inference/spans"
                                           + "?limit=120");
      if (spans.length > 1) {
        body.append(el("div", { class: "row", style: "margin-top:6px" },
          el("span", { class: "sub" },
             `p50 ${summary.p50_ms} · p90 ${summary.p90_ms}`
             + ` · p99 ${summary.p99_ms} ms`),
          sparkline(spans.map((s) => s.duration_ms))));
      }
    } catch (e) { /* spans optional */ }
    grid.append(card(t("inference"), body));
  } catch (e) { grid.append(card(t("inference"), err(e))); }

  // scheduler: {ticks, processor:{...}, jobqueue:{...}, models:{...}}
  try {
    const s = await api("/system/scheduler");
    const body = el("div", {},
      el("div", { class: "grid cols-2" },
        tile(t("ticks"), fmtNum(s.ticks)),
        tile(t("results_processed"), fmtNum(s.processor?.results_processed)),
        tile(t("approved"), fmtNum(s.processor?.approved)),
        tile(t("discarded"), fmtNum(s.processor?.discarded)),
        tile(t("jobs_completed"), fmtNum(s.jobqueue?.completed)),
        tile(t("jobs_dropped"), fmtNum(s.jobqueue?.dropped)),
        tile(t("jobs_shed"), fmtNum(s.jobqueue?.shed)),
        tile(t("stall_high_water"),
             s.stall_ms_max != null ? `${fmtNum(s.stall_ms_max)} ms` : "–")));
    // per-action-category ledger: under overload the queue sheds
    // low-priority work first — this table shows WHICH actions shed
    const cats = Object.entries(s.jobqueue?.by_category || {});
    if (cats.length) {
      body.append(el("h2", {}, t("actions_by_category")),
        table([t("category"), t("completed"), t("failed"),
               t("jobs_dropped"), t("jobs_shed")],
          cats.map(([c, v]) => [c, fmtNum(v.completed), fmtNum(v.failed),
                                fmtNum(v.dropped), fmtNum(v.shed)])));
    }
    // configured per-model capacity ceiling (max_batch × dispatches/tick)
    const caps = Object.entries(s.models || {});
    if (caps.length) {
      body.append(table(
        [t("model"), t("batch"), t("windows") + "/s", t("capacity")],
        caps.map(([id, c]) => [id, String(c.max_batch),
          fmtNum(c.ceiling_windows_per_s),
          fmtNum(c.ceiling_streams)])));
    }
    grid.append(card(t("scheduler"), body));
  } catch (e) { grid.append(card(t("scheduler"), err(e))); }

  // processes + disks
  try {
    const { processes = [] } = await api("/system/processes?limit=8");
    grid.append(card(t("processes"), table(
      ["PID", t("name"), "RSS", "CPU s"],
      processes.map((p) => [String(p.pid), p.name,
        fmtNum(Math.round(p.rss_bytes / 1048576)) + " MB",
        String(p.cpu_seconds)]))));
  } catch (e) { grid.append(card(t("processes"), err(e))); }
  try {
    const { disks = [] } = await api("/system/disks");
    grid.append(card(t("disks"), table(
      [t("mount"), "FS", t("used")],
      disks.map((d) => [d.mountpoint, d.fstype,
                        `${d.used_percent}%`]))));
  } catch (e) { grid.append(card(t("disks"), err(e))); }

  // storage observability (reference DatabaseSqliteDetails /
  // DatabaseTableBreakdown / DetectionRateChart)
  try {
    const db = await api("/system/database");
    const body = el("div", {});
    body.append(el("div", { class: "sub" }, [
      db.engine, db.journal_mode,
      db.size_bytes != null
        ? `${(db.size_bytes / 1048576).toFixed(1)} MB` : null,
      db.wal_bytes ? `WAL ${(db.wal_bytes / 1024).toFixed(0)} KB` : null,
      db.freelist_pages ? `${db.freelist_pages} free pages` : null,
    ].filter(Boolean).join(" · ")));
    const rate = db.detections_per_hour_24h || [];
    if (rate.some((v) => v > 0)) {
      body.append(el("div", { class: "row", style: "margin:6px 0" },
        el("span", { class: "sub" }, t("rate_24h")), sparkline(rate)));
    }
    const top = (db.tables || [])
      .slice().sort((a, b) => b.rows - a.rows).slice(0, 8);
    body.append(table([t("name"), t("count")],
      top.map((tb) => [tb.table, fmtNum(tb.rows)])));
    // clip-reference reconcile: clears dangling clip_name refs (never
    // deletes files) — POST /system/storage/reconcile
    const recOut = el("span", { class: "sub" });
    body.append(el("div", { class: "row" },
      el("button", { class: "small", onclick: async () => {
        recOut.textContent = "…";
        try {
          const r = await api("/system/storage/reconcile",
                              { method: "POST", body: {} });
          recOut.textContent = r.pass.aborted
            ? `${t("aborted")}: ${r.pass.abort_reason}`
            : `${r.pass.cleared} ${t("cleared")} / ${r.pass.scanned}`
              + ` · ${r.report.missing_files.length} ${t("missing")}`;
        } catch (e) { recOut.textContent = e.message; }
      } }, t("reconcile_clips")), recOut));
    grid.append(card(t("database"), body));
  } catch (e) { grid.append(card(t("database"), err(e))); }

  // legacy migration (datastore/migration.py — background dual-write worker)
  try {
    const body = el("div", {});
    const info = el("div", { class: "sub", style: "margin-bottom:6px" });
    const bar = el("div", { class: "meter", style:
      "height:8px;background:var(--border);border-radius:4px;overflow:hidden" });
    const fill = el("div", { style:
      "height:100%;width:0%;background:var(--accent)" });
    bar.append(fill);
    const ctlOut = el("span", { class: "sub" });
    const pathIn = el("input", { type: "text", placeholder: t("mig_db_path"),
                                 style: "flex:1" });
    const post = (action, reqBody) => async () => {
      ctlOut.textContent = "…";
      try {
        await api(`/migration/${action}`,
                  { method: "POST", body: reqBody || {} });
        ctlOut.textContent = "";
        ensurePolling((await refresh()).state);
      } catch (e) { ctlOut.textContent = e.message; }
    };
    const startBtn = el("button", { class: "small",
      onclick: () => post("start", { path: pathIn.value })() },
      t("mig_start"));
    const ctls = el("div", { class: "row", style: "margin-top:6px" },
      el("button", { class: "small", onclick: post("pause") }, t("mig_pause")),
      el("button", { class: "small", onclick: post("resume") }, t("mig_resume")),
      el("button", { class: "small danger", onclick: post("rollback") },
         t("mig_rollback")));
    async function refresh() {
      const m = await api("/migration/status");
      const pct = m.progress_pct ?? 0;
      fill.style.width = `${pct}%`;
      info.textContent = [
        m.state,
        m.total_records ? `${fmtNum(m.migrated_records)} / ${fmtNum(m.total_records)} (${pct}%)` : null,
        m.records_per_second ? `${m.records_per_second}/s` : null,
        m.eta_seconds != null ? `ETA ${Math.round(m.eta_seconds)}s` : null,
        m.error ? `⚠ ${m.error}` : null,
      ].filter(Boolean).join(" · ");
      const active = ["migrating", "validating", "cutover", "paused"]
        .includes(m.state);
      ctls.style.display = active ? "" : "none";
      startRow.style.display = active ? "none" : "";
      return m;
    }
    const startRow = el("div", { class: "row", style: "margin-top:6px" },
                        pathIn, startBtn);
    // ctlOut sits outside both rows so start errors show while idle too
    body.append(info, bar, startRow, ctls, ctlOut);
    let iv = null, pollFails = 0;
    function ensurePolling(state) {
      const running = ["migrating", "validating", "cutover"].includes(state);
      if (running && iv == null) {
        iv = setInterval(() => refresh()
          .then((m) => { pollFails = 0; ensurePolling(m.state); })
          .catch(() => {   // tolerate transient blips; give up after 5
            if (++pollFails >= 5) { clearInterval(iv); iv = null; }
          }), 2000);
      } else if (!running && iv != null) { clearInterval(iv); iv = null; }
    }
    onCleanup(() => { if (iv != null) clearInterval(iv); });
    ensurePolling((await refresh()).state);
    grid.append(card(t("migration"), body));
  } catch (e) { grid.append(card(t("migration"), err(e))); }

  // devices
  try {
    const { devices = [], alsa_available = false } = await api("/devices");
    grid.append(card(`${t("devices")} (ALSA ${alsa_available ? "✓" : "–"})`,
      devices.length ? table(["#", "ID", t("description"), "PCM"],
        devices.map((d) => [String(d.index), d.id, d.description,
                            d.alsa_name])) :
        el("div", { class: "empty" }, t("no_sound_cards"))));
  } catch (e) { grid.append(card(t("devices"), err(e))); }

  // errors
  try {
    const errs = await api("/system/errors");
    const rows = errs.errors || errs;
    grid.append(card(t("errors"), rows.length
      ? table([t("time"), t("level"), t("message")], rows.slice(0, 12).map((r) =>
          [String(r.time || r.timestamp || ""), r.level || "",
           r.message || ""]))
      : el("div", { class: "empty" }, t("no_recent_errors"))));
  } catch (e) { grid.append(card(t("errors"), err(e))); }

  // control signals
  try {
    const { signals = [] } = await api("/system/control/signals");
    const sel = el("select", {}, signals.map((s) =>
      el("option", { value: s }, s)));
    grid.append(card(t("control_bus"), el("div", { class: "row" }, sel,
      el("button", { class: "primary", onclick: async () => {
        await api("/system/control", { method: "POST",
                                       body: { signal: sel.value } });
        toast(`Signal sent: ${sel.value}`);
      } }, t("send_signal")))));
  } catch (e) { grid.append(card(t("control_bus"), err(e))); }

  // update check + telemetry
  try {
    const [upd, tel] = await Promise.all([
      api("/system/update-check"), api("/system/telemetry")]);
    grid.append(card(t("maintenance"), el("div", { class: "grid cols-2" },
      tile(t("version"), upd.current),
      tile(t("latest"), upd.latest || "unknown"),
      tile(t("update"), upd.update_available ? "available" : "up to date"),
      tile(t("telemetry"), tel.enabled ? "on" : "off"))));
  } catch (e) { /* optional */ }

  // browser terminal (WS ↔ PTY)
  const termCard = el("div", { class: "card" }, el("h2", {}, t("terminal")));
  const termOut = el("pre", { style: "background:#03060c;color:#d8e2f0;"
    + "padding:10px;border-radius:8px;height:240px;overflow:auto;"
    + "font-size:12px;margin:0 0 8px" });
  const termIn = el("input", { placeholder: "command… (Enter to run)",
                               style: "width:100%" });
  let sock = null;
  const connectBtn = el("button", { onclick: () => {
    if (sock) { sock.close(); sock = null; connectBtn.textContent = t("connect"); return; }
    const proto = location.protocol === "https:" ? "wss" : "ws";
    sock = new WebSocket(`${proto}://${location.host}/api/v2/system/ws`);
    onCleanup(() => { if (sock) { sock.close(); sock = null; } });
    sock.binaryType = "arraybuffer";
    sock.onmessage = (ev) => {
      const text = new TextDecoder().decode(ev.data)
        .replace(/\x1b\[[0-9;?]*[a-zA-Z]|\x1b\][^\x07]*\x07/g, "");
      termOut.append(text);
      termOut.scrollTop = termOut.scrollHeight;
    };
    sock.onclose = () => { connectBtn.textContent = t("connect"); sock = null; };
    connectBtn.textContent = t("disconnect");
  } }, t("connect"));
  termIn.addEventListener("keydown", (ev) => {
    if (ev.key === "Enter" && sock) {
      sock.send(termIn.value + "\n");
      termIn.value = "";
    }
  });
  termCard.append(el("div", { class: "row", style: "margin-bottom:8px" },
                     connectBtn), termOut, termIn);
  grid.append(termCard);

  // maintenance panels: thresholds, database, TLS, audio, integrations,
  // network, operational events
  await renderAdminPanels(grid);

  async function restart() {
    if (!confirm("Restart the server?")) return;
    try {
      await api("/system/restart", { method: "POST" });
      toast(t("restarting"));
    } catch (e) { toast(e.message, true); }
  }

  function tile(label, value) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value", style: "font-size:20px" }, value ?? "–"));
  }
}

function err(e) { return el("div", { class: "empty" }, e.message); }
