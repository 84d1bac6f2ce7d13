/* Maintenance panels appended to the System page: dynamic thresholds,
   database backup, TLS certificates, audio admin (sources / equalizer /
   quiet hours), integration tests, stream tools, clips/jobs, network,
   operational events. Consumes the /api/v2 admin groups (reference:
   system + settings pages).

   Panels fetch CONCURRENTLY into order-preserving slots — serialized
   awaits would make the page load time the sum of ~15 round-trips. */

import { api, el, fmtNum, fmtTime, toast, t, table } from "../app.js";

export async function renderAdminPanels(grid) {
  const card = (title, node) =>
    el("div", { class: "card" }, el("h2", {}, title), node);
  const tasks = [];
  const panel = (fn) => {
    const slot = el("div", { style: "display:contents" });
    grid.append(slot);
    tasks.push(fn(slot, card).catch(() => slot.remove()));
  };

  panel(dynThresholds);
  panel(database);
  panel(tls);
  panel(audioAdmin);
  panel(integrations);
  panel(streamTools);
  panel(clipsJobs);
  panel(network);
  panel(opsEvents);
  await Promise.all(tasks);
}

// ---- dynamic thresholds ----
async function dynThresholds(slot, card) {
  const [{ thresholds }, stats] = await Promise.all([
    api("/dynamic-thresholds"), api("/dynamic-thresholds/stats")]);
  const body = el("div");
  body.append(el("p", { class: "sub" },
    `${stats.species_tracked} species tracked · trigger ${stats.trigger}`
    + ` · floor ${stats.floor} · TTL ${stats.valid_hours} h`));
  if (thresholds.length) {
    body.append(table(
      [t("model"), t("species"), t("level"), t("multiplier"), ""],
      thresholds.slice(0, 12).map((d) => [
        d.model_id, d.scientific_name, String(d.level),
        d.multiplier.toFixed(2),
        el("button", { class: "small danger", onclick: async () => {
          await api(`/dynamic-thresholds/${
            encodeURIComponent(d.scientific_name)}`, { method: "DELETE" });
          toast(t("cleared"));
        } }, "reset")])));
    body.append(el("div", { class: "row", style: "margin-top:8px" },
      el("button", { class: "small danger", onclick: async () => {
        const { cleared = 0 } = await api("/dynamic-thresholds",
                                      { method: "DELETE" });
        toast(`Cleared ${cleared} learned thresholds`);
      } }, t("clear_all"))));
  } else {
    body.append(el("div", { class: "empty" },
      t("no_learned_thresholds")));
  }
  slot.append(card(t("dynamic_thresholds"), body));
}

// ---- database + backups ----
async function database(slot, card) {
  const [ov, jobs] = await Promise.all([
    api("/system/database/overview"),
    api("/system/database/backup/jobs")]);
  const body = el("div", {},
    el("div", { class: "grid cols-2" },
      tile(t("engine"), ov.engine),
      tile(t("detections"), fmtNum(ov.detections)),
      tile(t("species"), fmtNum(ov.species)),
      tile(t("size"), ov.size_bytes != null
        ? `${(ov.size_bytes / 1048576).toFixed(1)} MB` : "–"),
      tile(t("integrity"), (typeof ov.integrity === "object"
        ? ov.integrity.engine_ok !== false : ov.integrity)
        ? "ok" : "FAILING"),
      tile(t("backups_run"), jobs.configured ? fmtNum(jobs.runs) : "off")),
    el("div", { class: "row", style: "margin-top:8px" },
      el("button", { class: "primary", onclick: async () => {
        try {
          const out = await api("/system/database/backup",
                                { method: "POST", body: {} });
          toast(`Backup written: ${out.backup}`);
        } catch (e) { toast(e.message, true); }
      } }, t("backup_now")),
      el("button", { onclick: async () => {
        // restore verification: fetch + decrypt + hash audit + restored
        // DB integrity check against the latest archive on the target
        try {
          const out = await api("/system/database/backup/verify",
                                { method: "POST", body: {} });
          const db = out.database || {};
          toast(`${t("backup_verified")}: ${out.archive} `
            + `(${db.integrity || "?"})`);
        } catch (e) { toast(e.message, true); }
      } }, t("verify_backup"))));
  slot.append(card(t("database"), body));
}

// ---- TLS ----
async function tls(slot, card) {
  const info = await api("/tls/certificate");
  const body = el("div");
  if (info.installed) {
    body.append(el("p", { class: "sub" },
      `${info.subject || "certificate"} · expires ${
        info.not_after || "?"} · ${info.mode || ""}`));
    body.append(el("div", { class: "row" },
      el("a", { class: "btn small", href: "/api/v2/tls/certificate/download",
                download: "server.crt" }, "⬇ " + t("download")),
      el("button", { class: "small danger", onclick: async () => {
        await api("/tls/certificate", { method: "DELETE" });
        toast(t("certificate_removed"));
      } }, t("remove"))));
  } else {
    body.append(el("p", { class: "sub" }, t("no_certificate")),
      el("button", { class: "small primary", onclick: async () => {
        const out = await api("/tls/certificate/generate",
                              { method: "POST", body: { validity: "365d" } });
        toast(`Self-signed certificate generated`
          + `${out.not_after ? " · expires " + out.not_after : ""}`);
      } }, t("generate_self_signed")));
  }
  slot.append(card("TLS", body));
}

// ---- audio admin: sources, equalizer, quiet hours ----
async function audioAdmin(slot, card) {
  const [{ sources }, eq, qh] = await Promise.all([
    api("/system/audio/sources"),
    api("/system/audio/equalizer/config"),
    api("/quiet-hours/status")]);
  const body = el("div");
  const winsOf = (sid) => ((qh.windows || {})[sid] || [])
    .map((w) => `${w.start}–${w.end}`).join(", ");
  const gated = new Set(qh.capture_gated || []);
  body.append(sources.length
    ? table([t("source"), t("type"), t("rate"), t("quiet_now")],
        sources.map((s) => [s.display_name || s.source_id, s.type,
          `${(s.sample_rate || 0) / 1000} kHz`,
          el("span", { title: winsOf(s.source_id) || "—" },
             (qh.sources || {})[s.source_id]
               ? (gated.has(s.source_id) ? "🔇 " : "") + "yes"
               : "no")]))
    : el("div", { class: "empty" }, t("no_audio_sources")));
  // equalizer editor (enabled + filter chain JSON)
  const enabled = el("input", { type: "checkbox" });
  enabled.checked = !!eq.enabled;
  const filtersBox = el("textarea", { rows: 3,
    style: "width:100%;font-family:monospace;font-size:12px" });
  filtersBox.value = JSON.stringify(eq.filters || [], null, 0);
  body.append(el("div", { class: "field-row", style: "margin-top:8px" },
    el("label", {}, "equalizer"), enabled),
    filtersBox,
    el("div", { class: "row" },
      el("button", { class: "small primary", onclick: async () => {
        try {
          await api("/system/audio/equalizer/config", { method: "PUT",
            body: { enabled: enabled.checked,
                    filters: JSON.parse(filtersBox.value || "[]") } });
          toast("Equalizer updated (hot-swapped)");
        } catch (e) { toast(e.message, true); }
      } }, t("apply_eq"))));
  slot.append(card(t("audio"), body));
}

// ---- integrations: status + connectivity tests ----
async function integrations(slot, card) {
  const body = el("div");
  try {
    const mq = await api("/integrations/mqtt/status");
    body.append(el("p", { class: "sub" },
      `MQTT ${mq.enabled ? (mq.connected ? "connected" : "enabled")
                         : "disabled"}`
      + (mq.enabled ? ` · ${mq.host}:${mq.port} → ${mq.topic}` : "")));
  } catch (e) { /* ignore */ }
  const testBtn = (label, path) =>
    el("button", { class: "small", onclick: async () => {
      try {
        const out = await api(path, { method: "POST", body: {} });
        toast(`${label}: ${out.ok === false ? "failed" : "ok"}`
          + (out.detail ? ` — ${out.detail}` : ""), out.ok === false);
      } catch (e) { toast(`${label}: ${e.message}`, true); }
    } }, label);
  body.append(el("div", { class: "row" },
    testBtn(t("test_mqtt"), "/integrations/mqtt/test"),
    testBtn(t("test_birdweather"), "/integrations/birdweather/test"),
    testBtn(t("test_ebird"), "/integrations/ebird/test"),
    testBtn(t("test_weather"), "/integrations/weather/test"),
    testBtn("HA discovery",
            "/integrations/mqtt/homeassistant/discovery")));
  slot.append(card(t("integrations"), body));
}

// ---- stream tools: connectivity test, probe, per-source restart ----
async function streamTools(slot, card) {
  const body = el("div");
  try {
    const { active = [] } = await api("/system/audio/active");
    if (active.length) {
      body.append(table([t("source"), "Buffered (s)", ""],
        active.map((a) => [a.source_id,
          (a.capture_seconds_buffered ?? 0).toFixed(1),
          el("button", { class: "small", onclick: async () => {
            try {
              await api(`/restart-source/${
                encodeURIComponent(a.source_id)}`,
                { method: "POST", body: {} });
              toast(`Restarted ${a.source_id}`);
            } catch (e) { toast(e.message, true); }
          } }, "⟳ restart")])));
    }
  } catch (e) { /* no engine */ }
  const url = el("input", { placeholder: "rtsp://… or http://…", size: 30 });
  const out = el("span", { class: "sub" });
  body.append(el("div", { class: "row", style: "margin-top:8px" }, url,
    el("button", { class: "small", onclick: async () => {
      try {
        const r = await api("/streams/test",
                            { method: "POST", body: { url: url.value } });
        out.textContent = r.ok ? `reachable (${r.connect_ms ?? "?"} ms)`
                               : `unreachable: ${r.error || ""}`;
      } catch (e) { out.textContent = e.message; }
    } }, t("test")),
    el("button", { class: "small", onclick: async () => {
      try {
        const r = await api("/streams/probe",
                            { method: "POST", body: { url: url.value } });
        out.textContent = r.ok
          ? `streams: ${(r.streams || []).map((s) =>
              `${s.codec_type}/${s.codec_name}`).join(", ")}`
          : `probe failed: ${r.error || ""}`;
      } catch (e) { out.textContent = e.message; }
    } }, t("probe"))), out);
  slot.append(card(t("stream_tools"), body));
}

// ---- clips on disk + background jobs ----
async function clipsJobs(slot, card) {
  const [{ files, count }, jobs] = await Promise.all([
    api("/filesystem/clips"), api("/system/jobs")]);
  const body = el("div", {},
    el("p", { class: "sub" },
      `${count ?? files.length} file(s) in the export dir · jobqueue: `
      + `${jobs.completed ?? jobs.jobqueue?.completed ?? 0} done, `
      + `${jobs.failed ?? jobs.jobqueue?.failed ?? 0} failed`));
  if (files.length) {
    body.append(table([t("clip"), t("size"), t("modified")],
      files.slice(-10).reverse().map((f) => [
        el("a", { href: `/api/v2/media/audio/${encodeURIComponent(f.name)}`,
                  download: f.name }, f.name),
        `${(f.size_bytes / 1024).toFixed(0)} KB`, fmtTime(f.modified)])));
  }
  body.append(el("div", { class: "row", style: "margin-top:6px" },
    el("a", { class: "btn small", href: "/api/v2/debug/profile" },
       "⬇ " + t("cpu_profile"))));
  slot.append(card("Clips · " + t("jobs"), body));
}

// ---- network + SSE + restart status ----
async function network(slot, card) {
  const [{ interfaces }, sse, rs] = await Promise.all([
    api("/system/network-interfaces"), api("/sse/status"),
    api("/system/restart-status")]);
  const body = el("div", {},
    table([t("interface"), t("state"), "MAC"],
      interfaces.map((i) => [i.name, i.state || "?", i.mac || ""])),
    el("p", { class: "sub" },
      `SSE clients: ${sse.total} (${Object.entries(sse.channels)
        .filter(([, n]) => n > 0)
        .map(([c, n]) => `${c}:${n}`).join(", ") || "none"})`));
  if (rs.restart_required) {
    body.append(el("p", { class: "pill warn" },
      `Restart required: ${rs.reasons.join(", ")}`));
  }
  slot.append(card(t("network"), body));
}

// ---- operational events + diagnostics ----
async function opsEvents(slot, card) {
  const { events = [] } = await api("/system/events/operational?limit=10");
  const body = el("div");
  body.append(el("div", { class: "row", style: "margin-bottom:8px" },
    el("button", { class: "small primary", onclick: async () => {
      const out = await api("/system/diagnostics/run",
                            { method: "POST", body: {} });
      toast(out.healthy ? t("all_diag_healthy")
                        : t("some_checks_failing"), !out.healthy);
    } }, t("run_diagnostics")),
    el("a", { class: "btn small", href: "/api/v2/system/diagnostics" },
       "⬇ " + t("diagnostics_report"))));
  body.append(events.length
    ? table([t("time"), t("kind"), t("detail")], events.map((e2) => [
        e2.time ? fmtTime(e2.time) : "", e2.kind || e2.type || "",
        e2.message || e2.detail || JSON.stringify(e2).slice(0, 60)]))
    : el("div", { class: "empty" }, t("no_data")));
  slot.append(card(t("operational_events"), body));
}

function tile(label, value) {
  return el("div", { class: "stat" },
    el("div", { class: "label" }, label),
    el("div", { class: "value", style: "font-size:20px" }, value ?? "–"));
}

