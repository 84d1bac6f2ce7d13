/* Dashboard: KPI row, recent detection cards with spectrograms, live audio
   + client-side live spectrogram (WebAudio AnalyserNode over the chunked
   live-WAV stream — same pattern the reference's SPA uses over HLS),
   daily activity, stream health. */

import { api, el, clear, fmtNum, fmtTime, confMeter, t, subscribe, isoDaysAgo, onCleanup, weatherGlyph } from "../app.js";
import { barChart, sparkline } from "../charts.js";
import { maybeShowWizard } from "./onboarding.js";

export async function dashboardView(outlet) {
  const editBtn = el("button", { class: "small" },
                     "✎ " + t("edit_layout"));
  outlet.append(el("div", { class: "row",
                            style: "justify-content:space-between" },
                   el("h1", { style: "margin-bottom:0" }, t("dashboard")),
                   editBtn));
  maybeShowWizard();   // first-run setup (no-op once configured/dismissed)
  const kpiRow = el("div", { class: "grid cols-4" });
  const hearingCard = el("div", { class: "card" });
  const liveCard = el("div", { class: "card" });
  const activityCard = el("div", { class: "card" });
  const cardsWrap = el("div", {},
    el("h2", {}, t("recent_detections")),
    el("div", { class: "det-cards", id: "det-cards" }));
  const healthCard = el("div", { class: "card" });
  const weatherCard = el("div", { class: "card" });
  const gridCard = el("div", { class: "card" });
  const newSpeciesCard = el("div", { class: "card" });
  const insightsCard = el("div", { class: "card" });
  outlet.append(kpiRow, hearingCard, el("div", { class: "grid cols-2" },
                           liveCard, activityCard), gridCard,
                insightsCard, newSpeciesCard, cardsWrap,
                el("div", { class: "grid cols-2" },
                   healthCard, weatherCard));
  renderWeather(weatherCard);
  renderSpeciesGrid(gridCard);
  renderNewSpecies(newSpeciesCard);
  renderInsights(insightsCard);

  // dashboard edit mode (reference DashboardEditMode.svelte): per-section
  // show/hide toggles, persisted per browser in localStorage
  const sections = [
    ["kpis", t("status"), kpiRow],
    ["hearing", t("currently_hearing"), hearingCard],
    ["live", t("live_audio"), liveCard],
    ["activity", t("activity_by_hour"), activityCard],
    ["grid", t("todays_species"), gridCard],
    ["insights", t("insights"), insightsCard],
    ["newspecies", t("new_species"), newSpeciesCard],
    ["recent", t("recent_detections"), cardsWrap],
    ["health", t("sources"), healthCard],
    ["weather", t("weather"), weatherCard]];
  let hiddenKeys;
  try {
    hiddenKeys = new Set(JSON.parse(
      localStorage.getItem("dash_hidden") || "[]"));
  } catch (e) { hiddenKeys = new Set(); }
  const applyVis = () => {
    for (const [k, , node] of sections)
      node.style.display = hiddenKeys.has(k) ? "none" : "";
  };
  applyVis();
  const togglesRow = el("div", { class: "chip-wrap",
                                 style: "display:none;margin-bottom:10px" });
  for (const [k, label] of sections) {
    const chip = el("button", { class: "small" });
    const paint = () => {
      chip.textContent = (hiddenKeys.has(k) ? "◻ " : "◼ ") + label;
      chip.style.opacity = hiddenKeys.has(k) ? 0.55 : 1;
    };
    paint();
    chip.addEventListener("click", () => {
      if (hiddenKeys.has(k)) hiddenKeys.delete(k);
      else hiddenKeys.add(k);
      localStorage.setItem("dash_hidden", JSON.stringify([...hiddenKeys]));
      paint();
      applyVis();
    });
    togglesRow.append(chip);
  }
  editBtn.closest("div").after(togglesRow);
  editBtn.addEventListener("click", () => {
    togglesRow.style.display =
      togglesRow.style.display === "none" ? "" : "none";
  });

  // "currently hearing": live pending-consensus entries (SSE channel fed
  // by the processor's pending-broadcast — not-yet-approved detections)
  hearingCard.append(el("h2", {}, t("currently_hearing")));
  const hearingBody = el("div", { class: "row" },
    el("span", { class: "empty", style: "padding:4px" }, t("listening")));
  hearingCard.append(hearingBody);
  const renderPending = (items) => {
    clear(hearingBody);
    if (!items.length) {
      hearingBody.append(el("span", { class: "empty", style: "padding:4px" },
                            t("nothing_right_now")));
      return;
    }
    for (const p of items.slice(0, 10)) {
      hearingBody.append(el("span", { class: "pill info",
        title: `${p.source_id} · ${p.models.join("+")}` },
        `${p.common_name || p.scientific_name} ×${p.count} `
        + `${Math.round(p.confidence * 100)}%`));
    }
  };
  try {
    const { pending = [] } = await api("/detections/pending");
    renderPending(pending);
  } catch (e) { /* optional */ }
  subscribe("/detections/pending/stream", (kind, data) => {
    if (kind === "pending") {
      try { renderPending(JSON.parse(data)); } catch (e) { /* ignore */ }
    }
  });

  // KPI row
  try {
    const [kpis, daily] = await Promise.all([
      api("/analytics/dashboard/kpis"),
      api(`/analytics/daily?from=${isoDaysAgo(13)}&to=${isoDaysAgo(0)}`),
    ]);
    const byDay = Array.isArray(daily) ? daily : (daily.daily || []);
    const counts = byDay.map((d) => d.count ?? d.total ?? 0);
    kpiRow.append(
      stat(t("detections_today"), kpis.detections_today,
           `${fmtNum(kpis.detections_total)} total`, counts),
      stat(t("species_today"), kpis.species_today,
           `${fmtNum(kpis.species_total)} all time`),
      stat(t("active_sources"), kpis.sources_active),
      stat(t("models"), (kpis.models_loaded || []).length,
           (kpis.models_loaded || []).join(", ")));
  } catch (e) { kpiRow.append(el("div", { class: "empty" }, e.message)); }

  // live audio + analyser spectrogram
  await renderLive(liveCard);

  // live 1/3-octave sound levels (SSE soundlevels channel — IEC 61260
  // bands from the shared on-device spectrum)
  {
    const slCanvas = el("canvas", { width: 760, height: 90,
      style: "width:100%;margin-top:8px;display:none" });
    liveCard.append(slCanvas);
    subscribe("/soundlevels/stream", (kind, data) => {
      if (kind !== "soundlevel") return;
      try {
        const bySource = JSON.parse(data);
        const first = Object.values(bySource)[0];
        if (!first || !first.levels_db) return;
        slCanvas.style.display = "";
        const g = slCanvas.getContext("2d");
        g.clearRect(0, 0, slCanvas.width, slCanvas.height);
        const n = first.levels_db.length;
        const bw = slCanvas.width / n;
        for (let i = 0; i < n; i++) {
          // map −90..0 dB → bar height
          const v = Math.max(0, (first.levels_db[i] + 90) / 90);
          const h = v * (slCanvas.height - 14);
          g.fillStyle = `hsl(${200 - 140 * v}, 75%, 55%)`;
          g.fillRect(i * bw + 1, slCanvas.height - 12 - h, bw - 2, h);
        }
        g.fillStyle = "#8aa0b8";
        g.font = "9px sans-serif";
        for (let i = 0; i < n; i += 4) {
          const hz = first.bands_hz[i];
          g.fillText(hz >= 1000 ? `${(hz / 1000).toFixed(0)}k` : `${hz}`,
                     i * bw + 1, slCanvas.height - 2);
        }
      } catch (e) { /* ignore */ }
    });
  }

  // daily activity bars
  try {
    const resp = await api("/analytics/hourly");      // bare int[24]
    const byHour = Array.isArray(resp) ? resp : [];
    activityCard.append(el("h2", {}, t("activity_by_hour")),
      barChart(byHour.map((v, h) => ({ label: String(h), value: v })),
               { xLabelEvery: 3, height: 170,
                 // drill into that hour's detections (deep link)
                 onClick: (d) => location.hash =
                   `#/detections?hour_from=${d.label}&hour_to=${d.label}` }));
  } catch (e) { activityCard.append(el("div", { class: "empty" }, e.message)); }

  await renderCards();
  const loadedAt = Date.now() / 1000;
  subscribe("/detections/stream", async () => {
    renderCards();
    // "N new since you opened the page" pill on the section header
    try {
      const { count = 0 } = await api(`/detections/new?since=${loadedAt}`);
      const h2 = cardsWrap.querySelector("h2");
      let pill = h2.querySelector(".pill");
      if (!pill) {
        pill = el("span", { class: "pill info", style: "margin-left:8px" });
        h2.append(pill);
      }
      pill.textContent = `${count} new`;
    } catch (e) { /* ignore */ }
  });

  // species first seen in the last 7 days (reference
  // NewSpeciesHighlightsCard.svelte) — hidden entirely when none
  async function renderNewSpecies(card) {
    try {
      const res = await api("/analytics/species/first-seen");
      const rows = Array.isArray(res) ? res : res.species || [];
      const weekAgo = isoDaysAgo(6);
      const fresh = rows.filter((r) => r.first_date >= weekAgo)
        .slice(0, 10);
      // remove (not hide): edit-mode's applyVis() resets style.display
      // and would resurrect an empty bordered box
      if (!fresh.length) { card.remove(); return; }
      card.append(el("h2", {}, "★ " + t("new_species")));
      card.append(el("div", { class: "chip-wrap" }, fresh.map((r) => {
        const thumb = el("img", { loading: "lazy", alt: "",
          style: "width:22px;height:22px;border-radius:50%;"
            + "object-fit:cover;vertical-align:middle;margin-right:5px",
          src: `/api/v2/species/thumbnail?name=${
            encodeURIComponent(r.scientific_name)}` });
        thumb.addEventListener("error", () => thumb.remove());
        return el("span", { class: "pill good",
                            title: r.scientific_name }, thumb,
          `${r.common_name || r.scientific_name} · ${r.first_date}`);
      })));
    } catch (e) { card.remove(); }
  }

  // insights strip (reference insights.go: /dashboard/kpis streak +
  // /insights/expected-today + /insights/migration): streak/best-day
  // tiles, species expected around this day-of-year from past years,
  // and migration movement (new arrivals / gone quiet)
  async function renderInsights(card) {
    try {
      const [kpis, expected, mig] = await Promise.all([
        api("/dashboard/kpis"), api("/insights/expected-today"),
        api("/insights/migration")]);
      const chip = (r, cls, label) => {
        const thumb = el("img", { loading: "lazy", alt: "",
          style: "width:22px;height:22px;border-radius:50%;"
            + "object-fit:cover;vertical-align:middle;margin-right:5px",
          src: r.thumbnail_url });
        thumb.addEventListener("error", () => thumb.remove());
        return el("span", { class: "pill " + cls,
                            title: r.scientific_name }, thumb,
          `${r.common_name || r.scientific_name}${label}`);
      };
      card.append(el("h2", {}, "💡 " + t("insights")));
      const streak = kpis.detection_streak || {};
      card.append(el("div", { class: "grid cols-4" },
        itile(t("detection_streak"),
              streak.days ? `🔥 ${streak.days}` : "0",
              streak.start_date ? t("since") + " " + streak.start_date
                                : ""),
        itile(t("best_day"), fmtNum((kpis.best_day || {}).count || 0),
              (kpis.best_day || {}).date || ""),
        itile(t("lifetime_species"), fmtNum(kpis.lifetime_species)),
        itile(t("detections_today"), fmtNum(kpis.today_detections))));
      const exp = (expected.species || []).slice(0, 10);
      if (exp.length)
        card.append(
          el("h3", {}, t("expected_today")),
          el("div", { class: "chip-wrap" }, exp.map((r) =>
            chip(r, "", ` · ${r.years_seen}/${expected.years_of_data}y`))));
      const arrivals = (mig.new_arrivals || []).slice(0, 8);
      const quiet = (mig.gone_quiet || []).slice(0, 8);
      if (arrivals.length)
        card.append(
          el("h3", {}, "→ " + t("new_arrivals")),
          el("div", { class: "chip-wrap" }, arrivals.map((r) =>
            chip(r, "good", ` · ${r.first_detected}`))));
      if (quiet.length)
        card.append(
          el("h3", {}, "← " + t("gone_quiet")),
          el("div", { class: "chip-wrap" }, quiet.map((r) =>
            chip(r, "warn", ` · ${r.days_since}d`))));
      if (!exp.length && !arrivals.length && !quiet.length
          && !streak.days) { card.remove(); return; }
    } catch (e) { card.remove(); }
  }

  function itile(label, value, hint) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value" }, value),
      hint ? el("div", { class: "hint" }, hint) : null);
  }

  async function renderCards() {
    const host = document.getElementById("det-cards");
    if (!host) return;
    try {
      const recent = await api("/detections/recent?limit=8");
      const rows = Array.isArray(recent) ? recent : (recent.detections || []);
      clear(host);
      if (!rows.length) host.append(el("div", { class: "empty" }, t("no_data")));
      for (const d of rows) {
        // species photo first (imageprovider); falls back to spectrogram
        const img = el("img", { class: "spec", loading: "lazy", alt: "",
          src: `/api/v2/species/thumbnail?name=${
            encodeURIComponent(d.scientific_name)}` });
        img.addEventListener("error", () => {
          if (d.clip_name && !img.dataset.fell) {
            img.dataset.fell = "1";
            img.src = `/api/v2/spectrogram/${d.id}?size=sm`;
          } else img.remove();
        });
        host.append(el("div", { class: "det-card" },
          img,
          el("div", { class: "body" },
            el("div", { class: "common" },
              el("a", { href: `#/detection/${d.id}`,
                        title: t("open_detail") },
                 d.common_name || d.scientific_name)),
            el("div", { class: "sci" }, d.scientific_name),
            el("div", { class: "meta" },
              confMeter(d.confidence), " · ", fmtTime(d.timestamp)),
            el("div", { class: "row", style: "margin-top:6px" },
              d.clip_name ? el("audio", { controls: "", preload: "none",
                style: "width:100%;height:28px",
                src: `/api/v2/audio/${d.id}` }) : null))));
      }
    } catch (e) { /* keep previous render */ }
  }

  // stream health
  try {
    const health = await api("/streams/health");
    const entries = Object.entries(health.sources || health);
    healthCard.append(el("h2", {}, t("sources")));
    if (!entries.length) {
      healthCard.append(el("div", { class: "empty" }, t("no_audio_sources_configured")));
    } else {
      const tbl = el("table", { class: "data" },
        el("thead", {}, el("tr", {},
          el("th", {}, t("source")), el("th", {}, t("status")),
          el("th", { class: "num" }, t("buffered_s")),
          el("th", { class: "num" }, t("last_audio_s")))));
      const tb = el("tbody");
      for (const [sid, h] of entries) {
        const age = h.last_ingest_age_s;
        const ok = age !== null && age !== undefined && age < 30;
        tb.append(el("tr", {},
          el("td", {}, sid),
          el("td", {}, el("span", { class: "pill " + (ok ? "good" : "bad") },
                          ok ? "live" : "silent")),
          el("td", { class: "num" },
             (h.capture_seconds_buffered ?? 0).toFixed(1)),
          el("td", { class: "num" }, age == null ? "–" : age.toFixed(1))));
      }
      tbl.append(tb);
      healthCard.append(tbl);
    }
  } catch (e) { healthCard.append(el("div", { class: "empty" }, e.message)); }

  function stat(label, value, hint, trend) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value" }, fmtNum(value)),
      hint ? el("div", { class: "hint" }, hint) : null,
      trend && trend.length ? sparkline(trend.slice(-12)) : null);
  }
}


async function renderWeather(card) {
  card.append(el("h2", {}, t("weather")));
  const today = isoDaysAgo(0);
  const body = el("div", { class: "grid cols-2" });
  card.append(body);
  try {
    const [sun, moon] = await Promise.all([
      api(`/weather/sun/${today}`), api(`/weather/moon/${today}`)]);
    const hhmm = (iso) => iso ? String(iso).slice(11, 16) : "–";
    body.append(
      wtile(t("sunrise"), hhmm(sun.sunrise)),
      wtile(t("sunset"), hhmm(sun.sunset)),
      wtile(t("civil_dawn"), hhmm(sun.civil_dawn)),
      wtile(t("moon"), moon.phase
        ? `${moon.phase.replaceAll("_", " ")} `
          + `${Math.round((moon.illumination ?? 0) * 100)}%`
        : "–"));
  } catch (e) {
    body.append(el("div", { class: "empty" }, "Set a location for sun/moon"));
  }
  try {
    const w = await api(`/weather/daily/${today}`);
    if (w.available) {
      const last = (w.hours || []).slice(-1)[0] || {};
      body.append(
        wtile(t("temp_now"), last.temperature != null
              ? `${weatherGlyph(last.icon)} ${last.temperature} °C`.trim()
              : "–"),
        wtile(t("range"), w.temp_min != null
              ? `${w.temp_min}–${w.temp_max} °C` : "–"),
        wtile(t("wind"), last.wind_speed != null
              ? `${last.wind_speed} m/s` : "–"),
        wtile(t("humidity"), last.humidity != null
              ? `${last.humidity}%` : "–"));
    }
  } catch (e) { /* weather polling not configured */ }
  function wtile(label, value) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value", style: "font-size:20px" }, value));
  }
}

async function renderLive(card) {
  card.append(el("h2", {}, t("live_audio")));
  let sources = [];
  try {
    const health = await api("/streams/health");
    sources = Object.keys(health.sources || health);
  } catch (e) { /* none */ }
  if (!sources.length) {
    card.append(el("div", { class: "empty" }, t("no_live_sources")));
    return;
  }
  const sel = el("select", {}, sources.map((s) => el("option", { value: s }, s)));
  const playBtn = el("button", { class: "primary" }, "▶ " + t("listen"));
  const codecSel = el("select", { id: "live-codec", title:
    "WAV = uncompressed · Opus = ~16× less bandwidth (native encoder) · "
    + "HLS = fMP4 segments (Safari)" },
    el("option", { value: "wav" }, "WAV"),
    el("option", { value: "opus" }, "Opus"),
    el("option", { value: "hls" }, "HLS"));
  const canvas = el("canvas", { class: "livespec", width: 800, height: 160 });
  card.append(el("div", { class: "row", style: "margin-bottom:8px" },
                 sel, playBtn, codecSel), canvas);

  let audio = null, ctx = null, raf = 0, hlsTimer = 0, hlsSrc = "";
  playBtn.addEventListener("click", async () => {
    if (audio) { stop(); return; }
    playBtn.textContent = "■ " + t("stop");
    const srcId = encodeURIComponent(sel.value);
    const codec = document.getElementById("live-codec").value;
    let mediaUrl = `/api/v2/audio/live/${srcId}`;
    if (codec === "opus") mediaUrl += "?format=opus";
    if (codec === "hls") {
      // HLS session: start + keepalive heartbeats (reference audio_hls.go)
      try {
        await api(`/audio/hls/${srcId}/start`, { method: "POST", body: {} });
        hlsSrc = srcId;                 // stop() must target THIS session
        hlsTimer = setInterval(() => api(`/audio/hls/${srcId}/heartbeat`,
          { method: "POST", body: {} }).catch(() => {}), 5000);
        mediaUrl = `/api/v2/audio/hls/${srcId}/playlist.m3u8`;
      } catch (e) { /* fall back to chunked WAV */ }
    }
    audio = new Audio(mediaUrl);
    audio.addEventListener("error", () => {
      // HLS unsupported by this browser → chunked-WAV fallback
      if (audio && mediaUrl.includes("playlist.m3u8")) {
        audio.src = `/api/v2/audio/live/${srcId}`;
        audio.play().catch(() => stop());
      }
    });
    audio.crossOrigin = "anonymous";
    ctx = new (window.AudioContext || window.webkitAudioContext)();
    const src = ctx.createMediaElementSource(audio);
    const analyser = ctx.createAnalyser();
    analyser.fftSize = 1024;
    src.connect(analyser);
    analyser.connect(ctx.destination);
    await audio.play().catch(() => stop());
    const bins = new Uint8Array(analyser.frequencyBinCount);
    const g = canvas.getContext("2d");
    const draw = () => {
      analyser.getByteFrequencyData(bins);
      // scroll left one column, paint the new column (waterfall)
      g.drawImage(canvas, -2, 0);
      for (let y = 0; y < canvas.height; y++) {
        const bin = Math.floor((1 - y / canvas.height) * bins.length * 0.8);
        const v = bins[bin] / 255;
        g.fillStyle = `rgba(${Math.round(40 + 200 * v)},`
          + `${Math.round(90 + 120 * v)},${Math.round(190 + 65 * v)},`
          + `${v < 0.04 ? 0.08 : 0.25 + 0.75 * v})`;
        g.fillRect(canvas.width - 2, y, 2, 1);
      }
      raf = requestAnimationFrame(draw);
    };
    draw();
  });
  onCleanup(stop);   // navigation stops audio, RAF loop, HLS heartbeat

  function stop() {
    playBtn.textContent = "▶ " + t("listen");
    cancelAnimationFrame(raf);
    if (hlsTimer) {
      clearInterval(hlsTimer);
      hlsTimer = 0;
      // the dropdown may have changed since play — stop the session that
      // was actually started, not the currently selected source
      api(`/audio/hls/${hlsSrc}/stop`,
          { method: "POST", body: {} }).catch(() => {});
      hlsSrc = "";
    }
    if (audio) { audio.pause(); audio.src = ""; audio = null; }
    if (ctx) { ctx.close(); ctx = null; }
  }
}

/* Daily species summary: the species × hour grid (reference's signature
   dashboard element — GET /api/v2/analytics/species/daily). Each cell's
   dot scales with that hour's detection count; ★ marks species first
   seen within the last week. */
async function renderSpeciesGrid(card) {
  card.append(el("h2", {}, t("todays_species")));
  try {
    const { species = [] } = await api("/analytics/species/daily");
    if (!species.length) {
      card.append(el("div", { class: "empty" }, t("no_data")));
      return;
    }
    const tbl = el("table", { class: "data species-grid" });
    const head = el("tr", {}, el("th", {}, t("species")),
                   el("th", {}, "#"));
    for (let h = 0; h < 24; h++) {
      head.append(el("th", { class: "sub",
                             style: "font-size:10px;padding:1px" },
                     h % 6 === 0 ? String(h) : ""));
    }
    tbl.append(el("thead", {}, head));
    const tb = el("tbody");
    const maxIn = (arr) => arr.reduce((a, b) => Math.max(a, b), 1);
    for (const s of species.slice(0, 25)) {
      const row = el("tr", {});
      const nameCell = el("td", {},
        s.thumbnail_url
          ? el("img", { src: s.thumbnail_url, loading: "lazy",
                        style: "width:24px;height:24px;border-radius:50%;"
                               + "object-fit:cover;margin-right:6px;"
                               + "vertical-align:middle" })
          : null,
        el("strong", {}, s.common_name || s.scientific_name),
        s.is_new_species
          ? el("span", { class: "pill info", title: t("new_species"),
                         style: "margin-left:6px" }, "★")
          : null);
      nameCell.title = `${s.scientific_name} · `
        + `${t("first_seen")} ${s.first_heard || "–"} · `
        + `max ${Math.round((s.max_confidence || 0) * 100)}%`;
      row.append(nameCell, el("td", {}, fmtNum(s.count)));
      const peak = maxIn(s.hourly_counts);
      for (let h = 0; h < 24; h++) {
        const n = s.hourly_counts[h];
        const size = n ? 4 + Math.round(8 * n / peak) : 0;
        row.append(el("td", { style: "padding:1px;text-align:center",
                              title: n ? `${h}:00 — ${n}` : "" },
          n ? el("span", { style:
            `display:inline-block;width:${size}px;height:${size}px;`
            + "border-radius:50%;background:var(--accent-primary,#4a9)" })
            : ""));
      }
      tb.append(row);
    }
    tbl.append(tb);
    card.append(el("div", { style: "overflow-x:auto" }, tbl));
  } catch (e) {
    card.append(el("div", { class: "empty" }, e.message));
  }
}
