/* Analytics: species ranking, daily trend, hour×date heatmap, confidence
   histogram, diversity, accumulation, new species, dawn onset, species
   ridgeline, 24-hour radial clock, year-over-year, seasonal trend, and a
   per-species drill-down modal (reference analytics feature set:
   frontend/src/lib/desktop/features/analytics/components — TimeOfDay
   SpeciesChart, SpeciesRidgeline, NocturnalClock, YearOverYearChart,
   SeasonalHeatmap, SpeciesPhenology, SpeciesDetailModal,
   AcousticSuccessionChart → streamGraph, NewSpeciesTimelineChart →
   timelineChart, SpeciesDiversityChart → diversity-over-time line). */

import { api, el, fmtNum, t, table, isoDaysAgo, modal } from "../app.js";
import { barChart, hBarChart, heatmap, lineChart, ridgeline,
         radialClock, streamGraph, timelineChart } from "../charts.js";

export async function analyticsView(outlet) {
  outlet.append(el("h1", {}, t("analytics")));

  // one filter row scoping everything below
  const range = el("select", {},
    el("option", { value: "30" }, t("last30")),
    el("option", { value: "7" }, t("last7")),
    el("option", { value: "90" }, "Last 90 days"),
    el("option", { value: "365" }, t("last_year")));
  outlet.append(el("div", { class: "filters" }, range,
    el("button", { class: "primary", onclick: render }, t("apply"))));

  const grid = el("div", {});
  outlet.append(grid);
  await render();

  async function render() {
    grid.replaceChildren();
    const days = Number(range.value);
    const from = iso(days - 1), to = iso(0);

    const card = (title, node) =>
      el("div", { class: "card" }, el("h2", {}, title), node);

    // period-over-period trend tiles (GetDetectionTrends parity)
    try {
      const tr = await api(`/analytics/trends?days=${days}`);
      const arrow = (pct) => pct == null ? ""
        : ` ${pct >= 0 ? "▲" : "▼"} ${Math.abs(pct)}%`;
      grid.append(el("div", { class: "grid cols-2" },
        el("div", { class: "stat" },
          el("div", { class: "label" }, `Detections (${days}d vs prior)`),
          el("div", { class: "value" },
             `${fmtNum(tr.detections)}${arrow(tr.detections_change_pct)}`)),
        el("div", { class: "stat" },
          el("div", { class: "label" }, `Species (${days}d vs prior)`),
          el("div", { class: "value" },
             `${fmtNum(tr.species)}${arrow(tr.species_change_pct)}`))));
    } catch (e) { /* optional */ }

    // top species (horizontal bars — ranked magnitude, sequential hue)
    try {
      const res = await api(`/analytics/summary?from=${from}&to=${to}`);
      const rows = (Array.isArray(res) ? res : res.species || res.summary || [])
        .slice(0, 12);
      grid.append(card(t("top_species"), hBarChart(rows.map((r) => ({
        label: r.common_name || r.scientific_name, value: r.count,
        sci: r.scientific_name })),
        { onClick: (d) => speciesDetail(d, from, to) })));
    } catch (e) { grid.append(card(t("top_species"), err(e))); }

    const two = el("div", { class: "grid cols-2" });
    grid.append(two);

    // daily trend
    try {
      const res = await api(`/analytics/daily?from=${from}&to=${to}`);
      const rows = Array.isArray(res) ? res : res.daily || [];
      two.append(card(t("detections_per_day"), lineChart([{
        name: "detections", color: "var(--series-1)", area: true,
        points: rows.map((r) => ({ x: (r.date || "").slice(5),
                                   y: r.count ?? r.total ?? 0 })),
      }])));
      // same rows carry per-day distinct species (reference
      // SpeciesDiversityChart.svelte — daily uniqueSpecies line + area)
      two.append(card(t("diversity_over_time"), lineChart([{
        name: "unique species", color: "var(--series-3)", area: true,
        points: rows.map((r) => ({ x: (r.date || "").slice(5),
                                   y: r.species ?? 0 })),
      }])));
    } catch (e) { two.append(card(t("detections_per_day"), err(e))); }

    // confidence histogram
    try {
      const res = await api("/analytics/confidence");
      const bins = Array.isArray(res) ? res : res.bins || res.histogram || [];
      two.append(card(t("confidence_dist"), barChart(bins.map((v, i) => ({
        label: `${(i / bins.length).toFixed(1)}`, value: v })),
        { xLabelEvery: 2, height: 170 })));
    } catch (e) { two.append(card(t("confidence_dist"), err(e))); }

    // date × hour heatmap ({date: int[24]} from the API); its column sums
    // also feed the 24-hour radial activity clock below
    let hourlyTotals = null;
    try {
      const res = await api(`/analytics/heatmap?from=${from}&to=${to}`);
      const dates = Object.keys(res).sort();
      const shown = dates.slice(-21);
      grid.append(card(t("heatmap") + " (date × hour)", shown.length
        ? heatmap({ rows: shown.map((d) => d.slice(5)),
                    cols: [...Array(24).keys()].map(String),
                    values: shown.map((d) => res[d]) },
                  // drill: cell → detections pre-filtered to that
                  // date + hour (deep link — app.js viewQuery)
                  { onCellClick: (rl, cl) => {
                      const full = shown.find((d) => d.slice(5) === rl);
                      if (full) location.hash =
                        `#/detections?date=${full}&hour=${cl}`;
                    } })
        : el("div", { class: "empty" }, t("no_data"))));
      if (dates.length) hourlyTotals = [...Array(24).keys()].map((h) =>
        dates.reduce((s, d) => s + (res[d][h] || 0), 0));
    } catch (e) { grid.append(card(t("heatmap"), err(e))); }

    // species ridgeline (per-species diel activity) + 24h radial clock
    const diel = el("div", { class: "grid cols-2" });
    grid.append(diel);
    try {
      const { species = [] } = await api(
        `/analytics/time-of-day?from=${from}&to=${to}&top=8`);
      diel.append(card(t("species_by_hour"), species.length
        ? ridgeline(species.map((s) => ({
            label: s.common_name || s.scientific_name, values: s.hourly })),
            { colLabels: [...Array(24).keys()].map((h) =>
                `${String(h).padStart(2, "0")}:00`) })
        : el("div", { class: "empty" }, t("no_data"))));
      // the same per-species diel profiles, as the reference's
      // acoustic-succession streamgraph (AcousticSuccessionChart.svelte)
      if (species.length >= 2)
        grid.append(card(t("acoustic_succession"),
          streamGraph(species.map((s) => ({
            label: s.common_name || s.scientific_name, values: s.hourly })),
            { colLabels: [...Array(24).keys()].map((h) =>
                `${String(h).padStart(2, "0")}:00`) })));
    } catch (e) { diel.append(card(t("species_by_hour"), err(e))); }
    if (hourlyTotals)
      diel.append(card(t("activity_clock"), radialClock(hourlyTotals)));

    // year-over-year monthly comparison + seasonal per-species trend
    const season = el("div", { class: "grid cols-2" });
    grid.append(season);
    try {
      const yoy = await api("/analytics/year-over-year");
      const years = Object.keys(yoy).sort().slice(-5);
      if (years.length >= 1) {
        season.append(card(t("year_over_year"), lineChart(
          years.map((y, i) => ({
            name: y, color: `var(--series-${i + 1})`,
            points: yoy[y].map((n, m) => ({
              x: String(m + 1).padStart(2, "0"), y: n })),
          })))));
      }
    } catch (e) { /* optional */ }
    try {
      const res = await api(
        `/analytics/species-daily-trend?from=${from}&to=${to}&top=6`);
      if (res.species.length) {
        // bucket the range into ≤40 columns so long ranges stay readable
        const dates = dateSpan(from, to);
        const step = Math.ceil(dates.length / 40);
        const cols = [], starts = [];
        for (let i = 0; i < dates.length; i += step) {
          starts.push(i);
          cols.push(dates[i].slice(5));
        }
        season.append(card(t("seasonal_trend"), heatmap({
          rows: res.species.map((s) => s.common_name || s.scientific_name),
          cols,
          values: res.species.map((s) => starts.map((i0) =>
            dates.slice(i0, i0 + step)
              .reduce((sum, d) => sum + (s.daily[d] || 0), 0))),
        })));
      }
    } catch (e) { /* optional */ }

    const three = el("div", { class: "grid cols-2" });
    grid.append(three);

    // accumulation curve
    try {
      const res = await api(`/analytics/accumulation?from=${from}&to=${to}`);
      const rows = Array.isArray(res) ? res : res.accumulation || [];
      three.append(card(t("accumulation"), lineChart([{
        name: "cumulative species", color: "var(--series-3)",
        points: rows.map((r) => ({ x: (r.date || "").slice(5),
                                   y: r.cumulative_species ?? r.species
                                     ?? r.count ?? 0 })),
      }])));
    } catch (e) { three.append(card(t("accumulation"), err(e))); }

    // diversity tiles ({richness, shannon, detections})
    try {
      const d = await api(`/analytics/diversity?from=${from}&to=${to}`);
      three.append(el("div", { class: "card" },
        el("h2", {}, t("diversity")),
        el("div", { class: "grid cols-2" },
          tile(t("species_richness"), d.richness),
          tile(t("shannon_index"), round2(d.shannon)),
          tile(t("detections"), fmtNum(d.detections)))));
    } catch (e) { three.append(card(t("diversity"), err(e))); }

    // succession: monthly composition (top species share per month)
    try {
      const { succession = [] } = await api(
        `/analytics/succession?from=${from}&to=${to}&top=5`);
      if (succession.length) {
        grid.append(card("Succession (monthly top-5 share)",
          table([t("month"), t("total"), t("top_species")],
            succession.map((m) => [m.month, fmtNum(m.total),
              m.species.map((s) =>
                `${s.common_name || s.scientific_name} `
                + `${Math.round(s.share * 100)}%`).join(" · ")]))));
      }
    } catch (e) { /* optional */ }

    // new species + dawn onset
    const four = el("div", { class: "grid cols-2" });
    grid.append(four);
    try {
      const res = await api("/analytics/species/first-seen");
      const rows = (Array.isArray(res) ? res : res.species || []).slice(0, 10);
      // first-heard markers on a time axis (reference
      // NewSpeciesTimelineChart.svelte); rows without a date fall back
      // to the plain table
      const items = rows.filter((r) => r.first_date).map((r) => ({
        label: r.common_name || r.scientific_name,
        sci: r.scientific_name, date: r.first_date }))
        .sort((a, b) => (a.date < b.date ? -1 : 1));
      four.append(el("div", { class: "card timeline-card" },
        el("h2", {}, t("newest_species")),
        items.length
          ? timelineChart(items, { onClick: (it) => location.hash =
              `#/detections?species=${encodeURIComponent(it.sci)}` })
          : table([t("species"), t("first_seen")], rows.map((r) => [
              r.common_name || r.scientific_name, r.first_date || "–"]))));
    } catch (e) { four.append(card(t("newest_species"), err(e))); }
    // dawn chorus: today's hour-of-day activity histogram
    try {
      const { hourly = [] } = await api("/analytics/dawn-chorus");
      four.append(card(t("dawn_chorus") + " (today by hour)",
        barChart((hourly || []).map((v, h) => ({ label: String(h), value: v })),
                 { xLabelEvery: 3, height: 150,
                   onClick: (d) => location.hash =
                     `#/detections?from=${isoDaysAgo(0)}&hour=${d.label}` })));
    } catch (e) { /* optional */ }
    // insights: dawn chorus leaders (per-species average earliest
    // detection in the 04-10 band) + phantom species (frequent but
    // chronically low-confidence → likely misidentifications)
    try {
      const dc = await api("/insights/dawn-chorus");
      const rows = (dc.species || []).slice(0, 10);
      if (rows.length)
        four.append(el("div", { class: "card" },
          el("h2", {}, "🌅 " + t("dawn_chorus_leaders")),
          table([t("species"), t("avg_first"), t("earliest"), t("days")],
            rows.map((r) => [r.common_name || r.scientific_name,
              r.avg_first_detection, r.earliest_detection,
              String(r.days_observed)]))));
    } catch (e) { /* optional */ }
    try {
      const ph = await api("/insights/phantom-species");
      const rows = (ph.species || []).slice(0, 10);
      if (rows.length)
        four.append(el("div", { class: "card" },
          el("h2", {}, "👻 " + t("phantom_species")),
          el("div", { class: "hint" }, t("phantom_species_hint")),
          table([t("species"), t("count"), t("avg_conf"), t("max_conf")],
            rows.map((r) => [r.common_name || r.scientific_name,
              fmtNum(r.detection_count),
              (r.avg_confidence * 100).toFixed(0) + "%",
              (r.max_confidence * 100).toFixed(0) + "%"]))));
    } catch (e) { /* optional */ }
    // database stats + today's rollup (daily events)
    try {
      const [db, ev] = await Promise.all([
        api("/analytics/database/stats"),
        api(`/analytics/daily-events/${iso(0)}`)]);
      four.append(el("div", { class: "card" },
        el("h2", {}, t("database")),
        el("div", { class: "grid cols-2" },
          tile(t("detections"), fmtNum(db.detections)),
          tile(t("species"), fmtNum(db.species)),
          tile(t("first_today"), ev.first_detection || "–"),
          tile(t("last_today"), ev.last_detection || "–"))));
    } catch (e) { /* optional */ }
    try {
      const res = await api(`/analytics/dawn-onset?from=${from}&to=${to}`);
      const rows = (res.dawn_onset || []).slice(-10);
      four.append(el("div", { class: "card" },
        el("h2", {}, t("dawn_onset") + " (min after civil dawn)"),
        rows.length
          ? table([t("date"), t("species"), "Δ dawn (min)"], rows.map((r) => [
              r.date, r.common_name || r.scientific_name,
              String(r.minutes_after_dawn)]))
          : el("div", { class: "empty" }, t("needs_location"))));
    } catch (e) { four.append(card(t("dawn_onset"), err(e))); }
  }

  function tile(label, value) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value" }, value ?? "–"));
  }
}

/** Per-species drill-down (reference SpeciesDetailModal): 48-week
    phenology, diel profile, and year-over-year for one species. */
async function speciesDetail(d, from, to) {
  const { body } = modal(d.label);
  const photo = el("img", { loading: "lazy", alt: "",
    style: "width:100%;max-height:220px;object-fit:cover;"
      + "border-radius:10px;margin-bottom:10px",
    src: `/api/v2/species/thumbnail?name=${encodeURIComponent(d.sci)}` });
  photo.addEventListener("error", () => photo.remove());
  body.append(photo);
  body.append(el("div", { class: "grid cols-2" },
    el("div", { class: "stat" },
      el("div", { class: "label" }, t("detections")),
      el("div", { class: "value" }, fmtNum(d.value))),
    el("div", { class: "stat" },
      el("div", { class: "label" }, t("scientific")),
      el("div", { class: "value" }, d.sci || "–"))));
  try {
    const weeks = await api(
      `/analytics/phenology/${encodeURIComponent(d.sci)}`);
    body.append(el("h3", {}, t("phenology")),
      barChart(weeks.map((w) => ({
        label: String(w.week), value: w.count })),
        { xLabelEvery: 4, height: 140 }));
  } catch (e) { /* optional */ }
  try {
    const { species = [] } = await api(
      `/analytics/time-of-day?from=${from}&to=${to}`
      + `&species=${encodeURIComponent(d.sci)}`);
    if (species.length) body.append(el("h3", {}, t("activity_by_hour")),
      radialClock(species[0].hourly));
  } catch (e) { /* optional */ }
  try {
    const yoy = await api(
      `/analytics/year-over-year?species=${encodeURIComponent(d.sci)}`);
    const years = Object.keys(yoy).sort().slice(-5);
    if (years.length) body.append(el("h3", {}, t("monthly_by_year")),
      lineChart(years.map((y, i) => ({
        name: y, color: `var(--series-${i + 1})`,
        points: yoy[y].map((n, m) => ({
          x: String(m + 1).padStart(2, "0"), y: n })),
      }))));
  } catch (e) { /* optional */ }
}

/** Inclusive ISO date list from..to (bounded to 2 years). */
function dateSpan(from, to) {
  const out = [];
  const d = new Date(from + "T00:00:00Z");
  const end = new Date(to + "T00:00:00Z");
  while (d <= end && out.length < 732) {
    out.push(d.toISOString().slice(0, 10));
    d.setUTCDate(d.getUTCDate() + 1);
  }
  return out;
}

const iso = isoDaysAgo;
function round2(v) { return v == null ? null : Math.round(v * 100) / 100; }
function err(e) { return el("div", { class: "empty" }, e.message); }

