/* Range filter page: occurrence heatmap over a lat/lon grid (the vmapped
   geomodel batch — reference classifier/heatmap_service.go), per-species
   scores at the configured location, included-species list + CSV export,
   a test-a-location form, and rebuild. Consumes /api/v2/range/*. */

import { api, el, clear, fmtNum, toast, t, table } from "../app.js";

export async function rangeView(outlet) {
  outlet.append(el("h1", {}, t("range_filter")));

  const statusCard = el("div", { class: "card" });
  const mapCard = el("div", { class: "card" });
  const grid = el("div", { class: "grid cols-2" });
  const scoresCard = el("div", { class: "card" });
  const testCard = el("div", { class: "card" });
  grid.append(scoresCard, testCard);
  const listCard = el("div", { class: "card" });
  outlet.append(statusCard, mapCard, grid, listCard);

  // ---- status ----
  let status = {};
  try {
    status = await api("/range/status");
    statusCard.append(el("h2", {}, t("status")),
      el("div", { class: "grid cols-4" },
        tile(t("enabled"), status.enabled ? "yes" : "no"),
        tile(t("included_species"), fmtNum(status.included_count)),
        tile(t("location"), status.latitude != null
          ? `${status.latitude}, ${status.longitude}` : "not set"),
        tile(t("threshold"), status.threshold)),
      el("div", { class: "row", style: "margin-top:8px" },
        el("button", { class: "primary", onclick: async () => {
          const out = await api("/range/rebuild", { method: "POST" });
          toast(`Rebuilt: ${out.included_count ?? "ok"} species`);
        } }, t("rebuild")),
        el("a", { class: "btn small", href: "/api/v2/range/species/csv",
                  download: "range-species.csv" }, "⬇ CSV")));
  } catch (e) { statusCard.append(el("div", { class: "empty" }, e.message)); }

  // ---- occurrence heatmap ----
  const week = el("input", { type: "range", min: 1, max: 48, value: 24,
                             style: "width:180px" });
  const weekLabel = el("span", { class: "sub" }, t("week") + " 24");
  const resolution = el("select", {},
    [["16", "coarse"], ["24", "medium"], ["36", "fine"]].map(([v, n]) =>
      el("option", { value: v, selected: v === "24" ? "" : null }, n)));
  const canvas = el("canvas", { width: 960, height: 480,
    style: "width:100%;border-radius:8px;background:#05080f" });
  const mapStatus = el("span", { class: "sub" }, "");
  mapCard.append(el("h2", {}, t("occurrence_heatmap")),
    el("div", { class: "row", style: "margin-bottom:8px" },
      weekLabel, week, resolution,
      el("button", { class: "primary", onclick: drawMap }, t("render")),
      mapStatus),
    canvas);
  week.addEventListener("input",
    () => { weekLabel.textContent = `${t("week")} ${week.value}`; });

  async function drawMap() {
    mapStatus.textContent = "computing…";
    try {
      const res = Number(resolution.value);
      const data = await api(
        `/range/heatmap?resolution=${res}&week=${week.value}`);
      const { lats = [], lons = [], values = [] } = data;
      const g = canvas.getContext("2d");
      g.clearRect(0, 0, canvas.width, canvas.height);
      let max = 0;
      for (const row of values) for (const v of row) max = Math.max(max, v);
      const cw = canvas.width / lons.length;
      const ch = canvas.height / lats.length;
      for (let i = 0; i < lats.length; i++) {
        for (let j = 0; j < lons.length; j++) {
          const v = max > 0 ? values[i][j] / max : 0;
          // lat 85 at top → row index reversed (lats ascend south→north)
          const y = (lats.length - 1 - i) * ch;
          g.fillStyle = heatColor(v);
          g.fillRect(j * cw, y, Math.ceil(cw), Math.ceil(ch));
        }
      }
      // marker for the configured location
      if (status.latitude != null) {
        const x = ((status.longitude + 180) / 360) * canvas.width;
        const y = ((85 - status.latitude) / 170) * canvas.height;
        g.strokeStyle = "#fff";
        g.lineWidth = 2;
        g.beginPath();
        g.arc(x, y, 6, 0, 2 * Math.PI);
        g.stroke();
      }
      mapStatus.textContent = `max richness ${Math.round(max)}`;
    } catch (e) { mapStatus.textContent = e.message; }
  }

  // ---- per-species scores at the configured location ----
  try {
    const { species = [] } = await api("/range/species/scores?limit=25");
    scoresCard.append(el("h2", {}, t("top_species_here")),
      species && species.length
        ? table([t("species"), t("score")], species.map((s) => [
            el("span", {}, el("strong", {}, s.common_name || ""), " ",
               el("em", { class: "sub" }, s.scientific_name)),
            (s.score ?? 0).toFixed(3)]))
        : el("div", { class: "empty" }, t("set_location_first")));
  } catch (e) {
    scoresCard.append(el("h2", {}, t("top_species_here")),
      el("div", { class: "empty" }, e.message));
  }

  // ---- test a location ----
  {
    const lat = el("input", { type: "number", step: "0.01", size: 8,
                              placeholder: "lat", value: status.latitude ?? "" });
    const lon = el("input", { type: "number", step: "0.01", size: 8,
                              placeholder: "lon", value: status.longitude ?? "" });
    const wk = el("input", { type: "number", min: 1, max: 48, size: 5,
                             placeholder: "week" });
    const thr = el("input", { type: "number", step: "0.01", min: 0, max: 1,
                              size: 6, value: status.threshold ?? 0.01 });
    const out = el("div", { class: "sub", style: "margin-top:8px" });
    testCard.append(el("h2", {}, t("test_location")),
      el("div", { class: "row" }, lat, lon, wk, thr,
        el("button", { class: "primary", onclick: async () => {
          try {
            const r = await api("/range/species/test", { method: "POST",
              body: { latitude: Number(lat.value), longitude: Number(lon.value),
                      week: wk.value ? Number(wk.value) : -1,
                      threshold: Number(thr.value) } });
            out.textContent =
              `${r.count} species ≥ threshold ${r.threshold}`;
          } catch (e) { out.textContent = e.message; }
        } }, t("apply"))), out);
  }

  // ---- included species list ----
  try {
    const [{ species = [] }, { count = 0 }] = await Promise.all([
      api("/range/species/list"), api("/range/species/count")]);
    listCard.append(el("h2", {}, `Included species (${fmtNum(count)})`));
    if (!species.length) {
      listCard.append(el("div", { class: "empty" },
        "Range filter disabled — all species pass"));
    } else {
      const search = el("input", { placeholder: t("search") + "…", size: 26 });
      const body = el("div", { class: "chip-wrap" });
      const render = (q) => {
        clear(body);
        const ql = q.toLowerCase();
        for (const s of species.filter(
            (x) => !ql || x.toLowerCase().includes(ql)).slice(0, 400)) {
          body.append(el("span", { class: "pill" }, s));
        }
      };
      search.addEventListener("input", () => render(search.value));
      render("");
      listCard.append(el("div", { class: "filters" }, search), body);
    }
  } catch (e) { listCard.append(el("div", { class: "empty" }, e.message)); }

  drawMap();

  function tile(label, value) {
    return el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value", style: "font-size:20px" }, value ?? "–"));
  }
}

/* sequential blue→yellow heat ramp over a dark basemap */
function heatColor(v) {
  if (v <= 0.005) return "rgba(16,24,40,0.9)";
  const r = Math.round(20 + 235 * v);
  const g = Math.round(40 + 180 * v);
  const b = Math.round(120 + 60 * (1 - v));
  return `rgba(${r},${g},${b},${0.35 + 0.65 * v})`;
}

