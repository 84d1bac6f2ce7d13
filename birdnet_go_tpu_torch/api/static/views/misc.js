/* Remaining views: notifications inbox, models gallery, species/taxonomy
   + range filter, and BirdNET-Pi import jobs. */

import { api, el, clear, fmtNum, fmtTime, toast, t, subscribe, table, viewInterval, confMeter } from "../app.js";
import { barChart, lineChart, radialClock } from "../charts.js";

// ------------------------------------------------------------- notifications

export async function notificationsView(outlet) {
  outlet.append(el("h1", {}, t("notifications")));
  outlet.append(el("div", { class: "row", style: "margin-bottom:10px" },
    el("button", { onclick: async () => {
      await api("/notifications/read-all", { method: "PUT" })
        .catch((e) => toast(e.message, true));
      render();
    } }, t("mark_all_read")),
    el("button", { onclick: async () => {
      await api("/notifications/test", { method: "POST", body: {} });
      toast(t("test_notification_sent"));
      render();
    } }, t("send_test"))));
  const list = el("div", { class: "card" });
  outlet.append(list);
  await render();
  subscribe("/notifications/stream", render);

  async function render() {
    const { notifications = [] } = await api("/notifications?limit=100");
    clear(list);
    if (!notifications.length) {
      list.append(el("div", { class: "empty" }, t("no_data")));
      return;
    }
    for (const n of notifications) {
      list.append(el("div", { class: "notif" + (n.read ? "" : " unread") },
        el("span", { class: "pill " + prio(n.priority) }, n.priority),
        el("span", {},
          el("div", { class: "title" }, n.title),
          el("div", { class: "sub" }, n.message)),
        el("span", { class: "time" }, fmtTime(n.timestamp)),
        el("button", { class: "small", title: "mark read",
          onclick: async () => {
            await api(`/notifications/${n.id}/read`, { method: "PUT" })
              .catch((e) => toast(e.message, true));
            render();
          } }, "✓"),
        el("button", { class: "small danger", onclick: async () => {
          await api(`/notifications/${n.id}`, { method: "DELETE" })
            .catch((e) => toast(e.message, true));
          render();
        } }, "🗑")));
    }
  }
  function prio(p) {
    return p === "critical" ? "bad" : p === "high" ? "warn" : "info";
  }
}

// -------------------------------------------------------------------- models

export async function modelsView(outlet) {
  outlet.append(el("h1", {}, t("models")));
  const loadedCard = el("div", { class: "card" });
  const catalogCard = el("div", { class: "card" });
  outlet.append(loadedCard, catalogCard);
  await render();

  async function render() {
    const [models, catalog, installed] = await Promise.all([
      api("/models"), api("/models/catalog"), api("/models/installed")]);
    const all = Array.isArray(models) ? models : models.models || [];
    clear(loadedCard);
    loadedCard.append(el("h2", {}, t("registry")));
    loadedCard.append(table(
      [t("model"), t("species"), t("rate"), t("clip"), t("state"), ""],
      all.map((m) => [
        m.display_name || m.model_id, fmtNum(m.num_species),
        `${(m.sample_rate || 0) / 1000} kHz`,
        `${m.clip_seconds || "?"} s`,
        el("span", { class: "pill " + (m.loaded ? "good" : "") },
           m.loaded ? "loaded" : "idle"),
        m.loaded
          ? el("button", { class: "small danger", onclick: async () => {
              await api(`/models/unload/${m.model_id}`, { method: "POST" });
              toast(t("unloaded"));
              render();
            } }, t("unload"))
          : el("button", { class: "small", onclick: async () => {
              await api(`/models/load/${m.model_id}`, { method: "POST" });
              toast(t("loaded"));
              render();
            } }, t("load"))])));
    clear(catalogCard);
    catalogCard.append(el("h2", {}, t("catalog")));
    const installedList = Array.isArray(installed)
      ? installed : (installed?.installed || installed?.models || []);
    const installedIds = new Set(
      installedList.map((i) => i.model_id || i.id));
    catalogCard.append(table(
      [t("model"), t("description"), t("size"), ""],
      (Array.isArray(catalog) ? catalog : []).map((c) => [
        c.model_id || c.id, c.description || "",
        c.size_mb ? `${c.size_mb} MB` : "–",
        installedIds.has(c.model_id || c.id)
          ? el("div", { class: "row" },
              el("button", { class: "small", onclick: async () => {
                await api(`/models/load/${c.model_id || c.id}`,
                          { method: "POST" });
                toast(t("model_loaded"));
                render();
              } }, t("load")),
              el("button", { class: "small danger", onclick: async () => {
                await api(`/models/installed/${c.model_id || c.id}`,
                          { method: "DELETE" });
                render();
              } }, t("remove")))
          : el("button", { class: "small primary", onclick: async () => {
              await api(`/models/install/${c.model_id || c.id}`,
                        { method: "POST" });
              toast(t("installing"));
              poll(c.model_id || c.id);
            } }, t("install"))])));
  }

  async function poll(id) {
    for (let i = 0; i < 120; i++) {
      await new Promise((r) => setTimeout(r, 2000));
      try {
        const p = await api(`/models/install/${id}/progress`);
        if (p.status !== "running") {
          toast(`Install ${p.status}${p.error ? `: ${p.error}` : ""}`,
                p.status === "failed");
          render();
          return;
        }
      } catch (e) { return; }
    }
  }
}

// ------------------------------------------------------------------- species

export async function speciesView(outlet, rest) {
  // #/species/<encoded scientific name> → routed per-species page
  if (rest && rest[0]) {
    return speciesPage(outlet, decodeURIComponent(rest[0]));
  }
  outlet.append(el("h1", {}, t("species")));
  const search = el("input", { placeholder: t("search") + "…", size: 26 });
  const results = el("div", { class: "card" });
  const treeCard = el("div", { class: "card" });
  const extrasCard = el("div", { class: "card" });
  outlet.append(el("div", { class: "filters" }, search), results,
                treeCard, extrasCard);
  renderTree(treeCard);
  renderExtras(extrasCard);

  search.addEventListener("input", debounce(async () => {
    const q = search.value.trim();
    clear(results);
    if (q.length < 2) { renderDetected(); return; }
    const { species = [] } = await api(`/species/search?q=${encodeURIComponent(q)}`);
    results.append(table([t("common_name"), t("scientific"), t("taxonomy")],
      species.map((s) => [s.common_name,
        el("em", {}, s.scientific_name),
        el("button", { class: "small", onclick: async (ev) => {
          const info = await api(`/species/info?name=${
            encodeURIComponent(s.scientific_name)}`);
          toast(`${info.canonical_name}`
            + `${info.family ? " · " + info.family : ""}`
            + `${info.order ? " · " + info.order : ""}`
            + `${info.aliased ? " (renamed)" : ""}`);
        } }, "ℹ")])));
  }, 250));

  await renderDetected();
  async function renderDetected() {
    const { species = [] } = await api("/species");
    clear(results);
    results.append(el("h2", {}, t("detected_species")));
    if (!species.length) {
      results.append(el("div", { class: "empty" }, t("no_data")));
    } else {
      results.append(table(
        [t("species"), t("count"), t("max_conf"), t("first_seen"), t("last_seen")],
        species.slice(0, 50).map((s) => [
          el("span", { class: "row" }, speciesThumb(s.scientific_name),
             el("a", { href: `#/species/${
                 encodeURIComponent(s.scientific_name)}` },
                el("strong", {}, s.common_name || ""), " ",
                el("em", { class: "sub" }, s.scientific_name))),
          fmtNum(s.count), `${Math.round((s.max_confidence || 0) * 100)}%`,
          s.first_seen ? fmtTime(s.first_seen) : "–",
          s.last_seen ? fmtTime(s.last_seen) : "–"])));
    }
  }

}

/** Routed per-species detail page (reference SpeciesDetailModal as a
    shareable view): photo, taxonomy line, station stats, 48-week
    phenology, diel clock, year-over-year, recent detections. */
async function speciesPage(outlet, sci) {
  outlet.append(el("div", { class: "row", style: "margin-bottom:8px" },
    el("a", { href: "#/species", class: "sub" }, "‹ " + t("species"))));
  const head = el("div", { class: "card" });
  outlet.append(head);
  const photo = el("img", { loading: "lazy", alt: "",
    style: "width:120px;height:120px;border-radius:12px;object-fit:cover",
    src: `/api/v2/species/thumbnail?name=${encodeURIComponent(sci)}` });
  photo.addEventListener("error", () => photo.remove());
  const title = el("div", {},
    el("h1", { style: "margin:0" }, sci),
    el("em", { class: "sub" }, sci));
  const taxLine = el("div", { class: "sub" });
  head.append(el("div", { class: "row" }, photo,
                 el("div", {}, title, taxLine)));
  api(`/species/info?name=${encodeURIComponent(sci)}`).then((info) => {
    if (info.canonical_name) {
      clear(title);
      title.append(
        el("h1", { style: "margin:0" },
           info.common_name || info.canonical_name),
        el("em", { class: "sub" }, info.canonical_name));
    }
    taxLine.textContent = [info.order, info.family]
      .filter(Boolean).join(" · ");
    for (const [url, label] of [[info.wikipedia_url, "Wikipedia"],
                                [info.inaturalist_url, "iNaturalist"]]) {
      if (url) taxLine.append(" · ", el("a", { href: url,
        target: "_blank", rel: "noopener noreferrer" }, label + " ↗"));
    }
  }).catch(() => {});

  const stats = el("div", { class: "grid cols-4" });
  head.append(stats);
  api("/species").then(({ species }) => {
    const mine = (species || []).find((s) => s.scientific_name === sci);
    if (!mine) return;
    const tile = (label, value) => el("div", { class: "stat" },
      el("div", { class: "label" }, label),
      el("div", { class: "value", style: "font-size:18px" }, value));
    stats.append(
      tile(t("detections"), fmtNum(mine.count)),
      tile(t("max_conf"), `${Math.round((mine.max_confidence || 0) * 100)}%`),
      tile(t("first_seen"), mine.first_seen ? fmtTime(mine.first_seen) : "–"),
      tile(t("last_seen"), mine.last_seen ? fmtTime(mine.last_seen) : "–"));
  }).catch(() => {});

  const charts = el("div", { class: "grid cols-2" });
  outlet.append(charts);
  const card = (titleText, node) =>
    el("div", { class: "card" }, el("h2", {}, titleText), node);
  // fire the four independent fetches concurrently, then append in a
  // stable order as each settles (review: sequential awaits quadrupled
  // the page's chart latency)
  const today = new Date().toISOString().slice(0, 10);
  const phenoP = api(`/analytics/phenology/${encodeURIComponent(sci)}`)
    .catch(() => null);
  const todP = api(`/analytics/time-of-day?from=1970-01-01&to=${today}`
    + `&species=${encodeURIComponent(sci)}`).catch(() => null);
  const yoyP = api(
    `/analytics/year-over-year?species=${encodeURIComponent(sci)}`)
    .catch(() => null);
  const detP = api("/detections/search", {
    method: "POST", body: { species: sci, limit: 10 } })
    .catch(() => null);

  const weeks = await phenoP;
  if (Array.isArray(weeks) && weeks.some((w) => w.count > 0)) {
    charts.append(card(t("phenology"), barChart(weeks.map((w) => ({
      label: String(w.week), value: w.count })),
      { xLabelEvery: 4, height: 150 })));
  }
  const tod = await todP;
  if (tod && Array.isArray(tod.species) && tod.species.length) {
    charts.append(card(t("activity_clock"),
                       radialClock(tod.species[0].hourly)));
  }
  const yoy = await yoyP;
  if (yoy) {
    const years = Object.keys(yoy).sort().slice(-5);
    if (years.length) {
      charts.append(card(t("monthly_by_year"),
        lineChart(years.map((y, i) => ({
          name: y, color: `var(--series-${i + 1})`,
          points: yoy[y].map((n, m) => ({
            x: String(m + 1).padStart(2, "0"), y: n })),
        })))));
    }
  }

  // recent detections of this species
  {
    const { detections = [] } = (await detP) || {};
    if (detections.length) {
      outlet.append(el("div", { class: "card" },
        el("h2", {}, t("recent_detections")),
        table([t("date"), t("confidence"), t("source"), ""],
          detections.map((d) => [
            fmtTime(d.timestamp), confMeter(d.confidence), d.source_id,
            el("a", { class: "small", href: `#/detection/${d.id}`,
                      title: t("open_detail") }, "↗")]))));
    }
  }
}

/** 30px species photo from the image provider (reference
    SpeciesThumbnail.svelte); silently removes itself when no image. */
function speciesThumb(scientific) {
  const img = el("img", { loading: "lazy", alt: "",
    style: "width:30px;height:30px;border-radius:50%;object-fit:cover",
    src: `/api/v2/species/thumbnail?name=${encodeURIComponent(scientific)}` });
  img.addEventListener("error", () => img.remove());
  return img;
}

// genus → species taxonomy tree (GET /taxonomy/tree)
async function renderTree(card) {
  card.append(el("h2", {}, t("taxonomy")));
  try {
    const { tree = {}, genera = 0, species = 0 } = await api("/taxonomy/tree");
    card.append(el("p", { class: "sub" },
      `${genera ?? Object.keys(tree).length} genera · `
      + `${species ?? "?"} species in the primary model`));
    const host = el("div", { style: "max-height:320px;overflow:auto" });
    const names = Object.keys(tree).sort();
    for (const genus of names.slice(0, 500)) {
      const kids = tree[genus];
      const meta = el("span", { class: "sub", style: "margin-left:8px" });
      const det = el("details", {},
        el("summary", {}, `${genus} (${kids.length})`, meta),
        el("div", { class: "chip-wrap", style: "padding:6px 0 6px 16px" },
          kids.slice(0, 60).map((s) => el("span", { class: "pill",
            title: s.scientific_name },
            s.common_name || s.scientific_name))));
      det.addEventListener("toggle", async () => {
        if (!det.open || meta.textContent) return;
        try {
          const g = await api(`/taxonomy/genus/${encodeURIComponent(genus)}`);
          meta.textContent = [g.family, g.order]
            .filter(Boolean).join(" · ");
        } catch (e) { /* no taxonomy data */ }
      });
      host.append(det);
    }
    card.append(host);
  } catch (e) { card.append(el("div", { class: "empty" }, e.message)); }
}

// dictionaries, first-seen lookup, eBird neighbourhood observations
async function renderExtras(card) {
  card.append(el("h2", {}, t("name_dictionaries")));
  try {
    const { locales = [] } = await api("/species/locales");
    const sel = el("select", {}, (locales || []).map((l) =>
      el("option", { value: l }, l)));
    card.append(el("div", { class: "row" }, sel,
      el("a", { class: "btn small", id: "dict-dl",
        href: `/api/v2/species/dictionary/${locales?.[0] || "en"}` },
        "⬇ " + t("download_dictionary"))));
    sel.addEventListener("change", () => {
      document.getElementById("dict-dl").href =
        `/api/v2/species/dictionary/${sel.value}`;
    });
  } catch (e) { card.append(el("div", { class: "empty" }, e.message)); }

  // first-seen lookup (lifetime / this year / this season)
  {
    const q = el("input", { placeholder: t("scientific_name_ph"), size: 26 });
    const out = el("span", { class: "sub" });
    card.append(el("h2", { style: "margin-top:14px" }, t("first_seen")),
      el("div", { class: "row" }, q,
        el("button", { class: "small", onclick: async () => {
          try {
            const fs = await api(`/species/first-seen/${
              encodeURIComponent(q.value.trim())}`);
            const d = (v) => v ? fmtTime(v) : "never";
            out.textContent = `lifetime ${d(fs.lifetime)} · year `
              + `${d(fs.this_year)} · season ${d(fs.this_season)}`;
          } catch (e) { out.textContent = e.message; }
        } }, t("search"))), out);
  }

  // eBird recent observations near the station (when integration enabled)
  try {
    const obs = await api("/ebird/observations");
    const rows = obs.observations || [];
    card.append(el("h2", { style: "margin-top:14px" }, "Nearby (eBird)"),
      rows.length
        ? table([t("species"), t("where"), t("when")], rows.slice(0, 10).map((o) => [
            o.comName || o.common_name || o.sciName,
            o.locName || o.location || "", o.obsDt || o.date || ""]))
        : el("div", { class: "empty" }, t("no_recent_observations")));
  } catch (e) { /* integration disabled */ }
}

// ------------------------------------------------------------------- imports

export async function importsView(outlet) {
  outlet.append(el("h1", {}, t("imports")));
  const path = el("input", { placeholder: "/path/to/BirdDB.txt", size: 40 });
  const jobsCard = el("div", { class: "card" });
  outlet.append(el("div", { class: "card" },
    el("h2", {}, "BirdNET-Pi import"),
    el("p", { class: "sub" },
       "Import detections from a BirdNET-Pi BirdDB.txt log."),
    el("div", { class: "row" }, path,
      el("button", { onclick: validate }, t("validate")),
      el("button", { class: "primary", onclick: start }, t("start_import")))),
    el("div", { class: "card" },
      el("h2", {}, "BirdNET-Go migration"),
      el("p", { class: "sub" },
         "Import a full BirdNET-Go database (detections, secondary "
         + "results, reviews, comments, locks)."),
      (() => {
        const db = el("input", { placeholder: "/path/to/birdnet.db",
                                 size: 40 });
        return el("div", { class: "row" }, db,
          el("button", { class: "primary", onclick: async () => {
            try {
              const out = await api("/imports/birdnet-go",
                { method: "POST", body: { path: db.value.trim() } });
              toast(`Imported ${out.imported} / ${out.scanned}`
                + ` (${out.skipped} skipped, ${out.errors} errors)`);
            } catch (e) { toast(e.message, true); }
          } }, t("migrate")));
      })()),
    jobsCard);
  await renderJobs();

  async function validate() {
    try {
      const out = await api("/imports/validate",
        { method: "POST", body: { path: path.value.trim() } });
      toast(out.valid
        ? `Looks good: ${out.rows ?? "?"} row(s) found`
        : `Invalid: ${out.error || "unrecognized format"}`, !out.valid);
    } catch (e) { toast(e.message, true); }
  }

  async function start() {
    try {
      await api("/imports/birdnet-pi",
                { method: "POST", body: { path: path.value.trim() } });
      toast(t("import_started"));
      renderJobs();
      // viewInterval: survives a failed poll (server restart mid-import)
      // and dies with the view instead of firing forever
      const timer = viewInterval(async () => {
        const { jobs = [] } = await api("/imports/jobs");
        renderJobs();
        if (!jobs.some((j) => j.status === "running"
                        || j.status === "pending")) clearInterval(timer);
      }, 1000);
    } catch (e) { toast(e.message, true); }
  }

  async function renderJobs() {
    const { jobs = [] } = await api("/imports/jobs");
    clear(jobsCard);
    jobsCard.append(el("h2", {}, t("jobs")));
    if (!jobs.length) {
      jobsCard.append(el("div", { class: "empty" }, t("no_data")));
      return;
    }
    jobsCard.append(table(
      ["#", t("path"), t("status"), t("imported"), t("skipped"), t("errors"), ""],
      jobs.map((j) => [String(j.id), j.path,
        el("span", { class: "pill " + (j.status === "completed" ? "good"
          : j.status === "failed" ? "bad" : "info") }, j.status),
        String(j.imported), String(j.skipped), String(j.errors),
        (j.status === "running" || j.status === "pending")
          ? el("button", { class: "small danger", onclick: async () => {
              await api(`/imports/jobs/${j.id}/cancel`, { method: "POST" });
              renderJobs();
            } }, t("cancel")) : ""])));
  }
}

// -------------------------------------------------------------------- shared

function debounce(fn, ms) {
  let h = null;
  return (...a) => { clearTimeout(h); h = setTimeout(() => fn(...a), ms); };
}

