/* Search view (#/search): complex ad-hoc queries over
   POST /detections/search, with named saved searches.
   Reference: frontend/src/lib/desktop/views/Search.svelte — text query,
   date range, confidence band (%), verified/locked status, device and
   time-of-day filters, multi-key sort, in-place review of results
   (Search.svelte:139-152), client-side range validation
   (Search.svelte:253, 407-409). Saved searches persist per browser. */

import { api, el, clear, fmtTime, confMeter, toast, t, viewQuery,
         confirmDialog, modal } from "../app.js";

/** Named saved searches, persisted in localStorage (per browser). */
class SavedSearches {
  constructor(storageKey) {
    this.key = storageKey;
  }

  list() {
    try {
      const raw = JSON.parse(localStorage.getItem(this.key) || "[]");
      return Array.isArray(raw) ? raw : [];
    } catch (e) { return []; }
  }

  save(name, filters) {
    const all = this.list().filter((s) => s.name !== name);
    all.push({ name, filters });
    all.sort((a, b) => a.name.localeCompare(b.name));
    localStorage.setItem(this.key, JSON.stringify(all));
  }

  remove(name) {
    localStorage.setItem(this.key,
      JSON.stringify(this.list().filter((s) => s.name !== name)));
  }
}

const store = new SavedSearches("saved_searches");

export async function searchView(outlet) {
  outlet.append(el("h1", {}, t("search")));

  const state = { limit: 50, offset: 0 };

  // ---- query form ----
  const query = el("input", { placeholder: t("search_query_ph"), size: 26 });
  const dateFrom = el("input", { type: "date" });
  const dateTo = el("input", { type: "date" });
  const confMin = el("input", { type: "number", min: 0, max: 100, size: 5,
                                placeholder: t("confidence") + " ≥ %" });
  const confMax = el("input", { type: "number", min: 0, max: 100, size: 5,
                                placeholder: t("confidence") + " ≤ %" });
  const verified = el("select", {},
    el("option", { value: "" }, t("any_review")),
    el("option", { value: "correct" }, t("correct")),
    el("option", { value: "false_positive" }, t("false_positive")),
    el("option", { value: "unreviewed" }, t("unreviewed")));
  const lockedSel = el("select", {},
    el("option", { value: "" }, t("any_lock_state")),
    el("option", { value: "true" }, t("lock")),
    el("option", { value: "false" }, t("unlock")));
  const todSel = el("select", {},
    el("option", { value: "" }, t("all_time")),
    el("option", { value: "dawn" }, t("tod_dawn")),
    el("option", { value: "day" }, t("tod_day")),
    el("option", { value: "dusk" }, t("tod_dusk")),
    el("option", { value: "night" }, t("tod_night")));
  const sourceSel = el("select", {}, el("option", { value: "" },
                                        t("any_source")));
  const modelSel = el("select", {}, el("option", { value: "" },
                                       t("any_model")));
  api("/system/audio/sources").then(({ sources }) => {
    for (const s of sources || []) {
      sourceSel.append(el("option", { value: s.source_id },
                          s.display_name || s.source_id));
    }
  }).catch(() => {});
  api("/models").then((res) => {
    const all = Array.isArray(res) ? res : res.models || [];
    for (const m of all) {
      modelSel.append(el("option", { value: m.model_id }, m.model_id));
    }
  }).catch(() => {});
  const sortSel = el("select", {},
    el("option", { value: "date_desc" }, t("newest_first")),
    el("option", { value: "date_asc" }, t("oldest_first")),
    el("option", { value: "species_asc" }, t("species") + " A→Z"),
    el("option", { value: "confidence_desc" }, t("confidence") + " ↓"));
  const searchBtn = el("button", { class: "primary" }, "🔍 " + t("search"));
  const resetBtn = el("button", {}, t("reset"));
  const saveBtn = el("button", {}, "★ " + t("save_search"));
  const exportBtn = el("button", {}, "⬇ " + t("export_csv"));
  outlet.append(el("div", { class: "filters" },
    query, dateFrom, "–", dateTo, confMin, confMax, verified, lockedSel,
    todSel, sourceSel, modelSel, sortSel, searchBtn, resetBtn, saveBtn,
    exportBtn));

  // ---- saved searches ----
  const savedWrap = el("div", { class: "chip-wrap",
                                style: "margin-bottom:8px" });
  outlet.append(savedWrap);

  const summary = el("p", { class: "sub" }, "");
  const resultsCard = el("div", { class: "card" });
  const pager = el("div", { class: "row" });
  outlet.append(summary, resultsCard, pager);

  function paintSaved() {
    clear(savedWrap);
    const all = store.list();
    if (!all.length) return;
    savedWrap.append(el("span", { class: "sub" },
                        t("saved_searches") + ": "));
    for (const s of all) {
      savedWrap.append(el("span", { class: "pill" },
        el("button", { class: "small", title: s.name,
          onclick: () => { setFilters(s.filters); state.offset = 0; run(); } },
          "★ " + s.name),
        el("button", { class: "icon",
          "aria-label": t("delete") + " " + s.name,
          onclick: async () => {
            if (!(await confirmDialog(
              `${t("delete")} "${s.name}" — ${t("are_you_sure")}`))) return;
            store.remove(s.name);
            paintSaved();
          } }, "✕")));
    }
  }
  paintSaved();

  function currentFilters() {
    const f = {};
    if (query.value.trim()) f.species = query.value.trim();
    if (dateFrom.value) f.from = dateFrom.value;
    if (dateTo.value) f.to = dateTo.value;
    if (confMin.value !== "") f.min_confidence = Number(confMin.value) / 100;
    if (confMax.value !== "") f.max_confidence = Number(confMax.value) / 100;
    if (verified.value) f.verified = verified.value;
    if (lockedSel.value) f.locked = lockedSel.value === "true";
    if (todSel.value) f.time_of_day = [todSel.value];
    if (sourceSel.value) f.source = sourceSel.value;
    if (modelSel.value) f.model = modelSel.value;
    if (sortSel.value !== "date_desc") f.sort_by = sortSel.value;
    return f;
  }

  function setFilters(f) {
    query.value = f.species || "";
    dateFrom.value = f.from || "";
    dateTo.value = f.to || "";
    confMin.value = f.min_confidence !== undefined
      ? String(Math.round(f.min_confidence * 100)) : "";
    confMax.value = f.max_confidence !== undefined
      ? String(Math.round(f.max_confidence * 100)) : "";
    verified.value = f.verified || "";
    lockedSel.value = f.locked === undefined ? "" : String(f.locked);
    todSel.value = (f.time_of_day && f.time_of_day[0]) || "";
    sourceSel.value = f.source || "";
    modelSel.value = f.model || "";
    sortSel.value = f.sort_by || "date_desc";
  }

  /** Client-side range validation (reference Search.svelte:253). */
  function validate() {
    if (confMin.value !== "" && confMax.value !== ""
        && Number(confMin.value) > Number(confMax.value)) {
      toast(t("conf_min_above_max"), true);
      return false;
    }
    if (dateFrom.value && dateTo.value && dateFrom.value > dateTo.value) {
      toast(t("date_start_after_end"), true);
      return false;
    }
    return true;
  }

  function syncHash() {
    const qs = new URLSearchParams();
    for (const [k, v] of Object.entries(currentFilters())) {
      qs.set(k, Array.isArray(v) ? v.join(",") : String(v));
    }
    const s = qs.toString();
    history.replaceState(null, "", `#/search${s ? "?" + s : ""}`);
  }

  async function run() {
    if (!validate()) return;
    syncHash();
    const body = { ...currentFilters(), limit: state.limit,
                   offset: state.offset };
    let detections, total;
    try {
      ({ detections = [], total = 0 } = await api("/detections/search",
                                                  { method: "POST", body }));
    } catch (e) { toast(e.message, true); return; }
    summary.textContent = `${total} · ${t("detections")}`;
    clear(resultsCard);
    clear(pager);
    if (!detections.length) {
      resultsCard.append(el("div", { class: "empty" }, t("no_data")));
      return;
    }
    const tb = el("tbody");
    for (const d of detections) tb.append(row(d));
    resultsCard.append(el("table", { class: "data" },
      el("thead", {}, el("tr", {},
        el("th", {}, t("date")),
        el("th", {}, t("species")),
        el("th", {}, t("confidence")),
        el("th", {}, t("source")),
        el("th", {}, ""))),
      tb));
    const last = state.offset + state.limit >= total;
    pager.append(
      el("button", { class: "small",
        disabled: state.offset === 0 ? "" : null,
        onclick: () => {
          state.offset = Math.max(0, state.offset - state.limit);
          run();
        } }, "‹ " + t("prev")),
      el("span", { class: "sub" },
         ` ${state.offset + 1}–${state.offset + detections.length} / ${total} `),
      el("button", { class: "small", disabled: last ? "" : null,
        onclick: () => { state.offset += state.limit; run(); } },
        t("next_page")));
  }

  function row(d) {
    const badge = d.verdict === "correct"
      ? el("span", { class: "pill good", style: "margin-left:6px" }, "✓")
      : d.verdict === "false_positive"
        ? el("span", { class: "pill bad", style: "margin-left:6px" }, "✗")
        : null;
    return el("tr", {},
      el("td", {}, fmtTime(d.timestamp)),
      el("td", {}, el("span", {},
        el("a", { href: `#/detection/${d.id}`, title: t("open_detail") },
           el("strong", {}, d.common_name || d.scientific_name)),
        " ",
        el("span", { class: "sub", style: "font-style:italic" },
           d.scientific_name),
        badge,
        d.locked ? el("span", { class: "pill", style: "margin-left:6px" },
                      "🔒") : null)),
      el("td", {}, confMeter(d.confidence)),
      el("td", {}, d.source_id),
      el("td", {}, el("div", { class: "row" },
        el("button", { class: "small", title: t("correct"),
          onclick: () => review(d.id, "correct") }, "✓"),
        el("button", { class: "small", title: t("false_positive"),
          onclick: () => review(d.id, "false_positive") }, "✗"))));
  }

  /** In-place review without losing the result page
      (Search.svelte:139-152). */
  async function review(id, verdict) {
    try {
      await api(`/detections/${id}/review`, { method: "POST",
                                              body: { verdict } });
      toast(`${t("review")}: ${verdict}`);
      run();
    } catch (e) { toast(e.message, true); }
  }

  /** Pages through the FULL result set of a filter (not just the visible
      page), one POST per 200 rows. The search endpoint is POST-only, so
      the export is client-side, unlike the detections browser's
      GET /detections/export link. */
  async function* allResults(filters, pageSize = 200) {
    let offset = 0;
    while (true) {
      const { detections = [], total = 0 } = await api("/detections/search",
        { method: "POST", body: { ...filters, limit: pageSize, offset } });
      for (const d of detections) yield d;
      offset += detections.length;
      if (!detections.length || offset >= total) return;
    }
  }

  const csvEsc = (v) => {
    const s = v === undefined || v === null ? "" : String(v);
    const needsQuote = s.includes(",") || s.includes('"')
      || s.includes("\n");
    return needsQuote ? '"' + s.split('"').join('""') + '"' : s;
  };

  exportBtn.addEventListener("click", async () => {
    if (!validate()) return;
    exportBtn.disabled = true;
    try {
      const lines = ["timestamp,common_name,scientific_name,confidence,"
                     + "source,verdict,locked"];
      for await (const d of allResults(currentFilters())) {
        lines.push([d.timestamp, d.common_name, d.scientific_name,
                    d.confidence, d.source_id, d.verdict || "",
                    d.locked ? "true" : "false"].map(csvEsc).join(","));
      }
      const url = URL.createObjectURL(
        new Blob([lines.join("\n") + "\n"], { type: "text/csv" }));
      const a = el("a", { href: url, download: "search-results.csv" });
      document.body.append(a);
      a.click();
      a.remove();
      URL.revokeObjectURL(url);
      toast(`${t("export_csv")}: ${lines.length - 1}`);
    } catch (e) { toast(e.message, true); }
    exportBtn.disabled = false;
  });

  searchBtn.addEventListener("click", () => { state.offset = 0; run(); });
  query.addEventListener("keydown", (ev) => {
    if (ev.key === "Enter") { state.offset = 0; run(); }
  });
  resetBtn.addEventListener("click", () => {
    setFilters({});
    state.offset = 0;
    history.replaceState(null, "", "#/search");
    clear(resultsCard);
    clear(pager);
    summary.textContent = "";
  });
  saveBtn.addEventListener("click", () => {
    const { body, close } = modal(t("save_search"));
    const nameInput = el("input", { placeholder: t("search_name_ph"),
                                    size: 24 });
    body.append(el("div", { class: "row" }, nameInput,
      el("button", { class: "primary", onclick: () => {
        if (!nameInput.value.trim()) return;
        store.save(nameInput.value.trim(), currentFilters());
        close();
        toast(t("saved"));
        paintSaved();
      } }, t("save"))));
    nameInput.focus();
  });

  // deep link: #/search?species=…&from=…  pre-fills and runs
  const q = viewQuery();
  if ([...q.keys()].length) {
    const f = {};
    if (q.has("species")) f.species = q.get("species");
    if (q.has("from")) f.from = q.get("from");
    if (q.has("to")) f.to = q.get("to");
    if (q.has("min_confidence")) f.min_confidence = Number(q.get("min_confidence"));
    if (q.has("max_confidence")) f.max_confidence = Number(q.get("max_confidence"));
    if (q.has("verified")) f.verified = q.get("verified");
    if (q.has("locked")) f.locked = q.get("locked") === "true";
    if (q.has("time_of_day")) f.time_of_day = q.get("time_of_day").split(",");
    if (q.has("source")) f.source = q.get("source");
    if (q.has("model")) f.model = q.get("model");
    if (q.has("sort_by")) f.sort_by = q.get("sort_by");
    setFilters(f);
    await run();
  }
}
