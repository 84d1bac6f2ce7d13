/* Detections browser: advanced search filters, paging, per-row review /
   lock / delete / comments / audio, and bulk actions over a selection. */

import { api, el, clear, fmtTime, confMeter, toast, t, isoDaysAgo,
         confirmDialog, viewQuery } from "../app.js";
import { spectrogramPlayer } from "./player.js";

export async function detectionsView(outlet) {
  outlet.append(el("h1", {}, t("detections")));

  const state = { limit: 50, offset: 0, filters: {} };

  // ---- filter row (date range first) ----
  const range = el("select", {},
    el("option", { value: "7" }, t("last7")),
    el("option", { value: "1" }, t("today")),
    el("option", { value: "30" }, t("last30")),
    el("option", { value: "" }, t("all_time")),
    el("option", { value: "custom" }, t("custom_range")));
  // explicit date range, shown only for the custom preset — full parity
  // with POST /detections/search's from/to
  const dateFrom = el("input", { type: "date", title: t("date") + " ≥" });
  const dateTo = el("input", { type: "date", title: t("date") + " ≤" });
  const customWrap = el("span", { class: "row", style: "display:none" },
                        dateFrom, "–", dateTo);
  range.addEventListener("change", () => {
    customWrap.style.display = range.value === "custom" ? "" : "none";
  });
  const species = el("input", { placeholder: t("species"), size: 18 });
  const minConf = el("input", { placeholder: t("confidence") + " ≥",
                                size: 7,
                                type: "number", step: "0.05", min: 0, max: 1 });
  const maxConf = el("input", { placeholder: t("confidence") + " ≤",
                                size: 7,
                                type: "number", step: "0.05", min: 0, max: 1 });
  const hourFrom = el("input", { type: "number", min: 0, max: 23, size: 4,
                                 placeholder: t("hour_from") });
  const hourTo = el("input", { type: "number", min: 0, max: 23, size: 4,
                               placeholder: t("hour_to") });
  const verified = el("select", {},
    el("option", { value: "" }, t("any_review")),
    el("option", { value: "correct" }, t("correct")),
    el("option", { value: "false_positive" }, t("false_positive")),
    el("option", { value: "unreviewed" }, t("unreviewed")));
  const lockedSel = el("select", {},
    el("option", { value: "" }, t("any_lock_state")),
    el("option", { value: "true" }, t("lock")),
    el("option", { value: "false" }, t("unlock")));
  // multi-key sort (search_advanced.go SortBy vocabulary)
  const orderSel = el("select", {},
    el("option", { value: "date_desc" }, t("newest_first")),
    el("option", { value: "date_asc" }, t("oldest_first")),
    el("option", { value: "species_asc" }, t("species") + " A→Z"),
    el("option", { value: "species_desc" }, t("species") + " Z→A"),
    el("option", { value: "confidence_desc" }, t("confidence") + " ↓"),
    el("option", { value: "confidence_asc" }, t("confidence") + " ↑"));
  // time-of-day band chips (search_advanced.go:282-317 dawn/day/dusk/
  // night approximation bands)
  const todSel = new Set();
  const todWrap = el("span", { class: "row" },
    [["dawn", "🌅"], ["day", "☀️"], ["dusk", "🌇"], ["night", "🌙"]]
      .map(([band, glyph]) => {
        const b = el("button", { class: "small", title: t("tod_" + band) },
                     glyph);
        b.addEventListener("click", () => {
          if (todSel.has(band)) { todSel.delete(band); b.classList.remove("primary"); }
          else { todSel.add(band); b.classList.add("primary"); }
          state.offset = 0;
          load();
        });
        return b;
      }));
  const sourceSel = el("select", {}, el("option", { value: "" },
                                        t("any_source")));
  const modelSel = el("select", {}, el("option", { value: "" },
                                       t("any_model")));
  // populate source/model dropdowns from the running config
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
  const applyBtn = el("button", { class: "primary" }, t("apply"));
  // CSV export of the current filter set (the reference's import-export
  // page lists this as "coming soon"; GET /detections/export serves it)
  const exportBtn = el("button", { class: "small", onclick: () => {
    const qs = new URLSearchParams();
    for (const [k, v] of Object.entries(currentFilters())) {
      qs.set(k, String(v));
    }
    qs.set("format", "csv");
    window.open(`/api/v2/detections/export?${qs}`, "_blank");
  } }, "⬇ " + t("export_csv"));
  // table ⇄ card layout toggle (reference DetectionsCardView.svelte),
  // sticky per browser
  let viewMode = localStorage.getItem("det_view") || "table";
  const modeBtn = el("button", { class: "small", onclick: () => {
    viewMode = viewMode === "table" ? "cards" : "table";
    localStorage.setItem("det_view", viewMode);
    paintModeBtn();
    load();
  } });
  const paintModeBtn = () => {
    modeBtn.textContent = viewMode === "table" ? "▦" : "☰";
    modeBtn.title = viewMode === "table" ? t("card_view") : t("table_view");
  };
  paintModeBtn();
  outlet.append(el("div", { class: "filters" },
    range, customWrap, species, minConf, maxConf, hourFrom, hourTo,
    todWrap, verified, lockedSel, orderSel, sourceSel, modelSel,
    applyBtn, exportBtn, modeBtn));

  // ---- bulk bar ----
  const bulkInfo = el("span", { class: "sub" }, "");
  const bulkBar = el("div", { class: "row", style: "margin-bottom:8px" },
    el("button", { class: "small", onclick: () => bulk("review", "correct") },
       "✓ " + t("correct")),
    el("button", { class: "small",
                   onclick: () => bulk("review", "false_positive") },
       "✗ " + t("false_positive")),
    el("button", { class: "small", onclick: () => bulk("lock") },
       "🔒 " + t("lock")),
    el("button", { class: "small", onclick: () => bulk("unlock") },
       "🔓 " + t("unlock")),
    el("button", { class: "small danger", onclick: () => bulk("delete") },
       t("delete")),
    bulkInfo);
  bulkBar.style.display = "none";
  outlet.append(bulkBar);

  const tableCard = el("div", { class: "card" });
  const pager = el("div", { class: "row" });
  outlet.append(tableCard, pager);

  applyBtn.addEventListener("click", () => { state.offset = 0; load(); });

  // deep links (#/detections?species=…&date=…&hour=…) pre-fill the
  // filters — analytics charts drill straight into the matching slice
  const q = viewQuery();
  if (q.has("species")) species.value = q.get("species");
  if (q.has("date")) {
    range.value = "custom";
    customWrap.style.display = "";
    dateFrom.value = q.get("date");
    dateTo.value = q.get("date");
  }
  if (q.has("from")) {
    range.value = "custom";
    customWrap.style.display = "";
    dateFrom.value = q.get("from");
    if (q.has("to")) dateTo.value = q.get("to");
  }
  if (q.has("hour")) {
    hourFrom.value = q.get("hour");
    hourTo.value = q.get("hour");
  }
  if (q.has("hour_from")) hourFrom.value = q.get("hour_from");
  if (q.has("hour_to")) hourTo.value = q.get("hour_to");
  if (q.has("min_confidence")) minConf.value = q.get("min_confidence");
  if (q.has("max_confidence")) maxConf.value = q.get("max_confidence");
  if (q.has("locked")) lockedSel.value = q.get("locked");
  if (q.has("sort_by")) orderSel.value = q.get("sort_by");
  if (q.has("source")) sourceSel.value = q.get("source");
  if (q.has("time_of_day")) {
    for (const band of q.get("time_of_day").split(",")) {
      if (band) todSel.add(band);
    }
    todWrap.querySelectorAll("button").forEach((b, i) => {
      const band = ["dawn", "day", "dusk", "night"][i];
      b.classList.toggle("primary", todSel.has(band));
    });
  }
  await load();

  function currentFilters() {
    const f = {};
    if (range.value === "custom") {
      if (dateFrom.value) f.from = dateFrom.value;
      if (dateTo.value) f.to = dateTo.value;
    } else if (range.value) {
      f.from = isoDaysAgo(Number(range.value) - 1);
    }
    if (species.value.trim()) f.species = species.value.trim();
    if (minConf.value) f.min_confidence = Number(minConf.value);
    if (maxConf.value) f.max_confidence = Number(maxConf.value);
    if (hourFrom.value !== "") f.hour_from = Number(hourFrom.value);
    if (hourTo.value !== "") f.hour_to = Number(hourTo.value);
    if (verified.value) f.verified = verified.value;
    if (lockedSel.value) f.locked = lockedSel.value === "true";
    if (todSel.size) f.time_of_day = [...todSel];
    f.sort_by = orderSel.value;
    if (sourceSel.value) f.source = sourceSel.value;
    if (modelSel.value) f.model = modelSel.value;
    return f;
  }

  function selectedIds() {
    return [...tableCard.querySelectorAll("input.sel:checked")]
      .map((c) => Number(c.value));
  }

  // one round trip per action via the batch endpoints
  // (detections_batch.go); locked rows come back as `skipped`
  async function bulk(action, verdict) {
    const ids = selectedIds().map(String);
    if (!ids.length) return;
    if (action === "delete"
        && !(await confirmDialog(
          `${t("delete")} ${ids.length} — ${t("are_you_sure")}`))) return;
    try {
      let res;
      if (action === "delete")
        res = await api("/detections/batch/delete",
                        { method: "POST", body: { ids } });
      else if (action === "review")
        res = await api("/detections/batch/review",
                        { method: "POST", body: { ids, verified: verdict } });
      else
        res = await api("/detections/batch/lock",
                        { method: "POST",
                          body: { ids, locked: action === "lock" } });
      toast(`✓ ${res.processed}${res.skipped
            ? ` · ${res.skipped} ⏭` : ""}`, false);
    } catch (e) { toast(e.message, true); }
    load();
  }

  function syncHash() {
    const qs = new URLSearchParams();
    for (const [k, v] of Object.entries(currentFilters())) {
      if (k === "sort_by" && v === "date_desc") continue;
      qs.set(k, Array.isArray(v) ? v.join(",") : String(v));
    }
    const s = qs.toString();
    // replaceState: updates the shareable URL without firing hashchange
    history.replaceState(null, "", `#/detections${s ? "?" + s : ""}`);
  }

  async function load() {
    syncHash();
    const body = { ...currentFilters(), limit: state.limit,
                   offset: state.offset };
    let detections, count, total;
    try {
      ({ detections = [], count = 0, total = 0 } = await api("/detections/search",
                                                { method: "POST", body }));
    } catch (e) { toast(e.message, true); return; }
    // a re-render detaches players — a detached HTMLMediaElement keeps
    // playing with no visible controls, so stop ALL audio first
    tableCard.querySelectorAll(".spec-player").forEach(
      (p) => p.stopPlayback?.());
    tableCard.querySelectorAll("audio").forEach((a) => a.pause());
    clear(tableCard);
    if (!detections.length) {
      tableCard.append(el("div", { class: "empty" }, t("no_data")));
      bulkBar.style.display = "none";
      return;
    }
    if (viewMode === "cards") {
      bulkBar.style.display = "none";
      const grid = el("div", { class: "det-cards" });
      for (const d of detections) grid.append(cardFor(d));
      tableCard.append(grid);
      paintPager(detections, count, total);
      return;
    }
    const selAll = el("input", { type: "checkbox" });
    selAll.addEventListener("change", () => {
      tableCard.querySelectorAll("input.sel").forEach(
        (c) => { c.checked = selAll.checked; });
      syncBulk();
    });
    const tbl = el("table", { class: "data" },
      el("thead", {}, el("tr", {},
        el("th", {}, selAll),
        el("th", {}, t("date")),
        el("th", {}, t("species")),
        el("th", {}, t("confidence")),
        el("th", {}, t("source")),
        el("th", {}, t("audio")),
        el("th", {}, ""))));
    const tb = el("tbody");
    for (const d of detections) tb.append(row(d));
    tbl.append(tb);
    tableCard.append(tbl);
    paintPager(detections, count, total);
    syncBulk();
  }

  function paintPager(detections, count, total) {
    clear(pager);
    const known = typeof total === "number";
    const last = known && state.offset + state.limit >= total;
    pager.append(
      el("button", { class: "small", disabled: state.offset === 0 ? "" : null,
        onclick: () => { state.offset = Math.max(0, state.offset - state.limit); load(); } },
        "‹ " + t("prev")),
      el("span", { class: "sub" },
         ` ${state.offset + 1}–${state.offset + detections.length}`
         + (known ? ` / ${total} ` : " ")),
      el("button", { class: "small",
        disabled: (known ? last : count < state.limit) ? "" : null,
        onclick: () => { state.offset += state.limit; load(); } }, t("next_page")));
  }

  /** Card-grid rendering of one detection (reference DetectionCard). */
  function cardFor(d) {
    const img = el("img", { class: "spec", loading: "lazy", alt: "",
      src: d.clip_name ? `/api/v2/spectrogram/${d.id}?size=sm`
        : `/api/v2/species/thumbnail?name=${
            encodeURIComponent(d.scientific_name)}` });
    img.addEventListener("error", () => img.remove());
    return el("div", { class: "det-card" },
      img,
      el("div", { class: "body" },
        el("div", { class: "common" },
          el("a", { href: `#/detection/${d.id}`, title: t("open_detail") },
             d.common_name || d.scientific_name),
          d.verdict === "correct"
            ? el("span", { class: "pill good", style: "margin-left:6px" },
                 "✓") : null,
          d.verdict === "false_positive"
            ? el("span", { class: "pill bad", style: "margin-left:6px" },
                 "✗") : null),
        el("div", { class: "sci" }, d.scientific_name),
        el("div", { class: "meta" },
           confMeter(d.confidence), " · ", fmtTime(d.timestamp)),
        el("div", { class: "row", style: "margin-top:6px" },
          el("button", { class: "small", title: t("correct"),
            onclick: () => review(d.id, "correct") }, "✓"),
          el("button", { class: "small", title: t("false_positive"),
            onclick: () => review(d.id, "false_positive") }, "✗"),
          d.clip_name ? el("audio", { controls: "", preload: "none",
            style: "height:24px;flex:1",
            src: `/api/v2/audio/${d.id}` }) : null)));
  }

  function syncBulk() {
    const n = selectedIds().length;
    bulkBar.style.display = n ? "" : "none";
    bulkInfo.textContent = `${n} selected`;
  }

  function row(d) {
    const sel = el("input", { class: "sel", type: "checkbox", value: d.id });
    sel.addEventListener("change", syncBulk);
    const actions = el("td", {}, el("div", { class: "row" },
      el("a", { class: "small", title: t("open_detail"),
                href: `#/detection/${d.id}` }, "↗"),
      el("button", { class: "small", title: t("correct"),
        onclick: () => review(d.id, "correct") }, "✓"),
      el("button", { class: "small", title: t("false_positive"),
        onclick: () => review(d.id, "false_positive") }, "✗"),
      el("button", { class: "small",
        title: d.locked ? t("unlock") : t("lock"),
        onclick: () => toggleLock(d) }, d.locked ? "🔓" : "🔒"),
      el("button", { class: "small", title: t("spectrogram"),
        onclick: (ev) => spectro(ev.target.closest("tr"), d.id) }, "∿"),
      el("button", { class: "small", title: t("comments"),
        onclick: (ev) => comments(ev.target.closest("tr"), d.id) }, "💬"),
      el("button", { class: "small danger", title: t("delete"),
        onclick: () => del(d.id) }, "🗑")));
    return el("tr", {},
      el("td", {}, sel),
      el("td", {}, fmtTime(d.timestamp)),
      el("td", {}, el("span", {},
        el("strong", {}, d.common_name || ""), " ",
        el("span", { class: "sub", style: "font-style:italic" },
           d.scientific_name),
        d.nonbird_category
          ? el("span", { class: "pill info", style: "margin-left:6px" },
               d.nonbird_category)
          : null,
        // verification + lock badges (reference VerificationBadges.svelte)
        d.verdict === "correct"
          ? el("span", { class: "pill good", style: "margin-left:6px",
                         title: t("review") }, "✓ " + t("correct"))
          : null,
        d.verdict === "false_positive"
          ? el("span", { class: "pill bad", style: "margin-left:6px",
                         title: t("review") }, "✗ " + t("false_positive"))
          : null,
        d.locked
          ? el("span", { class: "pill", style: "margin-left:6px",
                         title: t("detection_locked") }, "🔒")
          : null)),
      el("td", {}, confMeter(d.confidence)),
      el("td", {}, d.source_id),
      el("td", {}, d.clip_name
        ? el("div", { class: "row" },
            // inline thumbnail (reference MiniSpectrogram.svelte);
            // click expands the full synced player drawer
            (() => {
              const mini = el("img", { loading: "lazy", alt: "",
                class: "mini-spec",
                title: t("spectrogram"),
                src: `/api/v2/spectrogram/${d.id}?size=sm` });
              mini.addEventListener("error", () => mini.remove());
              mini.addEventListener("click",
                (ev) => spectro(ev.target.closest("tr"), d.id));
              return mini;
            })(),
            el("audio", { controls: "", preload: "none",
                          style: "height:26px;width:170px",
                          src: `/api/v2/audio/${d.id}` }))
        : el("span", { class: "sub" }, "–")),
      actions);
  }

  async function review(id, verdict) {
    try {
      await api(`/detections/${id}/review`, { method: "POST",
                                              body: { verdict } });
      toast(`${t("review")}: ${verdict}`);
      load();            // refresh so the verification badge appears
    } catch (e) { toast(e.message, true); }
  }

  async function toggleLock(d) {
    try {
      if (d.locked) {
        await api(`/detections/${d.id}/lock`, { method: "DELETE" });
      } else {
        await api(`/detections/${d.id}/lock`,
                  { method: "POST", body: { locked: true } });
      }
    } catch (e) { toast(e.message, true); return; }
    d.locked = !d.locked;
    load();
  }

  async function del(id) {
    if (!(await confirmDialog(`${t("delete")} — ${t("are_you_sure")}`)))
      return;
    try {
      await api(`/detections/${id}`, { method: "DELETE" });
      toast(t("deleted"));
      load();
    } catch (e) {
      toast(e.status === 409 ? t("detection_locked") : e.message, true);
    }
  }

  function spectro(tr, id) {
    const existing = tr.nextElementSibling;
    if (existing && existing.classList.contains("spectro-row")) {
      existing.querySelector(".spec-player")?.stopPlayback?.();
      existing.remove();
      return;
    }
    // playhead-synced spectrogram + audio (reference SpectrogramPlayer)
    const player = spectrogramPlayer(id);
    const meta = el("span", { class: "sub" });
    api(`/detections/${id}/time-of-day`).then((tod) => {
      meta.textContent = tod.phase ? `☀ ${tod.phase}` : "";
    }).catch(() => {});
    // secondary predictions: the window's other top-K candidates
    const others = el("div", { class: "chip-wrap",
                              style: "margin-bottom:6px" });
    api(`/detections/${id}/results`).then(({ results }) => {
      for (const r of (results || []).slice(1, 8)) {
        others.append(el("span", { class: "pill",
          title: r.scientific_name },
          `${r.common_name || r.scientific_name} `
          + `${Math.round(r.confidence * 100)}%`));
      }
    }).catch(() => {});
    const regen = el("button", { class: "small", onclick: async () => {
      try {
        await api(`/spectrogram/${id}/generate`, { method: "POST", body: {} });
        player.refreshSpectrogram();
        toast(t("spectrogram_regenerated"));
      } catch (e) { toast(e.message, true); }
    } }, "↻ " + t("regenerate"));
    tr.after(el("tr", { class: "spectro-row" },
      el("td", { colspan: 7 },
        el("div", { class: "row", style: "margin-bottom:6px" }, regen, meta),
        others, player)));
  }

  async function comments(tr, id) {
    // toggle by id, not by adjacency — an open spectrogram row may sit
    // between tr and the panel, which used to stack duplicate panels
    const existing = tr.closest("table")
      .querySelector(`tr.comment-row[data-for="${id}"]`);
    if (existing) {
      existing.remove();
      return;
    }
    // NB: don't destructure into `comments` — it would shadow this
    // function for the whole body (the Add button re-renders via it)
    const [{ comments: commentList }, { reviews }] = await Promise.all([
      api(`/detections/${id}/comments`),
      api(`/detections/${id}/reviews`).catch(() => ({ reviews: [] }))]);
    const input = el("input", { placeholder: t("add_comment_ph"), size: 40 });
    const list = el("div", {},
      reviews.map((r) => el("div", { class: "sub" },
        `✓ ${r.verdict}${r.comment ? ` — ${r.comment}` : ""}`)),
      commentList.map((c) =>
        el("div", { class: "sub" }, `• ${c.text}`)));
    const addBtn = el("button", { class: "small primary", onclick: async () => {
      if (!input.value.trim()) return;
      try {
        await api(`/detections/${id}/comments`,
                  { method: "POST", body: { text: input.value.trim() } });
      } catch (e) { toast(e.message, true); return; }
      input.value = "";
      // remove OUR panel row specifically (a spectrogram row may sit
      // between tr and the comment row)
      commentRow.remove();
      comments(tr, id);
    } }, t("add"));
    const cell = el("td", { colspan: 7 },
      el("div", { class: "row" }, input, addBtn), list);
    const commentRow = el("tr", { class: "comment-row",
                                  "data-for": String(id) }, cell);
    tr.after(commentRow);
  }
}

