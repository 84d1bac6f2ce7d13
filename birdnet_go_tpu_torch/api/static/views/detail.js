/* Detection detail page (#/detection/{id}): hero identity card with
   confidence ring, taxonomy hierarchy, observation metadata (time of
   day, weather at the detection hour, download), a large synchronized
   spectrogram player with the window's other top-K candidates, and
   overview / notes / review tabs.
   Reference: frontend/src/lib/desktop/views/DetectionDetail.svelte
   (hero grid + taxonomy card + tabbed content). */

import { api, el, clear, fmtTime, fmtNum, toast, t,
         confirmDialog, weatherGlyph } from "../app.js";
import { spectrogramPlayer } from "./player.js";

export async function detectionDetailView(outlet, rest) {
  const id = Number(rest && rest[0]);
  if (!Number.isFinite(id) || id <= 0) {
    outlet.append(el("div", { class: "card empty" },
                     t("detection_not_found")));
    return;
  }
  let d;
  try {
    d = await api(`/detections/${id}`);
  } catch (e) {
    outlet.append(el("div", { class: "card empty" },
      e.status === 404 ? t("detection_not_found") : e.message));
    return;
  }

  outlet.append(el("div", { class: "row", style: "margin-bottom:8px" },
    el("a", { href: "#/detections", class: "sub" },
       "‹ " + t("detections"))));

  // ------------------------------------------------------------- hero grid
  const badges = el("div", { class: "chip-wrap" });
  const syncBadges = () => {
    clear(badges);
    if (d.verdict === "correct") {
      badges.append(el("span", { class: "pill good" },
                       "✓ " + t("correct")));
    } else if (d.verdict === "false_positive") {
      badges.append(el("span", { class: "pill bad" },
                       "✗ " + t("false_positive")));
    }
    if (d.locked) badges.append(el("span", { class: "pill" },
                                   "🔒 " + t("detection_locked")));
    if (d.nonbird_category) {
      badges.append(el("span", { class: "pill info" }, d.nonbird_category));
    }
  };
  syncBadges();

  const thumb = el("img", { loading: "lazy", alt: "",
    style: "width:72px;height:72px;border-radius:50%;object-fit:cover",
    src: `/api/v2/species/thumbnail?name=${
      encodeURIComponent(d.scientific_name)}` });
  thumb.addEventListener("error", () => thumb.remove());

  const identity = el("div", { class: "card", style: "flex:2" },
    el("div", { class: "row" },
      thumb,
      el("div", {},
        el("h1", { style: "margin:0" },
          el("a", { href: `#/species/${
              encodeURIComponent(d.scientific_name)}` },
             d.common_name || d.scientific_name)),
        el("em", { class: "sub" }, d.scientific_name),
        badges)),
    confRing(d.confidence));

  // taxonomy hierarchy (reference hero-taxonomy-card)
  const taxCard = el("div", { class: "card", style: "flex:1" },
    el("h2", {}, t("taxonomy")));
  api(`/species/taxonomy?name=${encodeURIComponent(d.scientific_name)}`)
    .then((tax) => {
      const ranks = [["class", tax.class], ["order", tax.order],
                     ["family", tax.family], ["genus", tax.genus],
                     ["species", d.scientific_name]].filter((r) => r[1]);
      ranks.forEach(([rank, value], i) => {
        taxCard.append(el("div", { style: `padding-left:${i * 14}px` },
          i ? "└ " : "",
          el("span", { class: "sub" }, t(rank) + ": "),
          rank === "species" ? el("em", {}, value) : value));
      });
    }).catch(() => {});

  // observation metadata (reference hero-metadata-card)
  const metaCard = el("div", { class: "card", style: "flex:1" },
    el("h2", {}, t("observation")));
  const todBadge = el("span", { class: "pill" });
  metaCard.append(
    el("div", {}, el("strong", {}, d.date), " ",
       el("span", {}, d.time), " ", todBadge),
    el("div", { class: "sub" },
       `${t("source")}: ${d.source_id || "–"}`),
    el("div", { class: "sub" }, `${t("model")}: ${d.model_id || "–"}`));
  api(`/detections/${id}/time-of-day`).then((tod) => {
    const icons = { day: "☀", night: "☾", sunrise: "🌅", sunset: "🌇",
                    dawn: "🌅", dusk: "🌇" };
    if (tod.phase) {
      todBadge.textContent = `${icons[tod.phase] || "☀"} ${tod.phase}`;
    } else todBadge.remove();
  }).catch(() => todBadge.remove());
  // weather conditions at the detection hour
  api(`/weather/hourly/${d.date}`).then((rows) => {
    const hr = Number(String(d.time).slice(0, 2));
    const w = (rows || []).find((r) =>
      new Date(r.time * 1000).getHours() === hr) || (rows || [])[0];
    if (!w) return;
    metaCard.append(el("div", { class: "sub" }, [
      `${weatherGlyph(w.icon)} ${w.description || ""}`.trim(),
      w.temperature != null ? `${Math.round(w.temperature)}°` : null,
      w.wind_speed != null ? `${t("wind")} ${w.wind_speed} m/s` : null,
      w.humidity != null ? `${t("humidity")} ${Math.round(w.humidity)}%`
                         : null,
    ].filter(Boolean).join(" · ")));
  }).catch(() => {});
  if (d.clip_name) {
    metaCard.append(el("a", { href: `/api/v2/audio/${id}`,
                              download: `detection_${id}.wav` },
                       "⬇ " + t("download")));
  }

  outlet.append(el("div", { class: "row",
                            style: "align-items:stretch;gap:12px" },
                   identity, taxCard, metaCard));

  // ------------------------------------------------------------ media card
  const player = spectrogramPlayer(id, { size: "lg" });
  const others = el("div", { class: "chip-wrap", style: "margin-top:6px" });
  api(`/detections/${id}/results`).then(({ results }) => {
    const rest2 = (results || []).slice(1, 9);
    if (!rest2.length) return;
    others.append(el("span", { class: "sub" },
                     t("other_candidates") + ": "));
    for (const r of rest2) {
      others.append(el("span", { class: "pill", title: r.scientific_name },
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
  } }, "↻");
  outlet.append(el("div", { class: "card" },
    el("div", { class: "row" }, el("h2", {}, t("spectrogram")), regen),
    player, others));

  // ------------------------------------------------------------------ tabs
  const tabBar = el("div", { class: "row", role: "tablist" });
  const panel = el("div", {});
  const tabs = {
    overview: renderOverview,
    notes: renderNotes,
    review: renderReview,
  };
  let active = tabs[rest && rest[1]] ? rest[1] : "overview";
  for (const name of Object.keys(tabs)) {
    const b = el("button", { class: "small", role: "tab",
                             "data-tab": name,
                             onclick: () => show(name) }, t(name));
    tabBar.append(b);
  }
  outlet.append(el("div", { class: "card" }, tabBar, panel));
  function show(name) {
    active = name;
    tabBar.querySelectorAll("button").forEach((b) =>
      b.classList.toggle("primary", b.dataset.tab === name));
    clear(panel);
    tabs[name](panel);
  }
  show(active);

  // --- overview: species tracking + station stats + model contributions
  async function renderOverview(host) {
    const grid = el("div", { class: "row",
                             style: "align-items:flex-start;gap:16px" });
    host.append(grid);
    const trackBox = el("div", { style: "flex:1" },
                        el("h3", {}, t("first_seen")));
    const statBox = el("div", { style: "flex:1" },
                       el("h3", {}, t("species")));
    grid.append(trackBox, statBox);
    api(`/species/first-seen/${encodeURIComponent(d.scientific_name)}`)
      .then((fs) => {
        const row = (label, value) =>
          el("div", { class: "sub" }, `${label}: ${value}`);
        if (fs.lifetime) {
          const days = Math.floor(
            (Date.now() - new Date(fs.lifetime).getTime()) / 86400e3);
          trackBox.append(row(t("first_seen"), fs.lifetime));
          if (fs.lifetime === d.date) {
            trackBox.append(el("span", { class: "pill good" },
                               "★ " + t("new_species")));
          }
          if (Number.isFinite(days) && days >= 0) trackBox.append(
            row(t("days_since_first"), String(days)));
        }
        if (fs.this_year === d.date) {
          trackBox.append(el("span", { class: "pill info" },
                             t("new_this_year")));
        }
        if (fs.this_season === d.date) {
          trackBox.append(el("span", { class: "pill info" },
                             t("new_this_season")));
        }
        if (!trackBox.querySelector(".sub, .pill")) {
          trackBox.append(el("div", { class: "empty" }, t("no_data")));
        }
      }).catch(() =>
        trackBox.append(el("div", { class: "empty" }, t("no_data"))));
    api("/species").then(({ species }) => {
      const mine = (species || []).find(
        (s) => s.scientific_name === d.scientific_name);
      if (!mine) return;
      statBox.append(
        el("div", { class: "sub" }, `${t("total")}: ${fmtNum(mine.count)}`),
        el("div", { class: "sub" },
           `${t("max_conf")}: ${Math.round((mine.max_confidence || 0) * 100)}%`),
        el("div", { class: "sub" },
           `${t("last_seen")}: ${mine.last_seen
             ? fmtTime(mine.last_seen) : "–"}`));
    }).catch(() => {});
    if (d.contributions && d.contributions.length) {
      host.append(el("h3", {}, t("model")),
        el("div", { class: "chip-wrap" },
          d.contributions.map((c) => el("span", { class: "pill",
            title: `${c.hit_count}×` },
            `${c.model_id} ${Math.round(c.max_confidence * 100)}%`))));
    }
  }

  // --- notes: comment thread (reference notesTab)
  async function renderNotes(host) {
    let commentList = [];
    try {
      ({ comments: commentList = [] } = await api(`/detections/${id}/comments`));
    } catch (e) { /* empty thread */ }
    const list = el("div", {});
    const paint = () => {
      clear(list);
      if (!commentList.length) {
        list.append(el("div", { class: "empty" }, t("no_data")));
        return;
      }
      for (const c of commentList) {
        list.append(el("div", { style: "margin-bottom:6px" },
          el("div", {}, c.text),
          el("div", { class: "sub" }, fmtTime(c.created_at))));
      }
    };
    paint();
    const input = el("input", { placeholder: t("add_comment_ph"),
                                size: 48 });
    host.append(el("div", { class: "row" }, input,
      el("button", { class: "small primary", onclick: async () => {
        const text = input.value.trim();
        if (!text) return;
        try {
          await api(`/detections/${id}/comments`,
                    { method: "POST", body: { text } });
        } catch (e) { toast(e.message, true); return; }
        input.value = "";
        ({ comments: commentList } =
          await api(`/detections/${id}/comments`));
        paint();
      } }, t("save"))), list);
  }

  // --- review: verdict + comment + lock + delete (reference ReviewCard)
  async function renderReview(host) {
    const comment = el("input", { placeholder: t("add_comment_ph"),
                                  size: 40 });
    const verdictRow = (verdict, label, cls) =>
      el("button", { class: "small " + cls, onclick: async () => {
        try {
          await api(`/detections/${id}/review`, { method: "POST",
            body: { verdict, comment: comment.value.trim() } });
          d.verdict = verdict;
          syncBadges();
          toast(`${t("review")}: ${label}`);
          show("review");
        } catch (e) { toast(e.message, true); }
      } }, label);
    host.append(
      el("div", { class: "row" }, comment,
         verdictRow("correct", "✓ " + t("correct"), "primary"),
         verdictRow("false_positive", "✗ " + t("false_positive"), "danger")),
      el("div", { class: "row", style: "margin-top:8px" },
        el("button", { class: "small", onclick: async () => {
          try {
            if (d.locked) {
              await api(`/detections/${id}/lock`, { method: "DELETE" });
            } else {
              await api(`/detections/${id}/lock`,
                        { method: "POST", body: { locked: true } });
            }
            d.locked = !d.locked;
            syncBadges();
            show("review");
          } catch (e) { toast(e.message, true); }
        } }, d.locked ? "🔓 " + t("unlock") : "🔒 " + t("lock")),
        el("button", { class: "small danger", onclick: async () => {
          if (!(await confirmDialog(
            `${t("delete")} — ${t("are_you_sure")}`))) return;
          try {
            await api(`/detections/${id}`, { method: "DELETE" });
            toast(t("deleted"));
            location.hash = "#/detections";
          } catch (e) {
            toast(e.status === 409 ? t("detection_locked") : e.message,
                  true);
          }
        } }, "🗑 " + t("delete"))));
    // review history
    try {
      const { reviews = [] } = await api(`/detections/${id}/reviews`);
      if (reviews && reviews.length) {
        host.append(el("h3", {}, t("history")),
          el("div", {}, reviews.map((r) => el("div", { class: "sub" },
            `${r.verdict === "correct" ? "✓" : "✗"} ${t(r.verdict)}`
            + `${r.comment ? ` — ${r.comment}` : ""}`
            + ` · ${fmtTime(r.created_at)}`))));
      }
    } catch (e) { /* no history */ }
  }
}

/** SVG confidence ring (reference ConfidenceCircle.svelte). */
function confRing(conf) {
  const pct = Math.round((conf || 0) * 100);
  const r = 30, c = 2 * Math.PI * r;
  const ring = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  ring.setAttribute("viewBox", "0 0 72 72");
  ring.setAttribute("width", "72");
  ring.setAttribute("height", "72");
  ring.setAttribute("role", "img");
  ring.setAttribute("aria-label", `${t("confidence")} ${pct}%`);
  const mk = (cls, dash) => {
    const el2 = document.createElementNS(
      "http://www.w3.org/2000/svg", "circle");
    el2.setAttribute("cx", "36"); el2.setAttribute("cy", "36");
    el2.setAttribute("r", String(r));
    el2.setAttribute("fill", "none");
    el2.setAttribute("stroke-width", "7");
    el2.setAttribute("class", cls);
    if (dash) {
      el2.setAttribute("stroke-dasharray",
                       `${(pct / 100) * c} ${c}`);
      el2.setAttribute("transform", "rotate(-90 36 36)");
      el2.setAttribute("stroke-linecap", "round");
    }
    return el2;
  };
  ring.append(mk("ring-track"), mk(pct >= 80 ? "ring-good"
    : pct >= 50 ? "ring-mid" : "ring-low", true));
  const label = document.createElementNS(
    "http://www.w3.org/2000/svg", "text");
  label.setAttribute("x", "36"); label.setAttribute("y", "41");
  label.setAttribute("text-anchor", "middle");
  label.setAttribute("class", "ring-label");
  label.textContent = `${pct}%`;
  ring.append(label);
  return el("div", { class: "row", style: "margin-top:8px" }, ring);
}
