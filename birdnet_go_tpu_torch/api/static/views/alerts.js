/* Alerts: rule editor (conditions + throttle + action), per-rule test,
   import/export, and the fired-alert history.
   Consumes /api/v2/alerts/* (reference: internal/alerting rules engine). */

import { api, el, clear, fmtTime, toast, t, table } from "../app.js";

export async function alertsView(outlet) {
  outlet.append(el("h1", {}, t("alerts")));

  const rulesCard = el("div", { class: "card" });
  const formCard = el("div", { class: "card" });
  const historyCard = el("div", { class: "card" });
  outlet.append(rulesCard, formCard, historyCard);

  await renderRules();
  renderForm();
  await renderHistory();

  // ---- rules table ----
  async function renderRules() {
    const rules = await api("/alerts/rules");
    clear(rulesCard);
    rulesCard.append(el("div", { class: "row" },
      el("h2", { style: "margin:0" }, t("rules")),
      el("span", { class: "spacer" }),
      el("a", { class: "btn small", href: "/api/v2/alerts/rules/export",
                download: "alert-rules.json" }, "⬇ " + t("export")),
      importButton()));
    if (!rules.length) {
      rulesCard.append(el("div", { class: "empty" },
        "No alert rules — create one below"));
      return;
    }
    rulesCard.append(table(
      [t("rule"), t("conditions"), t("throttle"), t("priority"), ""],
      rules.map((r) => [
        el("span", {},
          el("strong", {}, r.name || r.rule_id), " ",
          el("span", { class: "pill " + (r.enabled ? "good" : "") },
             r.enabled ? "on" : "off")),
        conditionSummary(r),
        `${Math.round(r.min_interval_seconds / 60)} min`,
        el("span", { class: "pill " + prioClass(r.priority) }, r.priority),
        el("div", { class: "row" },
          el("button", { class: "small", title: t("fire_test_detection"),
            onclick: async () => {
              try {
                const out = await api(`/alerts/rules/${r.rule_id}/test`,
                                      { method: "POST", body: {} });
                const hit = out.matched ?? out.fired;
                toast(hit ? `Fired: ${out.message || "matched"}`
                          : t("rule_no_match"), !hit);
                renderHistory();
              } catch (e) { toast(e.message, true); }
            } }, "▶ " + t("test")),
          el("button", { class: "small danger", onclick: async () => {
            try {
              await api(`/alerts/rules/${r.rule_id}`, { method: "DELETE" });
              toast(t("rule_deleted"));
              renderRules();
            } catch (e) { toast(e.message, true); }
          } }, "🗑"))])));
  }

  function conditionSummary(r) {
    const parts = [];
    if (r.species && r.species.length) parts.push(r.species.join(", "));
    if (r.min_confidence > 0)
      parts.push(`conf ≥ ${Math.round(r.min_confidence * 100)}%`);
    if (r.sources && r.sources.length)
      parts.push(`src: ${r.sources.join(",")}`);
    if (r.only_new_species) parts.push("new species only");
    if (r.active_window) parts.push(r.active_window);
    return parts.length ? parts.join(" · ") : "any detection";
  }

  function importButton() {
    const file = el("input", { type: "file", accept: ".json",
                               style: "display:none" });
    file.addEventListener("change", async () => {
      if (!file.files.length) return;
      try {
        const text = await file.files[0].text();
        const out = await api("/alerts/rules/import",
                              { method: "POST", body: JSON.parse(text) });
        toast(`${t("imported")}: ${out.imported ?? 0}`);
        renderRules();
      } catch (e) { toast(e.message, true); }
      file.value = "";
    });
    return el("span", {}, file,
      el("button", { class: "small", onclick: () => file.click() },
         "⬆ " + t("imports")));
  }

  // ---- create form ----
  function renderForm() {
    const name = el("input", { placeholder: t("rule_name"), size: 22 });
    const species = el("input",
      { placeholder: "Species globs (comma sep, empty = any)", size: 34 });
    const minConf = el("input", { type: "number", step: "0.05", min: 0,
                                  max: 1, value: "0.8", size: 6 });
    const interval = el("input", { type: "number", min: 0, value: "300",
                                   size: 7, title: "min seconds between fires" });
    const window_ = el("input", { placeholder: "HH:MM-HH:MM (optional)",
                                  size: 18 });
    const newOnly = el("input", { type: "checkbox" });
    const priority = el("select", {},
      ["low", "normal", "high", "critical"].map((p) =>
        el("option", { value: p, selected: p === "normal" ? "" : null }, p)));
    const template = el("input", {
      value: "{common_name} detected ({confidence:.0%})", size: 40 });
    // system-metric rule fields (resource monitor → threshold rules)
    const metric = el("select", {},
      ["", "cpu", "memory", "disk"].map((m) =>
        el("option", { value: m }, m || "(detections)")));
    const threshold = el("input", { type: "number", min: 0, max: 100,
                                    value: "90", size: 6 });
    const sustained = el("input", { type: "number", min: 0, value: "0",
                                    size: 7, title: "seconds above "
                                    + "threshold before firing" });
    formCard.append(el("h2", {}, t("new_rule")),
      el("div", { class: "field-row" },
        el("label", {}, t("metric")), metric),
      el("div", { class: "field-row" },
        el("label", {}, t("threshold_pct")), threshold),
      el("div", { class: "field-row" },
        el("label", {}, t("sustained_s")), sustained),
      el("div", { class: "field-row" }, el("label", {}, "name"), name),
      el("div", { class: "field-row" }, el("label", {}, "species"), species),
      el("div", { class: "field-row" },
        el("label", {}, "min confidence"), minConf),
      el("div", { class: "field-row" },
        el("label", {}, "throttle (s)"), interval),
      el("div", { class: "field-row" },
        el("label", {}, "active window"), window_),
      el("div", { class: "field-row" },
        el("label", {}, "new species only"), newOnly),
      el("div", { class: "field-row" }, el("label", {}, "priority"), priority),
      el("div", { class: "field-row" }, el("label", {}, "message"), template),
      el("div", { class: "row", style: "margin-top:8px" },
        el("button", { class: "primary", onclick: create }, t("create_rule"))));

    async function create() {
      if (!name.value.trim()) { toast(t("name_required"), true); return; }
      const body = {
        rule_id: name.value.trim().toLowerCase().replace(/\W+/g, "-"),
        name: name.value.trim(),
        species: species.value.split(",").map((s) => s.trim())
          .filter(Boolean),
        min_confidence: Number(minConf.value) || 0,
        min_interval_seconds: Number(interval.value) || 0,
        active_window: window_.value.trim(),
        only_new_species: newOnly.checked,
        priority: priority.value,
        message_template: template.value,
      };
      if (metric.value) {
        body.metric = metric.value;
        body.threshold = Number(threshold.value) || 0;
        body.sustained_seconds = Number(sustained.value) || 0;
        // a metric rule's default template is server-side; only send
        // the detection-shaped default if the user customized it
        if (template.value.includes("{common_name}"))
          delete body.message_template;
      }
      try {
        await api("/alerts/rules", { method: "POST", body });
        toast(t("rule_created"));
        renderRules();
      } catch (e) { toast(e.message, true); }
    }
  }

  // ---- history ----
  async function renderHistory() {
    const hist = await api("/alerts/history?limit=50");
    clear(historyCard);
    historyCard.append(el("h2", {}, t("history")));
    if (!hist.length) {
      historyCard.append(el("div", { class: "empty" }, t("no_data")));
      return;
    }
    historyCard.append(table([t("time"), t("rule"), t("message")],
      hist.slice().reverse().map((e) => [
        fmtTime(e.fired_at), e.rule_id, e.message])));
  }
}

function prioClass(p) {
  return p === "critical" ? "bad" : p === "high" ? "warn" : "info";
}

