/* Settings UI: form sections generated from GET /settings, PATCHed per
   section (server merges + emits the matching hot-reload control signals). */

import { api, el, toast, t, setLang, lang, LANGS } from "../app.js";

const SECTION_ORDER = [
  "location", "models", "realtime", "export", "range_filter",
  "privacy_filter", "dog_bark_filter", "daylight_filter",
  "ultrasonic_filter", "dynamic_threshold", "deep_detection", "species",
  "soundlevel", "webserver", "database", "mqtt", "birdweather", "weather",
  "notification", "alerting", "retention", "backup", "liveness",
];

export async function settingsView(outlet) {
  outlet.append(el("h1", {}, t("settings")));
  outlet.append(el("div", { class: "row", style: "margin-bottom:12px" },
    el("span", { class: "sub" }, t("language")),
    el("select", { onchange: (e) => setLang(e.target.value) },
      LANGS.map((c) => el("option",
        { value: c, selected: c === lang ? "" : null }, c))),
    el("button", { class: "right",
      onclick: () => document.documentElement.dataset.theme =
        document.documentElement.dataset.theme === "dark" ? "light" : "dark" },
      "◐ " + t("theme"))));

  const settings = await api("/settings");
  // JSON schema (types + defaults) drives tooltips and default hints
  let schema = {};
  try {
    schema = (await api("/settings/schema")).properties || {};
  } catch (e) { /* optional */ }
  // find-a-setting filter (reference settings search): hides sections
  // with no matching field name, expands + trims matching ones
  const search = el("input", { placeholder: t("search") + "…", size: 28 });
  search.addEventListener("input", () => {
    const q = search.value.trim().toLowerCase();
    host.querySelectorAll("details.settings-section").forEach((sec) => {
      const name = sec.querySelector("summary").textContent.toLowerCase();
      let any = false;
      sec.querySelectorAll(".field-row").forEach((row) => {
        const hit = !q || name.includes(q)
          || row.querySelector("label").textContent.toLowerCase()
               .includes(q);
        row.style.display = hit ? "" : "none";
        if (hit) any = true;
      });
      sec.style.display = (!q || any) ? "" : "none";
      if (q && any) sec.open = true;
      if (!q) sec.open = false;
    });
  });
  outlet.append(el("div", { class: "row", style: "margin-bottom:10px" },
                   search));
  const host = el("div");
  outlet.append(host);

  const sections = SECTION_ORDER.filter((s) => s in settings)
    .concat(Object.keys(settings).filter(
      (s) => !SECTION_ORDER.includes(s) && typeof settings[s] === "object"
        && settings[s] !== null));

  for (const name of sections) {
    const value = settings[name];
    if (Array.isArray(value) && name !== "models") continue;
    host.append(sectionCard(name, value));
  }

  function sectionCard(name, value) {
    const body = el("div");
    const details = el("details", { class: "settings-section card" },
      el("summary", {}, name.replaceAll("_", " ")), body);
    const props = name === "models"
      ? (schema.models?.items?.properties || {})
      : (schema[name]?.properties || {});
    if (name === "models") {
      value.forEach((m, i) => {
        const sub = el("div", { class: "card" },
          el("h2", {}, m.model_id || `model ${i}`));
        for (const [k, v] of Object.entries(m)) {
          if (k === "model_id") continue;
          sub.append(fieldRow(`${i}.${k}`, k, v, props[k]));
        }
        body.append(sub);
      });
    } else {
      for (const [k, v] of Object.entries(value)) {
        if (name === "realtime" && k === "sources") {
          body.append(sourcesEditor(k, v));
        } else if (name === "realtime" && k === "quiet_hours") {
          body.append(el("div", { class: "field-row" },
            el("label", { title: "22:00-06:00 · sunset+30m to sunrise-30m" },
               k.replaceAll("_", " ")),
            chipList(k, v.map(winToStr))));
        } else if (name === "species" && k === "config") {
          body.append(speciesConfigEditor(k, v));
        } else if (name === "notification" && k === "targets") {
          const ed = objListEditor(k, v, TARGET_FIELDS, { name: "target" });
          const out = el("span", { class: "sub" });
          // test row lives OUTSIDE the editor root: render() rebuilds the
          // root's children on every add/remove, which would wipe it
          body.append(ed, el("div", { class: "row" },
            el("button", { class: "small", onclick: async () => {
              try {
                const r = await api("/notifications/test",
                                    { method: "POST", body: {} });
                out.textContent = r.delivered ? "✓" : "✗";
              } catch (e) { out.textContent = e.message; }
            } }, t("test")), out));
        } else if (name === "alerting" && k === "rules") {
          body.append(objListEditor(k, v, RULE_FIELDS,
                                    { rule_id: "rule", name: "rule" }));
        } else if (v !== null && typeof v === "object" && !Array.isArray(v)) {
          // nested object: flat dict of scalars → editable dotted-key
          // sub-rows (backup.remote, log.module_levels); deeper → JSON
          const flat = Object.values(v).every(
            (x) => x === null || typeof x !== "object");
          if (flat && Object.keys(v).length) {
            body.append(el("div", { class: "sub", style: "margin-top:6px" },
                           k.replaceAll("_", " ")));
            for (const [k2, v2] of Object.entries(v)) {
              const r = fieldRow(`${k}.${k2}`, `· ${k2}`, v2,
                                 props[k]?.properties?.[k2]);
              // explicit path: k2 itself may contain dots (e.g.
              // module_levels logger names) — never re-split the key
              r.querySelector("[data-key]")._path = [k, k2];
              body.append(r);
            }
          } else {
            body.append(fieldRow(k, k, v, props[k]));
          }
        } else {
          body.append(fieldRow(k, k, v, props[k]));
        }
      }
    }
    const warnBox = el("div", { class: "section-warnings" });
    warnBox.style.display = "none";
    body.append(warnBox,
      el("div", { class: "row", style: "margin-top:8px" },
         el("button", { class: "primary", onclick: save }, t("save"))));
    return details;

    // client-side pre-validation against the section's JSON schema:
    // invalid fields get a red border + inline message and block the
    // PATCH (the server still re-validates; this is feedback, not
    // enforcement — VERDICT r3 #9 per-section validation UX)
    function validateField(inp) {
      if (inp._getValue) return true;     // structured editors self-validate
      const spec = inp._spec;
      inp.classList.remove("invalid");
      const prevErr = inp.nextElementSibling;
      if (prevErr && prevErr.classList?.contains("field-error"))
        prevErr.remove();
      let msg = "";
      if (inp.dataset.type === "number" && inp.value !== "") {
        const n = Number(inp.value);
        if (Number.isNaN(n)) msg = t("must_be_number");
        else if (spec) {
          if (spec.minimum !== undefined && n < spec.minimum)
            msg = `≥ ${spec.minimum}`;
          else if (spec.maximum !== undefined && n > spec.maximum)
            msg = `≤ ${spec.maximum}`;
          else if (specType(spec) === "integer" && !Number.isInteger(n))
            msg = t("must_be_integer");
        }
      } else if (inp.dataset.type === "json" && inp.value !== "") {
        try { JSON.parse(inp.value); } catch (e) { msg = t("invalid_json"); }
      } else if (spec?.enum && inp.value !== ""
                 && !spec.enum.includes(inp.value)) {
        msg = `${t("one_of")}: ${spec.enum.join(", ")}`;
      }
      if (msg) {
        inp.classList.add("invalid");
        inp.after(el("span", { class: "field-error" }, msg));
        return false;
      }
      return true;
    }

    function showWarnings(warnings) {
      warnBox.replaceChildren();
      warnBox.style.display = warnings.length ? "" : "none";
      // attribute each warning to its field when the text names one:
      // red border + the message inline next to the input (reference
      // Settings.svelte per-field feedback), plus the section banner
      for (const w of warnings) {
        warnBox.append(el("div", {}, `⚠ ${w}`));
        body.querySelectorAll("[data-key]").forEach((inp) => {
          const field = inp.dataset.key.split(".").pop();
          if (!w.includes(field)) return;
          inp.classList.add("invalid");
          const prev = inp.nextElementSibling;
          if (prev && prev.classList?.contains("field-error"))
            prev.remove();
          inp.after(el("span", { class: "field-error" }, w));
        });
      }
    }

    async function save() {
      let valid = true;
      body.querySelectorAll("[data-key]").forEach((inp) => {
        if (!validateField(inp)) valid = false;
      });
      if (!valid) {
        toast(t("fix_invalid_fields"), true);
        return;
      }
      const patch = {};
      const setPath = (obj, parts, v) => {
        let o = obj;
        for (const p of parts.slice(0, -1)) o = (o[p] = o[p] || {});
        o[parts[parts.length - 1]] = v;
      };
      body.querySelectorAll("[data-key]").forEach((inp) => {
        const key = inp.dataset.key;
        let v;
        if (inp._getValue) v = inp._getValue();
        else if (inp.type === "checkbox") v = inp.checked;
        else if (inp.dataset.type === "number")
          v = inp.value === "" ? null : Number(inp.value);
        else if (inp.dataset.type === "json") {
          try { v = JSON.parse(inp.value || "null"); } catch (e) { return; }
        } else v = inp.value === "" ? null : inp.value;
        if (name === "models") {
          const [idx, field] = key.split(".");
          patch.models = patch.models || value.map((m) => ({ ...m }));
          patch.models[Number(idx)][field] = v;
        } else {
          setPath(patch, inp._path || [key], v);
        }
      });
      try {
        const out = name === "models"
          ? await api("/settings", { method: "PUT", body: patch })
          : await api(`/settings/${name}`, { method: "PATCH", body: patch });
        const sigs = out.signals || [];
        toast(`${t("saved")} ${name}`
          + (sigs.length ? ` → ${sigs.join(", ")}` : ""));
        showWarnings(out.warnings || []);
        (out.warnings || []).forEach((w) => toast(w, true));
      } catch (e) {
        // a structured 400 names the offending field (CoerceError.key);
        // validate() errors name fields only in prose — match either
        // way and anchor the server message to the input instead of
        // only toasting it
        const field = e.data && e.data.field;
        let anchored = false;
        body.querySelectorAll("[data-key]").forEach((inp) => {
          const leaf = inp.dataset.key.split(".").pop();
          const hit = field ? leaf === field
            : new RegExp(`\\b${leaf}\\b`).test(e.message);
          if (!hit) return;
          inp.classList.add("invalid");
          const prev = inp.nextElementSibling;
          if (prev && prev.classList?.contains("field-error"))
            prev.remove();
          inp.after(el("span", { class: "field-error" }, e.message));
          anchored = true;
        });
        if (!anchored) toast(e.message, true);
      }
    }
  }

  /** Effective schema type: nullable fields arrive as
      anyOf [{type: X}, {type: "null"}] — unwrap to X. */
  function specType(spec) {
    if (!spec) return "";
    if (spec.type) return spec.type;
    const alt = (spec.anyOf || []).find((a) => a.type && a.type !== "null");
    return alt ? alt.type : "";
  }

  function fieldRow(key, label, v, spec) {
    let input;
    if (typeof v === "boolean") {
      input = el("input", { type: "checkbox", "data-key": key });
      input.checked = v;
    } else if (typeof v === "number"
               || (v == null && (specType(spec) === "number"
                                 || specType(spec) === "integer"))) {
      // null-valued numeric fields (e.g. location before first setup)
      // must still save as numbers — a text input here serialized
      // "13.405" as a string and the server rejected it
      input = el("input", { type: "number", step: "any", "data-key": key,
                            "data-type": "number", value: v ?? "" });
    } else if (Array.isArray(v)
               && (v.length ? v.every((x) => typeof x === "string")
                            : spec?.items?.type === "string")) {
      input = chipList(key, v);         // string lists: chips + add box
    } else if (Array.isArray(v) || (v !== null && typeof v === "object")) {
      input = el("input", { "data-key": key, "data-type": "json",
                            value: JSON.stringify(v) });
    } else {
      input = el("input", { "data-key": key, value: v ?? "" });
    }
    const hint = spec
      ? `${specType(spec)}${spec.default !== undefined
          ? ` · default ${JSON.stringify(spec.default)}` : ""}`
      : "";
    if (hint) input.title = hint;
    input._spec = spec;               // drives per-field validation
    return el("div", { class: "field-row" },
      el("label", { title: hint }, label.replaceAll("_", " ")), input);
  }
}

/** Quiet-hours window → editable string ("22:00-06:00"; sun-relative
    specs contain letters and need the " to " separator). */
function winToStr(w) {
  if (typeof w === "string") return w;
  const sep = /[a-z]/.test(`${w.start}${w.end}`) ? " to " : "-";
  return `${w.start}${sep}${w.end}`;
}

/* ---- structured editors (reference settings components:
   SpeciesListEditor / SpeciesInput, StreamManager / RTSPUrlManager /
   StreamTestButton, QuietHoursEditor — desktop/components/forms).
   Each returns a root element carrying data-key + _getValue(); the
   section save() collects them like plain inputs. ---- */

/** Editable string list: chips with ×, plus an add box. */
export function chipList(key, values) {
  const root = el("div", { class: "chip-list", "data-key": key });
  const items = [...values];
  const addBox = el("input", { size: 14 });
  const addBtn = el("button", { class: "small", onclick: add }, t("add"));
  addBox.addEventListener("keydown", (e) => {
    if (e.key === "Enter") { e.preventDefault(); add(); }
  });
  function add() {
    const v = addBox.value.trim();
    if (!v || items.includes(v)) return;
    items.push(v);
    addBox.value = "";
    render();
  }
  function render() {
    root.replaceChildren(
      ...items.map((v, i) => el("span", { class: "chip" }, v,
        el("button", { class: "chip-x", "aria-label": t("remove"),
          onclick: () => { items.splice(i, 1); render(); } }, "×"))),
      addBox, addBtn);
  }
  render();
  root._getValue = () => [...items];
  return root;
}

const SOURCE_FIELDS = {
  file: [["path", ""], ["speed", 1.0]],
  tone: [["freq", 1000], ["speed", 1.0]],
  rtsp: [["url", "rtsp://"], ["transport", "tcp"], ["client", ""]],
  http: [["url", "http://"]],
  audio_card: [["device", "default"], ["rate", 48000], ["channels", 1]],
};

/** Realtime sources: per-source rows with type-specific fields, a
    quiet-hours chip list, and a reachability test for URL sources. */
export function sourcesEditor(key, sources) {
  const root = el("div", { class: "card", "data-key": key });
  const items = sources.map((s) => ({ ...s }));
  function row(src, idx) {
    const box = el("div", { class: "card" });
    const typeSel = el("select", {},
      Object.keys(SOURCE_FIELDS).map((k) => el("option",
        { value: k, selected: (src.type || "file") === k ? "" : null }, k)));
    typeSel.addEventListener("change", () => {
      src.type = typeSel.value;
      for (const [f, dflt] of SOURCE_FIELDS[src.type])
        if (src[f] === undefined) src[f] = dflt;
      render();
    });
    const idIn = el("input", { size: 10, value: src.id ?? "" });
    idIn.addEventListener("input", () => { src.id = idIn.value; });
    const head = el("div", { class: "row" },
      el("label", {}, "type"), typeSel, el("label", {}, "id"), idIn,
      el("button", { class: "small right", onclick: () => {
        items.splice(idx, 1); render();
      } }, "✕ " + t("remove")));
    box.append(head);
    for (const [f, dflt] of SOURCE_FIELDS[src.type || "file"]) {
      const cur = src[f] ?? dflt;
      const inp = el("input", { size: 22, value: cur });
      inp.addEventListener("input", () => {
        src[f] = typeof dflt === "number"
          ? (inp.value === "" ? dflt : Number(inp.value)) : inp.value;
      });
      box.append(el("div", { class: "field-row" },
                    el("label", {}, f), inp));
    }
    if (src.type === "rtsp" || src.type === "http") {
      const out = el("span", { class: "sub" });
      box.append(el("div", { class: "row" },
        el("button", { class: "small", onclick: async () => {
          try {
            const r = await api("/streams/test",
                                { method: "POST", body: { url: src.url } });
            out.textContent = r.ok ? `✓ ${r.connect_ms ?? "?"} ms`
                                   : `✗ ${r.error || ""}`;
          } catch (e) { out.textContent = e.message; }
        } }, t("test")), out));
    }
    const qh = chipList(`_qh_${idx}`,
      (src.quiet_hours || []).map(winToStr));
    qh.removeAttribute("data-key");     // internal — collected via src
    src._qh = qh;
    box.append(el("div", { class: "field-row",
      title: "22:00-06:00 · sunset+30m to sunrise-30m" },
      el("label", {}, "quiet hours"), qh));
    return box;
  }
  function flushChips() {
    // chip edits live only in the chipList until flushed; a re-render
    // (add/remove source, type change) must not discard them
    for (const s of items) {
      if (!s._qh) continue;
      const wins = s._qh._getValue();
      if (wins.length) s.quiet_hours = wins;
      else delete s.quiet_hours;
    }
  }
  function freshId() {
    let n = items.length;
    while (items.some((s) => s.id === `source${n}`)) n += 1;
    return `source${n}`;
  }
  function render() {
    flushChips();
    root.replaceChildren(
      ...items.map((s, i) => row(s, i)),
      el("button", { class: "small", onclick: () => {
        items.push({ type: "rtsp", id: freshId(), url: "rtsp://" });
        render();
      } }, "+ " + t("add")));
  }
  render();
  root._getValue = () => {
    flushChips();
    return items.map(({ _qh, ...rest }) => rest);
  };
  return root;
}

/* Field specs for the generic object-list editor: [key, default, type]
   with type ∈ text | number | bool | csv (comma-separated → string[]). */
const TARGET_FIELDS = [
  ["name", "", "text"], ["kind", "webhook", "text"],
  ["url", "", "text"], ["body_template", "", "text"],
  ["min_interval_seconds", 0, "number"],
];
const RULE_FIELDS = [
  ["rule_id", "", "text"], ["name", "", "text"],
  ["enabled", true, "bool"], ["species", [], "csv"],
  ["min_confidence", 0, "number"], ["sources", [], "csv"],
  ["only_new_species", false, "bool"], ["active_window", "", "text"],
  ["min_interval_seconds", 300, "number"],
  ["priority", "normal", "text"],
  // seed the server-side default so a fresh rule doesn't override it
  // with "" (AlertRule.message_template); clearing it falls back to the
  // default too (empty text fields are omitted from the PATCH body)
  ["message_template", "{common_name} detected ({confidence:.0%})", "text"],
  // system-metric rules (cpu/memory/disk %, fed by the resource
  // monitor): metric set = metric rule; empty = detection rule
  ["metric", "", "text"], ["threshold", 0, "number"],
  ["sustained_seconds", 0, "number"], ["path", "", "text"],
];

/** Generic array-of-objects editor (notification targets, alert rules):
    one sub-card per item with typed field rows, add/remove. `fresh`
    seeds required keys on newly added items. */
export function objListEditor(key, items0, fields, fresh = {}) {
  const root = el("div", { class: "card", "data-key": key });
  const items = items0.map((o) => ({ ...o }));
  function row(item, idx) {
    const box = el("div", { class: "card" });
    box.append(el("div", { class: "row" },
      el("strong", {}, item.name || item.rule_id || `#${idx + 1}`),
      el("button", { class: "small right", onclick: () => {
        items.splice(idx, 1); render();
      } }, "✕ " + t("remove"))));
    for (const [f, dflt, kind] of fields) {
      const cur = item[f] ?? dflt;
      let inp;
      if (kind === "bool") {
        inp = el("input", { type: "checkbox" });
        inp.checked = !!cur;
        inp.addEventListener("change", () => { item[f] = inp.checked; });
      } else if (kind === "csv") {
        inp = el("input", { size: 26,
                            value: Array.isArray(cur) ? cur.join(", ") : cur });
        inp.addEventListener("input", () => {
          item[f] = inp.value.split(",").map((s) => s.trim())
            .filter(Boolean);
        });
      } else {
        // number fields show the effective default as a placeholder so a
        // cleared input visibly means "default applies" rather than
        // silently storing a value the UI doesn't display
        inp = el("input", { size: 26, value: cur,
                            type: kind === "number" ? "number" : "text",
                            ...(kind === "number"
                                ? { placeholder: String(dflt) } : {}) });
        inp.addEventListener("input", () => {
          item[f] = kind === "number"
            ? (inp.value === "" ? dflt : Number(inp.value)) : inp.value;
        });
      }
      box.append(el("div", { class: "field-row" },
                    el("label", {}, f.replaceAll("_", " ")), inp));
    }
    return box;
  }
  function render() {
    root.replaceChildren(
      ...items.map((o, i) => row(o, i)),
      el("button", { class: "small", onclick: () => {
        const o = {};
        for (const [f, dflt] of fields)
          o[f] = Array.isArray(dflt) ? [...dflt] : dflt;
        // skip ids already in use: after delete-then-add, length+1 can
        // collide with a surviving entry and the server's keyed rebuild
        // (replace_rules / target names) would silently drop one
        for (const [f, base] of Object.entries(fresh)) {
          let n = items.length + 1;
          while (items.some((it) => it[f] === `${base}${n}`)) n++;
          o[f] = `${base}${n}`;
        }
        items.push(o);
        render();
      } }, "+ " + t("add")));
  }
  render();
  // empty text fields are omitted so server-side dataclass defaults
  // apply (e.g. a cleared message_template falls back to the default
  // template instead of formatting an empty string)
  root._getValue = () => items.map((o) => {
    const out = { ...o };
    for (const k of Object.keys(out)) if (out[k] === "") delete out[k];
    return out;
  });
  return root;
}

/** Per-species config table: threshold + interval per species
    (species.config — reference SpeciesListEditor per-species actions). */
export function speciesConfigEditor(key, config) {
  const root = el("div", { class: "card", "data-key": key });
  const items = Object.entries(config).map(
    ([sp, c]) => ({ species: sp, ...c }));
  function render() {
    const rows = items.map((it, i) => {
      const sp = el("input", { size: 24, value: it.species });
      sp.addEventListener("input", () => { it.species = sp.value; });
      const th = el("input", { type: "number", step: "0.01", min: "0",
                               max: "1", value: it.threshold ?? "" });
      th.addEventListener("input", () => {
        it.threshold = th.value === "" ? undefined : Number(th.value);
      });
      const iv = el("input", { type: "number", step: "1", min: "0",
                               value: it.interval ?? "" });
      iv.addEventListener("input", () => {
        it.interval = iv.value === "" ? undefined : Number(iv.value);
      });
      return el("div", { class: "row" }, sp, th, iv,
        el("button", { class: "small", onclick: () => {
          items.splice(i, 1); render();
        } }, "×"));
    });
    root.replaceChildren(
      el("div", { class: "row sub" },
        el("span", {}, t("species")), el("span", {}, t("threshold")),
        el("span", {}, "interval (s)")),
      ...rows,
      el("button", { class: "small", onclick: () => {
        items.push({ species: "" }); render();
      } }, "+ " + t("add")));
  }
  render();
  root._getValue = () => {
    const out = {};
    for (const it of items) {
      if (!it.species) continue;
      const { species, ...cfg } = it;
      for (const k of Object.keys(cfg))
        if (cfg[k] === undefined) delete cfg[k];
      out[species] = cfg;
    }
    return out;
  };
  return root;
}
