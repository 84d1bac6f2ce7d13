/* BirdNET-TPU SPA shell: API client, hash router, i18n, DOM helpers.
   No build step — plain ES modules served from /static/. */

import { MESSAGES } from "/static/i18n.js";

export const API = "/api/v2";

// ---------------------------------------------------------------- api client

let csrf = sessionStorage.getItem("csrf") || "";

export async function api(path, { method = "GET", body, raw = false } = {}) {
  const headers = {};
  if (body !== undefined) headers["Content-Type"] = "application/json";
  if (csrf && method !== "GET") headers["X-CSRF-Token"] = csrf;
  const resp = await fetch(API + path, {
    method, headers,
    body: body !== undefined ? JSON.stringify(body) : undefined,
  });
  if (resp.status === 401) {
    location.href = "/login";
    throw new Error("unauthorized");
  }
  if (raw) return resp;
  const data = await resp.json().catch(() => ({}));
  if (!resp.ok) throw Object.assign(new Error(data.error || resp.statusText),
                                    { status: resp.status, data });
  return data;
}

// ------------------------------------------------------------------- helpers

/** Element builder. Children are appended; strings become text nodes
    (untrusted data never goes through innerHTML). */
export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") node.className = v;
    else if (k.startsWith("on") && typeof v === "function")
      node.addEventListener(k.slice(2), v);
    else if (v !== undefined && v !== null) node.setAttribute(k, v);
  }
  for (const c of children.flat()) {
    if (c === null || c === undefined) continue;
    node.append(c.nodeType ? c : document.createTextNode(String(c)));
  }
  return node;
}

export function clear(node) { while (node.firstChild) node.removeChild(node.firstChild); return node; }

export function fmtTime(unixOrIso) {
  const d = typeof unixOrIso === "number" ? new Date(unixOrIso * 1000)
        : new Date(unixOrIso);
  return d.toLocaleString(undefined, { dateStyle: "medium", timeStyle: "short" });
}

export function fmtNum(n) {
  if (n === null || n === undefined) return "–";
  if (Math.abs(n) >= 1e6) return (n / 1e6).toFixed(1) + "M";
  if (Math.abs(n) >= 1e4) return (n / 1e3).toFixed(1) + "K";
  return Number(n).toLocaleString();
}

export function confMeter(c) {
  const pct = Math.round(c * 100);
  const bar = el("div", { class: "meter" }, el("div", { style: `width:${pct}%` }));
  return el("span", { class: "conf" }, bar, `${pct}%`);
}

export function table(headers, rows) {
  return el("table", { class: "data" },
    el("thead", {}, el("tr", {}, headers.map((h) => el("th", {}, h)))),
    el("tbody", {}, rows.map((r) =>
      el("tr", {}, r.map((c) => el("td", {}, c))))));
}

/** Standardized weather icon code (integrations/weather.py) → glyph.
    One vocabulary regardless of provider (yr.no / OpenWeather / PWS). */
export function weatherGlyph(icon) {
  return ({ "01": "☀", "02": "🌤", "03": "⛅", "04": "☁", "09": "🌦",
            "10": "🌧", "11": "⛈", "12": "🌨", "13": "❄", "50": "🌫",
          })[icon] || "";
}

export function isoDaysAgo(n) {
  const d = new Date(Date.now() - n * 86400e3);
  return d.toISOString().slice(0, 10);
}

let toastTimer = null;
export function toast(msg, isError = false) {
  document.querySelectorAll(".toast").forEach((t) => t.remove());
  // role=alert/status: announced by screen readers without focus moves
  const t = el("div", { class: "toast" + (isError ? " err" : ""),
                        role: isError ? "alert" : "status" }, msg);
  document.body.append(t);
  clearTimeout(toastTimer);
  toastTimer = setTimeout(() => t.remove(), 4000);
}

/** Modal dialog (reference SpeciesDetailModal et al.): returns the body
    element to fill. Closes on ✕, Escape, backdrop click, or navigation. */
export function modal(title) {
  const body = el("div", { class: "modal-body" });
  const box = el("div", { class: "modal", role: "dialog",
                          "aria-label": title },
    el("div", { class: "modal-head" },
      el("h2", {}, title),
      el("button", { class: "icon", "aria-label": "close",
                     onclick: close }, "✕")),
    body);
  const overlay = el("div", { class: "modal-overlay" }, box);
  overlay.addEventListener("click", (ev) => {
    if (ev.target === overlay) close();
  });
  const onKey = (ev) => { if (ev.key === "Escape") close(); };
  document.addEventListener("keydown", onKey);
  function close() {
    document.removeEventListener("keydown", onKey);
    overlay.remove();
  }
  document.body.append(overlay);
  onCleanup(close);
  return { body, close };
}

/** Confirmation dialog (reference ConfirmModal.svelte): resolves true on
    confirm, false on cancel/escape/backdrop. */
export function confirmDialog(message, { danger = true } = {}) {
  return new Promise((resolve) => {
    const { body, close } = modal(t("confirm"));
    body.append(
      el("p", {}, message),
      el("div", { class: "row", style: "justify-content:flex-end" },
        el("button", { onclick: () => { close(); resolve(false); } },
           t("cancel")),
        el("button", { class: danger ? "primary danger" : "primary",
          onclick: () => { close(); resolve(true); } }, t("confirm"))));
    // closing by ✕/escape/backdrop must also settle the promise
    const overlay = body.closest(".modal-overlay");
    new MutationObserver((_, obs) => {
      if (!overlay.isConnected) { obs.disconnect(); resolve(false); }
    }).observe(document.body, { childList: true });
  });
}

// ---------------------------------------------------------------------- i18n

export let lang = localStorage.getItem("lang")
  || (navigator.language || "en").slice(0, 2);
if (!MESSAGES[lang]) lang = "en";
export const t = (key) => (MESSAGES[lang] && MESSAGES[lang][key])
  || MESSAGES.en[key] || key;
export function setLang(code) {
  localStorage.setItem("lang", code);
  location.reload();
}
export const LANGS = Object.keys(MESSAGES);

// -------------------------------------------------------------------- router

const routes = {};
export function route(name, loader) { routes[name] = loader; }

// View lifecycle: resources a view acquires during render (EventSources,
// WebSockets, intervals) register a cleanup here and are released on the
// next navigation — otherwise every Dashboard visit leaks 3 SSE
// connections and the per-origin HTTP/1.1 cap (6) hangs the whole SPA.
let viewCleanups = [];
export function onCleanup(fn) { viewCleanups.push(fn); }
let navToken = 0;
let currentQuery = new URLSearchParams();

/** Query part of the current hash route (#/view?k=v) — lets charts deep-
    link into pre-filtered views (analytics cell → detections). */
export function viewQuery() { return currentQuery; }

export async function navigate() {
  const token = ++navToken;
  for (const fn of viewCleanups.splice(0)) {
    try { fn(); } catch (e) { /* teardown must never block navigation */ }
  }
  const full = (location.hash || "#/dashboard").slice(2);
  // deep links carry filters after '?' (#/detections?species=…): the
  // query never participates in route resolution
  const [hash, query] = full.split("?");
  currentQuery = new URLSearchParams(query || "");
  const [name, ...rest] = hash.split("/");
  const outlet = document.getElementById("outlet");
  document.querySelectorAll("nav.sidebar a[data-route]").forEach((a) => {
    a.classList.toggle("active", a.dataset.route === name);
  });
  const loader = routes[name] || routes.dashboard;
  clear(outlet);
  // each view renders into its OWN container: when a slow view's awaits
  // resolve after a newer navigation, its late DOM lands in a detached
  // node instead of the next view's outlet (resources it registers late
  // are swept one navigation later by the cleanup list)
  const view = el("div", { class: "view" });
  outlet.append(view);
  try {
    await loader(view, rest);
  } catch (e) {
    if (token !== navToken) return;   // a newer navigation owns the outlet
    view.append(el("div", { class: "card" },
      el("h2", {}, t("error")), el("p", { class: "sub" }, e.message)));
  }
  // a11y: route changes move focus to the content region so keyboard /
  // screen-reader users land on the new view, not mid-sidebar
  if (token === navToken) outlet.focus({ preventScroll: true });
}

// ------------------------------------------------------------ SSE helper

/** Open an EventSource. Closed automatically on navigation unless
    {scope: "app"} (app-lifetime subscriptions like the unread badge). */
export function subscribe(path, onEvent, { scope = "view" } = {}) {
  const es = new EventSource(API + path);
  es.onmessage = (ev) => onEvent("message", ev.data);
  for (const kind of ["detection", "notification", "audiolevel",
                      "soundlevel", "install", "pending", "health"]) {
    es.addEventListener(kind, (ev) => onEvent(kind, ev.data));
  }
  if (scope === "view") onCleanup(() => es.close());
  return es;
}

/** setInterval that survives callback errors and dies with the view. */
export function viewInterval(fn, ms) {
  const timer = setInterval(async () => {
    try { await fn(); } catch (e) { /* keep polling */ }
  }, ms);
  onCleanup(() => clearInterval(timer));
  return timer;
}

// ------------------------------------------------------------------- startup

export async function boot() {
  // auth status drives the logout button visibility
  try {
    const st = await api("/auth/status");
    if (st.security_enabled && !st.authenticated) {
      location.href = "/login";
      return;
    }
    if (st.csrf) {            // OIDC/SSO sessions never saw the login page
      csrf = st.csrf;
      sessionStorage.setItem("csrf", csrf);
    }
    document.getElementById("logout").style.display =
      st.security_enabled ? "" : "none";
  } catch (e) { /* open server */ }
  // unread notifications badge (live via SSE)
  const badge = document.getElementById("notif-badge");
  const refreshBadge = async () => {
    try {
      const { count } = await api("/notifications/unread/count");
      badge.textContent = count > 0 ? String(count) : "";
      badge.style.display = count > 0 ? "" : "none";
    } catch (e) { badge.style.display = "none"; }
  };
  refreshBadge();
  subscribe("/notifications/stream", refreshBadge, { scope: "app" });
  // PWA: installable + offline shell
  if ("serviceWorker" in navigator) {
    navigator.serviceWorker.register("/sw.js").catch(() => {});
  }
  window.addEventListener("hashchange", navigate);
  await navigate();
}
