/* About page (#/about): product overview, BirdNET project credits,
   technology stack, version/build info, and license — a dedicated view
   (reference: frontend/src/lib/desktop/views/About.svelte), while #/help
   keeps the quick-reference cards. */

import { api, el, t } from "../app.js";

const REPO = "https://github.com/tphakala/birdnet-go";
const ANALYZER = "https://github.com/birdnet-team/BirdNET-Analyzer";
const PI = "https://github.com/mcguirepr89/BirdNET-Pi";

const link = (href, label) =>
  el("a", { href, target: "_blank", rel: "noopener noreferrer" },
     label + " ↗");

export async function aboutView(outlet) {
  // header (About.svelte: logo + title + subtitle)
  outlet.append(el("div", { class: "card", style: "text-align:center" },
    el("div", { style: "font-size:42px;line-height:1" }, "❧"),
    el("h1", { style: "margin:8px 0 4px" }, "BirdNET-TPU"),
    el("p", { class: "sub" }, t("about_subtitle"))));

  // overview
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("about")),
    el("p", {}, t("about_overview")),
    el("p", { class: "sub" }, "★ ", link(REPO, "GitHub"))));

  // credits (About.svelte: birdnetProject / contributors / birdnetPi /
  // labelTranslations)
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("about_credits")),
    el("p", {}, t("about_birdnet")),
    el("p", { class: "sub" }, link(ANALYZER, "BirdNET-Analyzer")),
    el("p", {}, t("about_birdnet_pi")),
    el("p", { class: "sub" }, link(PI, "BirdNET-Pi")),
    el("p", { class: "sub" }, t("about_labels")),
    el("p", { class: "sub" }, t("about_credits_community"))));

  // technology stack (ours, not the reference's)
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("about_tech")),
    el("p", { class: "sub" }, t("about_tech_text"))));

  // version information (About.svelte versionInformation card)
  const version = el("span", {}, "…");
  const platform = el("span", { class: "sub" }, "");
  const devices = el("span", { class: "sub" }, "");
  const uptime = el("span", { class: "sub" }, "");
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("version")),
    el("table", { class: "data" }, el("tbody", {},
      el("tr", {}, el("td", {}, t("version")), el("td", {}, version)),
      el("tr", {}, el("td", {}, t("rb_platform")), el("td", {}, platform)),
      el("tr", {}, el("td", {}, t("devices")), el("td", {}, devices)),
      el("tr", {}, el("td", {}, t("rb_uptime")), el("td", {}, uptime))))));

  // license
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("license")),
    el("p", { class: "sub" }, t("about_license_text")),
    el("p", { class: "sub" }, link(`${REPO}/blob/main/LICENSE`,
                                   t("license")))));

  // Missing payload fields render as "?" via a Proxy get-trap default,
  // so the table never shows "undefined" on older servers.
  const withDefaults = (o) => new Proxy(o, {
    get: (tgt, k) => (Reflect.has(tgt, k) ? Reflect.get(tgt, k) : "?"),
  });
  try {
    const info = withDefaults(await api("/system/info"));
    version.textContent = String(info.version);
    platform.textContent = `${info.platform} · Python ${info.python}`;
    const devs = Reflect.get(info, "devices");
    devices.textContent =
      (Array.isArray(devs) ? devs.join(", ") : "") || "-";
    uptime.textContent =
      `${Math.round(Number(info.uptime_seconds) || 0)}s`;
  } catch (e) {
    version.textContent = "?";
    platform.textContent = e.message;
  }
}
