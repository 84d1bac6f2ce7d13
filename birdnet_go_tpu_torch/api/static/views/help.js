/* Help / About / Report-a-bug page (#/help). Merges the reference's
   Help.svelte, About.svelte and ReportBug.svelte views: product overview
   with version, a bug-report kit (copyable system info, support-dump
   download, what-to-include checklist), and quick links.
   Reference: frontend/src/lib/desktop/views/{Help,About,ReportBug}.svelte. */

import { api, el, t, toast } from "../app.js";

const REPO = "https://github.com/tphakala/birdnet-go";

export async function helpView(outlet) {
  outlet.append(el("h1", {}, t("help")));

  // ---- about card (reference About.svelte) ----
  const version = el("span", {}, "…");
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("about")),
    el("p", {},
       el("strong", {}, "BirdNET-TPU"), " · ",
       el("span", { class: "sub" }, t("version")), " ", version),
    el("p", { class: "sub" }, t("about_overview")),
    el("p", { class: "sub" }, t("about_birdnet"))));

  // ---- report a bug (reference ReportBug.svelte) ----
  const infoBox = el("pre", { class: "sub",
                              style: "white-space:pre-wrap" }, "…");
  let infoText = "";
  const copyBtn = el("button", { class: "small", onclick: async () => {
    try {
      await navigator.clipboard.writeText(infoText);
      toast(t("copied"));
    } catch (e) { toast(e.message, true); }
  } }, "⧉ " + t("copy_system_info"));
  const dumpBtn = el("button", { class: "small primary", onclick: () => {
    window.open("/api/v2/support/dump", "_blank");
  } }, "⬇ " + t("support_dump"));
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("report_bug")),
    el("p", { class: "sub" }, t("report_bug_help")),
    infoBox,
    el("div", { class: "row" }, copyBtn, dumpBtn),
    el("h3", {}, t("what_to_include")),
    el("ul", { class: "sub" },
      el("li", {}, t("include_steps")),
      el("li", {}, t("include_expected")),
      el("li", {}, t("include_logs")))));

  // ---- keyboard shortcuts (the round-4 interactivity additions) ----
  const kbd = (k) => el("kbd", {}, k);
  const row = (keys, what) => el("tr", {},
    el("td", {}, keys.map((k, i) => [i ? " / " : "", kbd(k)])),
    el("td", { class: "sub" }, what));
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("keyboard_shortcuts")),
    el("table", { class: "data" }, el("tbody", {},
      row(["Space", "k"], t("ks_play_pause")),
      row(["←", "→"], t("ks_scrub")),
      row(["Shift+←", "Shift+→"], t("ks_scrub_fast")),
      row(["Home"], t("ks_restart")),
      row(["Enter"], t("ks_activate_mark")),
      row([t("ks_drag")], t("ks_zoom")),
      row([t("ks_double_click")], t("reset_zoom"))))));

  // ---- quick links (reference Help.svelte quickLinks) ----
  const link = (href, label) =>
    el("a", { href, target: "_blank", rel: "noopener noreferrer",
              style: "display:block;margin:4px 0" }, label + " ↗");
  outlet.append(el("div", { class: "card" },
    el("h2", {}, t("quick_links")),
    link(`${REPO}/issues/new/choose`, t("report_bug")),
    link(`${REPO}/discussions`, t("ask_question")),
    link(REPO, "GitHub"),
    link(`${REPO}/releases`, t("releases")),
    link(`${REPO}/blob/main/LICENSE`, t("license"))));

  // fill system info asynchronously (reference fetchSystemInfo)
  try {
    const info = await api("/system/info");
    version.textContent = info.version || "?";
    infoText = [
      `Version: ${info.version}`,
      `Platform: ${info.platform}`,
      `Python: ${info.python}`,
      `Devices: ${(info.devices || []).join(", ")}`,
      `Uptime: ${info.uptime_seconds}s`,
      `Sources: ${(info.sources || []).join(", ") || "-"}`,
    ].join("\n");
    infoBox.textContent = infoText;
  } catch (e) {
    infoBox.textContent = e.message;
  }
}
