/* Report-a-bug page (#/reportbug): pre-filled copyable system info, a
   what-to-include checklist, a GitHub issue link, and support-dump
   download — a dedicated view mirroring the reference's ReportBug.svelte
   + SupportDumpCard (frontend/src/lib/desktop/views/ReportBug.svelte). */

import { api, el, t, toast } from "../app.js";

const REPO = "https://github.com/tphakala/birdnet-go";

export async function reportBugView(outlet) {
  outlet.append(el("div", { class: "card", style: "text-align:center" },
    el("div", { style: "font-size:36px;line-height:1" }, "⚑"),
    el("h1", { style: "margin:8px 0 4px" }, t("report_bug")),
    el("p", { class: "sub" }, t("report_bug_help"))));

  // step 1: system information (ReportBug.svelte fetchSystemInfo +
  // copySystemInfo)
  const infoBox = el("pre", { class: "sub",
                              style: "white-space:pre-wrap" }, "…");
  let infoText = "";
  const copyBtn = el("button", { class: "small", onclick: async () => {
    try {
      await navigator.clipboard.writeText(infoText);
      copyBtn.textContent = "✓ " + t("copied");
      toast(t("copied"));
    } catch (e) { toast(e.message, true); }
  } }, "⧉ " + t("copy_system_info"));
  outlet.append(el("div", { class: "card" },
    el("h2", {}, "1 · " + t("rb_sysinfo")),
    infoBox, el("div", { class: "row" }, copyBtn)));

  // step 2: what to include
  outlet.append(el("div", { class: "card" },
    el("h2", {}, "2 · " + t("what_to_include")),
    el("ul", { class: "sub" },
      el("li", {}, t("include_steps")),
      el("li", {}, t("include_expected")),
      el("li", {}, t("include_version")),
      el("li", {}, t("include_logs")))));

  // step 3: support dump (SupportDumpCard — the dump is assembled
  // server-side with secrets scrubbed; see utils/support.py)
  const dumpBtn = el("button", { class: "small primary", onclick: () => {
    window.open("/api/v2/support/dump", "_blank");
  } }, "⬇ " + t("support_dump"));
  outlet.append(el("div", { class: "card" },
    el("h2", {}, "3 · " + t("support_dump")),
    el("p", { class: "sub" }, t("rb_dump_help")),
    el("div", { class: "row" }, dumpBtn)));

  // step 4: open the issue
  outlet.append(el("div", { class: "card" },
    el("h2", {}, "4 · " + t("rb_open_issue")),
    el("p", { class: "sub" }, t("rb_search_first")),
    el("div", { class: "row" },
      el("a", { href: `${REPO}/issues`, target: "_blank",
                rel: "noopener noreferrer", class: "small" },
         t("rb_search_issues") + " ↗"),
      el("a", { href: `${REPO}/issues/new/choose`, target: "_blank",
                rel: "noopener noreferrer", class: "small primary" },
         t("rb_open_issue") + " ↗"))));

  try {
    const info = await api("/system/info");
    infoText = [
      `Version: ${info.version}`,
      `Platform: ${info.platform}`,
      `Python: ${info.python}`,
      `Devices: ${(info.devices || []).join(", ")}`,
      `Uptime: ${info.uptime_seconds}s`,
      `Sources: ${(info.sources || []).join(", ") || "-"}`,
      `Browser: ${navigator.userAgent}`,
    ].join("\n");
    infoBox.textContent = infoText;
  } catch (e) {
    infoBox.textContent = e.message;
  }
}
