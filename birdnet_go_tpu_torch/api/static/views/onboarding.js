/* First-run onboarding wizard (reference: frontend onboarding flow).
   Shown when no location is configured and the wizard hasn't been
   dismissed; walks through location → audio source → done, writing
   through the normal settings PATCH (which emits hot-reload signals). */

import { api, el, toast, t } from "../app.js";

export async function maybeShowWizard() {
  let cfg;
  try {
    cfg = await api("/app/config");
  } catch (e) { return; }
  if (cfg.location_configured || cfg.wizard_dismissed) return;
  // navigate() clears only #outlet — guard against stacking an overlay
  // per Dashboard visit
  if (document.querySelector(".wizard-overlay")) return;

  const overlay = el("div", { class: "wizard-overlay" });
  const box = el("div", { class: "wizard card" });
  overlay.append(box);
  document.body.append(overlay);
  const close = async (dismiss) => {
    if (dismiss) {
      await api("/app/wizard/dismiss", { method: "POST", body: {} })
        .catch(() => {});
    }
    overlay.remove();
  };

  step1();

  // ---- step 1: location ----
  function step1() {
    const lat = el("input", { type: "number", step: "0.0001", size: 10,
                              placeholder: "latitude" });
    const lon = el("input", { type: "number", step: "0.0001", size: 10,
                              placeholder: "longitude" });
    const geoBtn = el("button", { class: "small", onclick: () => {
      navigator.geolocation?.getCurrentPosition((pos) => {
        lat.value = pos.coords.latitude.toFixed(4);
        lon.value = pos.coords.longitude.toFixed(4);
      }, () => toast(t("location_unavailable"), true));
    } }, t("use_my_location"));
    render(t("welcome"), [
      el("p", { class: "sub" },
        t("station_coords_help")),
      el("div", { class: "row" }, lat, lon, geoBtn),
    ], [
      [t("skip_setup"), () => close(true)],
      [t("next"), async () => {
        if (!lat.value || !lon.value) { toast(t("enter_coordinates"), true); return; }
        try {
          await api("/settings/location", { method: "PATCH",
            body: { latitude: Number(lat.value),
                    longitude: Number(lon.value) } });
          step2();
        } catch (e) { toast(e.message, true); }
      }, "primary"],
    ]);
  }

  // ---- step 2: audio source ----
  async function step2() {
    let devices = [];
    try {
      const d = await api("/devices");
      devices = d.devices || [];
    } catch (e) { /* no ALSA */ }
    const kind = el("select", {},
      el("option", { value: "" }, "— choose a source type —"),
      devices.length
        ? el("option", { value: "audio_card" }, t("sound_card"))
        : null,
      el("option", { value: "rtsp" }, "RTSP camera / stream"),
      el("option", { value: "file" }, "Audio file (loop)"));
    const detail = el("div", { class: "row", style: "margin-top:8px" });
    const device = el("select", {}, devices.map((d) =>
      el("option", { value: d.alsa_name || d.id }, d.description || d.id)));
    const url = el("input", { placeholder: "rtsp://camera/stream", size: 34 });
    const path = el("input", { placeholder: "/path/to/recording.wav", size: 34 });
    kind.addEventListener("change", () => {
      detail.replaceChildren(
        kind.value === "audio_card" ? device
        : kind.value === "rtsp" ? url
        : kind.value === "file" ? path : "");
    });
    render(t("add_audio_source"), [
      el("p", { class: "sub" },
        "Pick where live audio comes from. You can add more sources "
        + "later under Settings → realtime."),
      kind, detail,
    ], [
      ["← " + t("back"), step1],
      [t("skip"), step3],
      [t("next"), async () => {
        if (!kind.value) { step3(); return; }
        const src = kind.value === "audio_card"
          ? { type: "audio_card", device: device.value }
          : kind.value === "rtsp"
            ? { type: "rtsp", url: url.value.trim() }
            : { type: "file", path: path.value.trim() };
        if ((src.url === "" && kind.value === "rtsp")
            || (src.path === "" && kind.value === "file")) {
          toast(t("fill_in_source"), true);
          return;
        }
        try {
          const cur = await api("/settings");
          const sources = (cur.realtime?.sources || []).concat([src]);
          await api("/settings/realtime",
                    { method: "PATCH", body: { sources } });
          step3();
        } catch (e) { toast(e.message, true); }
      }, "primary"],
    ]);
  }

  // ---- step 3: done ----
  function step3() {
    render(t("all_set"), [
      el("p", { class: "sub" },
        "The range filter will rebuild for your location and detections "
        + "will appear on the dashboard as soon as audio flows. "
        + "Explore Settings for models, filters, and integrations."),
    ], [
      [t("finish"), () => { close(true); location.reload(); }, "primary"],
    ]);
  }

  function render(title, content, buttons) {
    box.replaceChildren(
      el("h2", {}, title),
      ...content,
      el("div", { class: "row", style: "margin-top:16px" },
        ...buttons.map(([label, fn, cls]) =>
          el("button", { class: cls || "", onclick: fn }, label))));
  }
}
