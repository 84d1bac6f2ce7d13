/* Synchronized spectrogram + audio playback (reference SpectrogramPlayer
   .svelte / PlayOverlay.svelte / SpectrogramControls.svelte,
   frontend/src/lib/desktop/components/media): the playhead sweeps across
   the detection's spectrogram while the clip plays, clicking anywhere on
   the image seeks to that fraction of the clip, and the overlay button
   toggles play/pause. Pure DOM — no canvas redraws per frame, just a CSS
   `left` transform on the playhead line. */

import { el, onCleanup, t } from "../app.js";

/** Build a click-to-seek spectrogram player for one detection.
    Returns the wrapper element; `wrap.refreshSpectrogram()` reloads the
    image after a server-side regenerate. */
export function spectrogramPlayer(detId, { size = "lg",
                                           rates = null } = {}) {
  const img = el("img", { alt: "spectrogram", draggable: "false",
    src: `/api/v2/spectrogram/${detId}?size=${size}` });
  const head = el("div", { class: "playhead" });
  const btn = el("button", { class: "play-overlay",
                             "aria-label": t("listen") }, "▶");
  const clock = el("span", { class: "play-clock" }, "");
  const audio = el("audio", { preload: "metadata",
    src: `/api/v2/audio/${detId}` });
  // playback-rate control (SpectrogramControls.svelte): essential for
  // bat clips — 256 kHz echolocation is only audible slowed 10-20x
  const rateList = rates || [0.05, 0.1, 0.25, 0.5, 1, 1.5, 2];
  const rateSel = el("select", { class: "play-rate",
                                 "aria-label": t("playback_rate") },
    rateList.map((r) => el("option", { value: String(r),
                                       ...(r === 1 ? { selected: "" } : {}) },
                           `${r}×`)));
  rateSel.addEventListener("click", (ev) => ev.stopPropagation());
  rateSel.addEventListener("change", () => {
    audio.preservesPitch = false;      // slowed bat calls must drop pitch
    audio.playbackRate = Number(rateSel.value);
  });
  const wrap = el("div", { class: "spec-player", tabindex: "0",
                           role: "group",
                           "aria-label": t("listen") },
                  img, head, btn, clock, rateSel, audio);

  // keyboard transport (reference ReviewModal bindings): space toggles,
  // arrows scrub ±1 s (shift: ±5 s), Home restarts
  wrap.addEventListener("keydown", (ev) => {
    if (ev.target === rateSel) return;
    const dur = audio.duration;
    if (ev.key === " " || ev.key === "k") {
      ev.preventDefault(); toggle();
    } else if (ev.key === "ArrowRight" && isFinite(dur)) {
      ev.preventDefault();
      audio.currentTime = Math.min(dur, audio.currentTime
                                   + (ev.shiftKey ? 5 : 1));
      paint();
    } else if (ev.key === "ArrowLeft" && isFinite(dur)) {
      ev.preventDefault();
      audio.currentTime = Math.max(0, audio.currentTime
                                   - (ev.shiftKey ? 5 : 1));
      paint();
    } else if (ev.key === "Home") {
      ev.preventDefault(); audio.currentTime = 0; paint();
    }
  });

  // a missing spectrogram must not kill the audio controls, and
  // Regenerate must be able to bring the image back
  const noImg = el("div", { class: "empty" }, t("no_spectrogram"));
  img.addEventListener("error", () => {
    img.style.display = "none";
    head.style.display = "none";
    if (!noImg.isConnected) wrap.prepend(noImg);
  });
  img.addEventListener("load", () => {
    img.style.display = "";
    head.style.display = "";
    noImg.remove();
  });
  audio.addEventListener("error", () => {
    btn.remove(); clock.remove(); rateSel.remove();
  });

  // click on the image seeks; the x fraction maps to clip time
  wrap.addEventListener("click", (ev) => {
    if (ev.target === btn) return;
    const r = img.getBoundingClientRect();
    if (!r.width || !isFinite(audio.duration) || !audio.duration) return;
    const frac = Math.min(1, Math.max(0, (ev.clientX - r.left) / r.width));
    audio.currentTime = frac * audio.duration;
    paint();
    if (audio.paused) toggle();
  });
  btn.addEventListener("click", (ev) => { ev.stopPropagation(); toggle(); });

  let raf = 0;
  const paint = () => {
    if (!isFinite(audio.duration) || !audio.duration) return;
    const frac = audio.currentTime / audio.duration;
    head.style.left = `${(frac * 100).toFixed(2)}%`;
    clock.textContent = `${audio.currentTime.toFixed(1)}s / `
      + `${audio.duration.toFixed(1)}s`;
  };
  const tick = () => {
    paint();
    if (!audio.paused) raf = requestAnimationFrame(tick);
  };
  audio.addEventListener("play", () => {
    btn.textContent = "⏸";
    // keep the playhead hidden while the spectrogram is missing — an
    // orphan line would sweep across the placeholder box
    if (img.style.display !== "none") head.style.display = "";
    raf = requestAnimationFrame(tick);
  });
  audio.addEventListener("pause", () => {
    btn.textContent = "▶";
    cancelAnimationFrame(raf);
    paint();
  });
  audio.addEventListener("ended", () => {
    btn.textContent = "▶";
    head.style.left = "0";
  });
  // navigation must stop playback — a detached <audio> keeps playing
  onCleanup(() => { audio.pause(); cancelAnimationFrame(raf); });

  function toggle() {
    if (audio.paused) audio.play().catch(() => {});
    else audio.pause();
  }
  wrap.refreshSpectrogram = () => {
    img.src = `/api/v2/spectrogram/${detId}?size=${size}&_=${Date.now()}`;
  };
  wrap.stopPlayback = () => audio.pause();
  return wrap;
}
