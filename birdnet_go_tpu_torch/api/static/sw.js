/* PWA service worker: pre-cache the app shell, cache-first for static
   assets, network-only for /api (live data must never be stale). */

const CACHE = "birdnet-tpu-v5";
const SHELL = [
  "/", "/static/app.css", "/static/app.js", "/static/i18n.js",
  "/static/charts.js", "/static/views/player.js",
  "/static/views/detail.js", "/static/views/help.js",
  "/static/views/dashboard.js", "/static/views/detections.js",
  "/static/views/analytics.js", "/static/views/settings.js",
  "/static/views/system.js", "/static/views/misc.js",
  "/static/views/alerts.js", "/static/views/range.js",
  "/static/views/onboarding.js", "/static/views/admin.js",
  "/static/views/search.js", "/static/views/about.js",
  "/static/views/reportbug.js",
];

self.addEventListener("install", (ev) => {
  ev.waitUntil(caches.open(CACHE)
    .then((c) => c.addAll(SHELL))
    .then(() => self.skipWaiting()));
});

self.addEventListener("activate", (ev) => {
  ev.waitUntil(caches.keys().then((keys) => Promise.all(
    keys.filter((k) => k !== CACHE).map((k) => caches.delete(k))))
    .then(() => self.clients.claim()));
});

self.addEventListener("fetch", (ev) => {
  const url = new URL(ev.request.url);
  if (ev.request.method !== "GET" || url.pathname.startsWith("/api/")
      || url.pathname === "/sw.js") return;   // live data: straight through
  if (url.pathname.startsWith("/static/") || SHELL.includes(url.pathname)) {
    // stale-while-revalidate: serve the cache instantly but ALWAYS
    // refetch in the background so server upgrades reach clients on the
    // next load (there is no build step to bump the cache name).
    ev.respondWith(caches.match(ev.request).then((hit) => {
      const refresh = fetch(ev.request).then((resp) => {
        if (!resp.ok) return resp;
        const copy = resp.clone();
        // the put must be INSIDE the chain waitUntil anchors — a
        // fire-and-forget put can be killed with the worker
        return caches.open(CACHE)
          .then((c) => c.put(ev.request, copy))
          .then(() => resp);
      });
      if (hit) {
        // anchor the revalidate: without waitUntil the worker may be
        // terminated before caches.put lands, and this refresh is the
        // ONLY upgrade path (no build-step cache-name bump)
        ev.waitUntil(refresh.catch(() => {}));
        return hit;
      }
      return refresh;
    }));
  }
});
