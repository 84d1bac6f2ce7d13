"""REST + SSE API server (subset of the reference's ~200 /api/v2 routes,
SURVEY.md Appendix A), running on a dedicated thread.

Route groups implemented: health/ping, detections (list/recent/get/delete/
review/lock/search + SSE stream), analytics (summary/daily/hourly/heatmap/
confidence histogram), streams health, system (info + inference status),
settings (GET/PATCH section merge + control signals), range filter
(status/list/rebuild/test), media (clips), models list, scheduler stats.

A copy of ``birdnet_go_tpu/api/server.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_api.py`` holds it to the
original. It serves on ``api/web.py``, the standard library's ``asyncio``
under aiohttp's names, where JAX's serves on aiohttp. Where it differs:

- ``system/info`` lists the torch devices the app serves on, each with
  its name (``cuda:0 NVIDIA H100 80GB HBM3``; ``cpu`` on the CPU), where
  JAX lists ``jax.devices()``;
- ``system/inference`` names the port's backend, ``torch-<device type>``
  (``torch-cuda``), where JAX names ``jax-tpu``;
- ``_ssl_context`` builds JAX's HTTPS (ACME or a self-signed pair, with
  JAX's two fall-backs) over ``utils/acme.py`` and ``utils/tlscert.py``,
  the port's copies, whose ACME client speaks over ``UrllibSession``;
- ``port`` is the port bound once ``start`` returns, which port 0
  leaves to the OS, and ``stop`` ends open streams at once (JAX's
  waits for them until its thread's join times out).
"""

from __future__ import annotations

import asyncio
import csv
import functools
import datetime as _dt
import io
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

import torch

from birdnet_go_tpu_torch.api import web
from birdnet_go_tpu_torch.api.handlers_ext import ExtendedHandlers
from birdnet_go_tpu_torch.api.security import (
    AuthHandlers,
    SecurityManager,
    gzip_middleware,
    http_metrics_middleware,
    secure_headers_middleware,
    security_middleware,
)
from birdnet_go_tpu_torch.api.sse import SseBroadcaster, format_sse
from birdnet_go_tpu_torch.api.terminal import TerminalHandlers
from birdnet_go_tpu_torch.version import __version__

log = logging.getLogger("birdnet_tpu.api")


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status, dumps=lambda d: json.dumps(
        d, default=str))


_SECRET_KEY_HINTS = ("password", "secret", "token", "api_key")


def _strip_masked(obj):
    """Drop "***" sentinel values from inbound settings bodies — the UI
    round-trips GET /settings (which masks credentials), so a save must
    never overwrite a real secret with the mask."""
    if isinstance(obj, dict):
        return {k: _strip_masked(v) for k, v in obj.items() if v != "***"}
    if isinstance(obj, list):
        return [_strip_masked(v) for v in obj]
    return obj


def _scrub_secrets(obj):
    """Settings responses never echo credentials (reference: secrets
    redaction in the settings API / support bundles)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(v, str) and v \
                    and any(h in k.lower() for h in _SECRET_KEY_HINTS) \
                    and not k.lower().endswith("_file"):
                out[k] = "***"
            else:
                out[k] = _scrub_secrets(v)
        return out
    if isinstance(obj, list):
        return [_scrub_secrets(v) for v in obj]
    return obj


class ApiServer(ExtendedHandlers, AuthHandlers, TerminalHandlers):
    """HTTP server bound to an Application (birdnet_go_tpu_torch.app)."""

    def __init__(self, app_ctx: Any, host: str = "0.0.0.0", port: int = 8080):
        self.ctx = app_ctx
        self.host = host
        self.port = port
        self.sse = SseBroadcaster()
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._runner: web.AppRunner | None = None
        self.started_at = time.time()

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="api-server",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=15):
            raise RuntimeError("API server failed to start")

    def stop(self) -> None:
        loop = self._loop
        self._loop = None                   # idempotent: second stop no-ops
        if loop is not None and loop.is_running():
            async def _shutdown():
                if self._runner is not None:
                    await self._runner.cleanup()
                loop.stop()

            asyncio.run_coroutine_threadsafe(_shutdown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self.sse.bind(loop)
        app = self.build_app()
        self._runner = web.AppRunner(app)
        loop.run_until_complete(self._runner.setup())
        ssl_ctx = self._ssl_context()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=ssl_ctx)
        loop.run_until_complete(site.start())
        self.port = site.port
        log.info("API listening on %s://%s:%d",
                 "https" if ssl_ctx else "http", self.host, self.port)
        self._started.set()
        loop.run_forever()
        loop.close()

    def _ssl_context(self):
        """HTTPS when webserver.tls_enabled: ACME (Let's Encrypt) when
        tls_mode == "acme" (reference AutoTLS, server.go:601-633), else
        the installed certificate or an auto-generated self-signed pair
        (internal/tls generate.go)."""
        ws = self.ctx.settings.webserver
        if not getattr(ws, "tls_enabled", False):
            return None
        if getattr(ws, "tls_mode", "self-signed") == "acme" \
                and getattr(ws, "acme_domain", ""):
            import ssl

            from birdnet_go_tpu_torch.utils.acme import (
                GLOBAL_RESPONDER,
                LETS_ENCRYPT,
                AutoTlsManager,
            )

            try:
                mgr = AutoTlsManager(
                    ws.tls_dir, ws.acme_domain,
                    directory_url=getattr(ws, "acme_directory", "")
                    or LETS_ENCRYPT,
                    contact=getattr(ws, "acme_contact", "") or None)
                cert, key = mgr.ensure(GLOBAL_RESPONDER)
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(cert, key)
                return ctx
            except Exception:
                log.exception("ACME setup failed — falling back to "
                              "self-signed")
        from birdnet_go_tpu_torch.utils.tlscert import TLSManager

        mgr = TLSManager(ws.tls_dir)
        try:
            mgr.ensure_self_signed(host=ws.host, base_url=ws.base_url)
            return mgr.ssl_context()
        except Exception:
            log.exception("TLS setup failed — serving plain HTTP")
            return None

    # -- app/routes ----------------------------------------------------------------

    def build_app(self) -> web.Application:
        ws = self.ctx.settings.webserver
        middlewares = []
        self.security = SecurityManager(self.ctx.settings)
        if self.security.enabled:
            middlewares.append(security_middleware(
                self.security,
                allow_local_bypass=ws.allow_local_bypass))
        middlewares.append(http_metrics_middleware)
        if getattr(ws, "secure_headers", True):
            middlewares.append(secure_headers_middleware)
        if getattr(ws, "gzip", True):
            middlewares.append(gzip_middleware)
        app = web.Application(middlewares=middlewares)
        r = app.router
        v2 = "/api/v2"
        self.register_auth_routes(r, v2)
        self.register_terminal_routes(r, v2)
        # Extended groups FIRST: static segments like /detections/new must
        # register before the dynamic /detections/{id} below.
        self.register_ext_routes(r, v2)
        r.add_get(f"{v2}/health", self.h_health)
        r.add_get(f"{v2}/ping", self.h_ping)
        # ACME HTTP-01 (RFC 8555): served unauthenticated for AutoTLS
        r.add_get("/.well-known/acme-challenge/{token}",
                  self.h_acme_challenge)
        # detections
        r.add_get(f"{v2}/detections", self.h_detections)
        r.add_get(f"{v2}/detections/recent", self.h_recent)
        r.add_get(f"{v2}/detections/stream", self.h_detections_stream)
        r.add_get(f"{v2}/detections/export", self.h_detections_export)
        r.add_get(f"{v2}/detections/{{id}}", self.h_detection)
        r.add_delete(f"{v2}/detections/{{id}}", self.h_delete_detection)
        r.add_post(f"{v2}/detections/{{id}}/review", self.h_review)
        r.add_post(f"{v2}/detections/{{id}}/lock", self.h_lock)
        r.add_post(f"{v2}/detections/search", self.h_search)
        # reference route shape (detections/handler.go:123 g.POST("/search"))
        r.add_post(f"{v2}/search", self.h_search)
        # batch operations (detections/detections_batch.go, handler.go:162-166)
        r.add_post(f"{v2}/detections/batch/delete", self.h_batch_delete)
        r.add_post(f"{v2}/detections/batch/review", self.h_batch_review)
        r.add_post(f"{v2}/detections/batch/lock", self.h_batch_lock)
        r.add_post(f"{v2}/detections/batch/resolve", self.h_batch_resolve)
        # analytics
        r.add_get(f"{v2}/analytics/summary", self.h_summary)
        r.add_get(f"{v2}/analytics/daily", self.h_daily)
        r.add_get(f"{v2}/analytics/hourly", self.h_hourly)
        # reference route-group aliases (api.go analytics/distribution/*)
        r.add_get(f"{v2}/analytics/distribution/hourly", self.h_hourly)
        r.add_get(f"{v2}/analytics/distribution/species",
                  self.h_species_distribution)
        r.add_get(f"{v2}/analytics/heatmap", self.h_heatmap)
        r.add_get(f"{v2}/analytics/confidence", self.h_confidence)
        r.add_get(f"{v2}/analytics/species/first-seen", self.h_first_seen)
        r.add_get(f"{v2}/analytics/phenology/{{species}}", self.h_phenology)
        r.add_get(f"{v2}/analytics/year-over-year", self.h_yoy)
        r.add_get(f"{v2}/analytics/accumulation", self.h_accumulation)
        r.add_get(f"{v2}/analytics/diversity", self.h_diversity)
        r.add_get(f"{v2}/analytics/time-of-day", self.h_tod_species)
        r.add_get(f"{v2}/analytics/species-daily-trend",
                  self.h_species_daily_trend)
        # live audio + levels (reference: HLS live audio + audio-level SSE;
        # here a chunked streaming-WAV endpoint browsers play natively)
        r.add_get(f"{v2}/audio/live/{{source}}", self.h_audio_live)
        r.add_get(f"{v2}/streams/audio-level", self.h_audio_level_stream)
        r.add_get(f"{v2}/soundlevels/stream", self.h_soundlevels_stream)
        r.add_post(f"{v2}/system/restart", self.h_restart)
        r.add_get("/manifest.json", self.h_pwa_manifest)
        r.add_get(f"{v2}/sun/{{date}}", self.h_sun_times)
        # streams / system
        r.add_get(f"{v2}/streams/health", self.h_streams_health)
        r.add_get(f"{v2}/system/info", self.h_system_info)
        r.add_get(f"{v2}/system/inference", self.h_inference_status)
        r.add_get(f"{v2}/system/inference/spans", self.h_inference_spans)
        r.add_get(f"{v2}/system/scheduler", self.h_scheduler_stats)
        # settings
        r.add_get(f"{v2}/settings", self.h_get_settings)
        r.add_patch(f"{v2}/settings/{{section}}", self.h_patch_settings)
        # range filter
        r.add_get(f"{v2}/range/status", self.h_range_status)
        r.add_get(f"{v2}/range/species/list", self.h_range_list)
        r.add_post(f"{v2}/range/rebuild", self.h_range_rebuild)
        r.add_post(f"{v2}/range/species/test", self.h_range_test)
        r.add_get(f"{v2}/range/heatmap", self.h_range_heatmap)
        # alerts
        r.add_get(f"{v2}/alerts/rules", self.h_alert_rules)
        r.add_post(f"{v2}/alerts/rules", self.h_alert_rule_create)
        r.add_delete(f"{v2}/alerts/rules/{{id}}", self.h_alert_rule_delete)
        r.add_post(f"{v2}/alerts/rules/{{id}}/test", self.h_alert_rule_test)
        r.add_get(f"{v2}/alerts/history", self.h_alert_history)
        # models / media
        r.add_get(f"{v2}/models", self.h_models)
        r.add_get(f"{v2}/models/catalog", self.h_models_catalog)
        r.add_get(f"{v2}/models/installed", self.h_models_installed)
        r.add_post(f"{v2}/models/load/{{id}}", self.h_model_load)
        r.add_post(f"{v2}/models/unload/{{id}}", self.h_model_unload)
        # {filename:.+} admits the clips' year/month subpaths; the
        # sandbox resolver rejects traversal
        r.add_get(f"{v2}/media/audio/{{filename:.+}}", self.h_media_audio)
        r.add_get(f"{v2}/media/spectrogram/{{filename:.+}}",
                  self.h_media_spectrogram)
        r.add_get(f"{v2}/spectrogram/{{id}}", self.h_spectrogram_by_id)
        # embedded SPA (reference: frontend/ Svelte app via embed.go;
        # here a no-build single-file dashboard)
        r.add_get("/", self.h_index)
        r.add_get("/sw.js", self.h_service_worker)   # PWA worker, root scope
        r.add_get("/ui", self.h_index)
        r.add_get("/ui/{tail:.*}", self.h_index)     # SPA deep links
        r.add_static("/static/", Path(__file__).parent / "static",
                     append_version=False)
        # observability
        r.add_get("/metrics", self.h_metrics)
        r.add_get(f"{v2}/system/errors", self.h_recent_errors)
        r.add_get(f"{v2}/system/resources", self.h_resources)
        r.add_get(f"{v2}/settings/schema", self.h_settings_schema)
        r.add_get(f"{v2}/species/dictionary/{{locale}}", self.h_species_dict)
        r.add_get(f"{v2}/detections/{{id}}/time-of-day", self.h_time_of_day)
        r.add_get(f"{v2}/species/first-seen/{{scientific}}",
                  self.h_species_first_seen)
        r.add_get(f"{v2}/weather/hourly/{{date}}", self.h_weather_hourly)
        return app

    # -- handlers: core ----------------------------------------------------------------

    async def h_health(self, request):
        checks = []
        healthy = True
        registry = getattr(self.ctx, "health", None)
        if registry is not None:
            import asyncio as _aio
            import dataclasses as dc

            results = await _aio.get_event_loop().run_in_executor(
                None, registry.run_all)
            checks = [dc.asdict(r) for r in results]
            healthy = all(r.healthy for r in results)
        return _json({
            "status": "healthy" if healthy else "degraded",
            "version": __version__,
            "uptime_seconds": round(time.time() - self.started_at, 1),
            "checks": checks,
        })

    async def h_acme_challenge(self, request):
        from birdnet_go_tpu_torch.utils.acme import GLOBAL_RESPONDER

        key_auth = GLOBAL_RESPONDER.get(request.match_info["token"])
        if key_auth is None:
            return web.Response(status=404, text="no such challenge")
        return web.Response(text=key_auth,
                            content_type="application/octet-stream")

    async def h_ping(self, request):
        return _json({"pong": True, "time": _dt.datetime.now().isoformat()})

    # -- handlers: detections -------------------------------------------------------------

    def _detection_query(self, q) -> dict:
        return dict(
            species=q.get("species"),
            date_from=q.get("from"), date_to=q.get("to"),
            source_id=q.get("source"),
            min_confidence=(float(q["min_confidence"])
                            if "min_confidence" in q else None),
            limit=min(int(q.get("limit", 100)), 1000),
            offset=int(q.get("offset", 0)),
            order=q.get("order", "desc"),
        )

    @staticmethod
    def _annotate_nonbird(rows):
        """Tag non-taxa sound classes so the UI can badge them instead of
        rendering them as species (labels/nonbird role)."""
        from birdnet_go_tpu_torch.taxonomy import nonbird

        for r in rows:
            cat = nonbird.category_of_parsed(
                r.get("scientific_name", ""), r.get("common_name", ""))
            if cat:
                r["nonbird_category"] = cat
        return rows

    async def h_detections(self, request):
        rows = self._annotate_nonbird(self.ctx.datastore.search_detections(
            **self._detection_query(request.query)))
        return _json({"detections": rows, "count": len(rows)})

    async def h_recent(self, request):
        limit = min(int(request.query.get("limit", 10)), 100)
        return _json(self._annotate_nonbird(
            self.ctx.datastore.recent_detections(limit)))

    async def h_detection(self, request):
        row = self.ctx.datastore.get_detection(int(request.match_info["id"]))
        if row is None:
            return _json({"error": "not found"}, status=404)
        return _json(self._annotate_nonbird([row])[0])

    async def h_delete_detection(self, request):
        try:
            ok = self.ctx.datastore.delete_detection(
                int(request.match_info["id"]))
        except PermissionError as e:
            return _json({"error": str(e)}, status=409)
        if not ok:
            return _json({"error": "not found"}, status=404)
        return _json({"deleted": True})

    async def h_review(self, request):
        body = await request.json()
        verdict = body.get("verdict", "")
        try:
            rid = self.ctx.datastore.review_detection(
                int(request.match_info["id"]), verdict,
                body.get("comment", ""))
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        return _json({"review_id": rid})

    async def h_lock(self, request):
        body = await request.json() if request.can_read_body else {}
        locked = bool(body.get("locked", True))
        ok = self.ctx.datastore.lock_detection(
            int(request.match_info["id"]), locked)
        if not ok:
            return _json({"error": "not found"}, status=404)
        return _json({"locked": locked})

    # -- batch operations (detections_batch.go) ------------------------------------

    _MAX_BATCH = 500   # detections_batch.go:26 maxBatchSize

    @staticmethod
    def _batch_ids(body):
        """Validate + dedupe a batch id list (deduplicateIDs +
        size guards, detections_batch.go:13-23,68-82). Returns
        (ids, error_response)."""
        ids = body.get("ids") or []
        if not ids:
            return None, _json({"error": "at least one id is required"},
                               status=400)
        if len(ids) > ApiServer._MAX_BATCH:
            return None, _json(
                {"error": f"batch size {len(ids)} exceeds maximum "
                 f"{ApiServer._MAX_BATCH}"}, status=400)
        seen, out = set(), []
        for i in ids:
            try:
                n = int(i)
            except (TypeError, ValueError):
                continue
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out, None

    async def h_batch_delete(self, request):
        """POST /detections/batch/delete — locked and missing rows are
        counted as skipped, never an error (detections_batch.go:68-119).
        Clip files are reclaimed by the orphan-reconcile pass, matching
        the single-delete path."""
        ids, err = self._batch_ids(await request.json())
        if err:
            return err
        ds = self.ctx.datastore
        processed = skipped = 0
        for det_id in ids:
            try:
                ok = ds.delete_detection(det_id)
            except PermissionError:      # locked
                skipped += 1
                continue
            processed += 1 if ok else 0
            skipped += 0 if ok else 1
        return _json({"processed": processed, "skipped": skipped})

    async def h_batch_review(self, request):
        """POST /detections/batch/review — one verdict applied to many;
        locked rows skipped (detections_batch.go:122-178)."""
        body = await request.json()
        verdict = body.get("verified") or body.get("verdict") or ""
        if verdict not in ("correct", "false_positive"):
            return _json({"error": "verified must be correct or"
                          " false_positive"}, status=400)
        ids, err = self._batch_ids(body)
        if err:
            return err
        ds = self.ctx.datastore
        processed = skipped = 0
        for det_id in ids:
            row = ds.get_detection(det_id)
            if row is None or row.get("locked"):
                skipped += 1
                continue
            ds.review_detection(det_id, verdict,
                                body.get("comment", ""))
            processed += 1
        return _json({"processed": processed, "skipped": skipped})

    async def h_batch_lock(self, request):
        """POST /detections/batch/lock — already-locked rows are skipped
        when locking; unlock processes everything
        (detections_batch.go:181-229)."""
        body = await request.json()
        locked = bool(body.get("locked", True))
        ids, err = self._batch_ids(body)
        if err:
            return err
        ds = self.ctx.datastore
        processed = skipped = 0
        for det_id in ids:
            row = ds.get_detection(det_id)
            if row is None or (locked and row.get("locked")):
                skipped += 1
                continue
            ds.lock_detection(det_id, locked)
            processed += 1
        return _json({"processed": processed, "skipped": skipped})

    async def h_batch_resolve(self, request):
        """POST /detections/batch/resolve — turn a filter query into an
        id list for a follow-up batch call; refuses over-broad queries
        (detections_batch.go:232-299). queryType species/search/hourly
        is auto-inferred from the populated field like detections.go
        341-348."""
        body = await request.json()
        hour_from = hour_to = None
        hour = str(body.get("hour", "") or "")
        if hour:
            try:
                h = int(hour)
            except ValueError:
                return _json({"error": "invalid hour"}, status=400)
            if not 0 <= h <= 23:
                return _json({"error": "invalid hour"}, status=400)
            duration = max(1, int(body.get("duration", 1) or 1))
            hour_from, hour_to = h, (h + duration - 1) % 24
        rows, total = self.ctx.datastore.search_detections(
            species=body.get("species") or body.get("search") or None,
            date_from=body.get("date") or None,
            date_to=body.get("date") or None,
            hour_from=hour_from, hour_to=hour_to,
            limit=self._MAX_BATCH + 1, with_total=True)
        if total > self._MAX_BATCH:
            return _json(
                {"error": f"query matched {total} detections, maximum "
                 f"is {self._MAX_BATCH}; narrow the filters"},
                status=400)
        ids = [str(r["id"]) for r in rows]
        return _json({"ids": ids, "count": len(ids)})

    async def h_search(self, request):
        """POST /detections/search (reference also exposes it as
        POST /api/v2/search — detections/search.go HandleSearch):
        adds time_of_day bands, exact scientific-name expansion,
        multi-key sort, and total/pages for the pager."""
        body = await request.json()
        tod = body.get("time_of_day") or body.get("timeOfDay")
        if isinstance(tod, str):
            tod = [tod] if tod and tod != "any" else None
        sort_by = body.get("sort_by") or body.get("sortBy")
        if sort_by is not None and sort_by not in (
                self.ctx.datastore._SORTS):
            return _json({"error": f"invalid sort_by '{sort_by}'"},
                         status=400)
        if tod:
            bad = [t for t in tod
                   if t.lower() not in ("dawn", "day", "dusk", "night")]
            if bad:
                return _json(
                    {"error": f"invalid time_of_day {bad}; use "
                     "dawn/day/dusk/night"}, status=400)
        limit = min(int(body.get("limit", 100)), 1000)
        offset = int(body.get("offset", 0))
        rows, total = self.ctx.datastore.search_detections(
            species=body.get("species"),
            species_scientific=body.get("species_scientific")
            or body.get("speciesScientific"),
            date_from=body.get("from"), date_to=body.get("to"),
            source_id=body.get("source"),
            model_id=body.get("model"),
            min_confidence=body.get("min_confidence"),
            max_confidence=body.get("max_confidence"),
            hour_from=body.get("hour_from"), hour_to=body.get("hour_to"),
            verified=body.get("verified"), locked=body.get("locked"),
            time_of_day=tod, sort_by=sort_by,
            limit=limit, offset=offset,
            order=body.get("order", "desc"), with_total=True)
        return _json({"detections": self._annotate_nonbird(rows),
                      "count": len(rows), "total": total,
                      "pages": (total + limit - 1) // limit if limit
                      else 1})

    async def h_detections_export(self, request):
        """CSV export of the filtered detection table. The reference's
        import-export page lists detections export as planned
        (frontend .../import-export/pages/ImportExportPage.svelte,
        'comingSoon' badge); this implements it with the same filter
        surface as POST /detections/search."""
        q = request.query
        fmt = q.get("format", "csv")
        if fmt != "csv":
            return _json({"error": "format must be csv"}, status=400)

        def _f(name):
            v = q.get(name)
            return float(v) if v not in (None, "") else None

        def _i(name):
            v = q.get(name)
            return int(v) if v not in (None, "") else None

        def _build_csv() -> str:
            rows = self.ctx.datastore.search_detections(
                species=q.get("species") or None,
                date_from=q.get("from") or None, date_to=q.get("to") or None,
                source_id=q.get("source") or None,
                model_id=q.get("model") or None,
                min_confidence=_f("min_confidence"),
                max_confidence=_f("max_confidence"),
                hour_from=_i("hour_from"), hour_to=_i("hour_to"),
                verified=q.get("verified") or None,
                locked={"true": True, "false": False}.get(q.get("locked")),
                time_of_day=[b for b in
                             q.get("time_of_day", "").split(",") if b]
                or None,
                sort_by=q.get("sort_by") or None,
                limit=max(1, min(int(q.get("limit", 100000)), 1000000)),
                order=q.get("order", "desc"))
            buf = io.StringIO()
            w = csv.writer(buf)
            cols = ["id", "date", "time", "scientific_name", "common_name",
                    "species_code", "confidence", "source_id", "model_id",
                    "verdict", "locked", "clip_name"]
            w.writerow(cols)
            for row in rows:
                w.writerow([row.get(c, "") for c in cols])
            return buf.getvalue()

        try:
            # off the event loop: a 100k-row export must not stall SSE
            # heartbeats and live-audio handlers
            body_text = await asyncio.get_event_loop().run_in_executor(
                None, _build_csv)
        except (TypeError, ValueError) as e:
            return _json({"error": f"bad filter: {e}"}, status=400)
        day = _dt.date.today().isoformat()
        return web.Response(
            text=body_text, content_type="text/csv",
            headers={"Content-Disposition":
                     f'attachment; filename="detections_{day}.csv"'})

    async def h_detections_stream(self, request):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        q = self.sse.subscribe("detections")
        try:
            await resp.write(format_sse("connected", "{}"))
            while True:
                try:
                    event, payload = await asyncio.wait_for(q.get(),
                                                            timeout=30)
                    await resp.write(format_sse(event, payload))
                except asyncio.TimeoutError:
                    await resp.write(b": keepalive\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self.sse.unsubscribe("detections", q)
        return resp

    async def h_audio_live(self, request):
        """Live listening: an endless chunked WAV whose body is filled from
        the source's capture ring every 250 ms. Browsers play it directly
        (<audio src=...>); covers the reference's HLS live-audio use case
        without an external segmenter."""
        import asyncio as _aio
        import struct
        import time as _time

        source = request.match_info["source"]
        cb = self.ctx.engine.capture_buffer(source)
        if cb is None:
            return _json({"error": "unknown source"}, status=404)
        rate = cb.sample_rate

        # ?format=opus → live Ogg Opus via the persistent native encoder
        # (csrc/codecs.cpp): ~16× less bandwidth than PCM WAV, playable
        # natively by Chrome/Firefox. Falls back to WAV when libopus is
        # absent or the rate is not Opus-valid (256 kHz bat sources).
        want_opus = request.query.get("format") == "opus"
        streamer = None
        if want_opus:
            try:
                from birdnet_go_tpu_torch.audio.opusogg import OggOpusStreamer

                streamer = OggOpusStreamer(rate)
            except RuntimeError:
                streamer = None
        resp = web.StreamResponse(headers={
            "Content-Type": "audio/ogg" if streamer else "audio/wav",
            "Cache-Control": "no-store",
        })
        await resp.prepare(request)
        if streamer is None:
            # WAV header with a maximal data length (streaming: no real end)
            hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                   + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate,
                                           rate * 2, 2, 16)
                   + b"data" + struct.pack("<I", 0xFFFFFFFF))
            await resp.write(hdr)
        else:
            await resp.write(streamer.header_pages())
        chunk_s = 0.25
        cursor = _time.time() - chunk_s
        loop = _aio.get_event_loop()
        try:
            while True:
                now = _time.time()
                if now - cursor < chunk_s:
                    await _aio.sleep(chunk_s - (now - cursor))
                pcm = cb.read_segment(cursor, cursor + chunk_s)
                cursor += chunk_s
                if streamer is not None:
                    data = await loop.run_in_executor(
                        None, streamer.feed, pcm)
                    if data:
                        await resp.write(data)
                else:
                    await resp.write(pcm.astype("<i2").tobytes())
        except (ConnectionResetError, _aio.CancelledError):
            pass
        finally:
            if streamer is not None:
                streamer.close()
        return resp

    async def h_audio_level_stream(self, request):
        """SSE of per-source RMS/peak levels (reference:
        GET /streams/audio-level)."""
        import asyncio as _aio
        import json as _json_mod
        import time as _time

        import numpy as np

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        try:
            while True:
                levels = {}
                for src in self.ctx.engine.sources():
                    cb = self.ctx.engine.capture_buffer(src.source_id)
                    if cb is None:
                        continue
                    now = _time.time()
                    pcm = cb.read_segment(now - 0.5, now).astype(np.float32) \
                        / 32768.0
                    if not len(pcm):
                        continue
                    rms = float(np.sqrt(np.mean(pcm ** 2)))
                    peak = float(np.max(np.abs(pcm)))
                    levels[src.source_id] = {
                        "rms_db": round(20 * np.log10(rms + 1e-9), 1),
                        "peak_db": round(20 * np.log10(peak + 1e-9), 1),
                        "clipping": peak >= 0.999,
                    }
                from birdnet_go_tpu_torch.api.sse import format_sse

                await resp.write(format_sse(
                    "audio-level", _json_mod.dumps(levels)))
                await _aio.sleep(1.0)
        except (ConnectionResetError, _aio.CancelledError):
            pass
        return resp

    async def h_soundlevels_stream(self, request):
        """SSE of 1/3-octave band levels (reference: /soundlevels/stream)."""
        import asyncio as _aio

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        q = self.sse.subscribe("soundlevels")
        try:
            await resp.write(format_sse("connected", "{}"))
            while True:
                try:
                    event, payload = await _aio.wait_for(q.get(), timeout=30)
                    await resp.write(format_sse(event, payload))
                except _aio.TimeoutError:
                    await resp.write(b": keepalive\n\n")
        except (ConnectionResetError, _aio.CancelledError):
            pass
        finally:
            self.sse.unsubscribe("soundlevels", q)
        return resp

    async def h_restart(self, request):
        """In-place restart (reference: internal/restart — re-exec or
        container exit; here SIGTERM to self so supervisors restart us)."""
        import asyncio as _aio
        import os
        import signal as _signal

        async def _later():
            await _aio.sleep(0.5)
            os.kill(os.getpid(), _signal.SIGTERM)

        _aio.get_event_loop().create_task(_later())
        return _json({"restarting": True})

    async def h_pwa_manifest(self, request):
        return _json({
            "name": "BirdNET-TPU",
            "short_name": "BirdNET",
            "start_url": "/",
            "display": "standalone",
            "background_color": "#0f1419",
            "theme_color": "#0f1419",
            "icons": [],
        })

    async def h_sun_times(self, request):
        import datetime as dt

        from birdnet_go_tpu_torch.utils.suncalc import sun_times

        loc = self.ctx.settings.location
        if loc.latitude is None:
            return _json({"error": "location not configured"}, status=400)
        try:
            date = dt.date.fromisoformat(request.match_info["date"])
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        st = sun_times(date, loc.latitude, loc.longitude)
        return _json({
            "sunrise": st.sunrise, "sunset": st.sunset,
            "civil_dawn": st.civil_dawn, "civil_dusk": st.civil_dusk,
            "polar": st.polar,
        })

    # -- handlers: analytics ----------------------------------------------------------------

    async def h_summary(self, request):
        return _json(self.ctx.datastore.species_summary(
            request.query.get("from"), request.query.get("to")))

    async def h_daily(self, request):
        today = _dt.date.today()
        dfrom = request.query.get("from",
                                  (today - _dt.timedelta(days=30)).isoformat())
        dto = request.query.get("to", today.isoformat())
        return _json(self.ctx.datastore.daily_counts(dfrom, dto))

    async def h_hourly(self, request):
        return _json(self.ctx.datastore.hourly_distribution(
            request.query.get("date"), request.query.get("species")))

    async def h_species_distribution(self, request):
        """Detection-count distribution across species (reference:
        analytics/distribution/species)."""
        limit = min(int(request.query.get("limit", 50)), 500)
        rows = self.ctx.datastore.species_summary()[:limit]
        return _json({"species": rows})

    async def h_heatmap(self, request):
        today = _dt.date.today()
        dfrom = request.query.get("from",
                                  (today - _dt.timedelta(days=30)).isoformat())
        dto = request.query.get("to", today.isoformat())
        data = self.ctx.datastore.detection_heatmap(dfrom, dto)
        if request.query.get("format", "").lower() == "csv":
            # non-zero cells only, one row per (date, hour) — reference:
            # analytics.go writeActivityHeatmapCSV
            lines = ["date,hour,count"]
            for date in sorted(data):
                for hour, n in enumerate(data[date]):
                    if n:
                        lines.append(f"{date},{hour},{n}")
            return web.Response(
                text="\n".join(lines) + "\n", content_type="text/csv",
                headers={"Content-Disposition":
                         'attachment; filename="heatmap.csv"'})
        return _json(data)

    async def h_confidence(self, request):
        return _json(self.ctx.datastore.confidence_histogram())

    async def h_first_seen(self, request):
        return _json(self.ctx.datastore.new_species_first_seen())

    async def h_phenology(self, request):
        year = request.query.get("year")
        return _json(self.ctx.datastore.phenology(
            request.match_info["species"],
            int(year) if year else None))

    async def h_yoy(self, request):
        return _json(self.ctx.datastore.year_over_year(
            request.query.get("species")))

    def _date_range(self, q):
        today = _dt.date.today()
        return (q.get("from", (today - _dt.timedelta(days=365)).isoformat()),
                q.get("to", today.isoformat()))

    async def h_accumulation(self, request):
        dfrom, dto = self._date_range(request.query)
        return _json(self.ctx.datastore.species_accumulation(dfrom, dto))

    async def h_diversity(self, request):
        dfrom, dto = self._date_range(request.query)
        return _json(self.ctx.datastore.diversity(dfrom, dto))

    @staticmethod
    def _top_n(q, default: int) -> int:
        """Clamp the ?top= query param to [1, 50]; 400 on non-numeric."""
        raw = q.get("top", default)
        try:
            return max(1, min(int(raw), 50))
        except (TypeError, ValueError):
            raise web.HTTPBadRequest(text='{"error": "top must be an '
                                     'integer"}', content_type="application/json")

    async def h_tod_species(self, request):
        """Top-N species 24-hour activity profiles (reference
        TimeOfDaySpeciesChart / SpeciesRidgeline analytics components);
        ?species= narrows to one species (drill-down diel clock)."""
        dfrom, dto = self._date_range(request.query)
        top = self._top_n(request.query, 8)
        return _json({"species": self.ctx.datastore.time_of_day_species(
            dfrom, dto, top, species=request.query.get("species"))})

    async def h_species_daily_trend(self, request):
        """Top-N species daily counts (reference DailySpeciesTrendChart /
        SeasonalHeatmap analytics components)."""
        dfrom, dto = self._date_range(request.query)
        top = self._top_n(request.query, 5)
        return _json({"from": dfrom, "to": dto,
                      "species": self.ctx.datastore.species_daily_trend(
                          dfrom, dto, top)})

    # -- handlers: system/streams --------------------------------------------------------------

    async def h_streams_health(self, request):
        return _json(self.ctx.engine.stream_health())

    def _devices(self) -> list[str]:
        """The torch devices the app serves on, each with its name: every
        card where it serves over a mesh."""
        dev = self.ctx.device
        if dev.type != "cuda":
            return [str(dev)]
        idx = (range(torch.cuda.device_count()) if self.ctx._mesh is not None
               else [dev.index or 0])
        return [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in idx]

    def _backend(self) -> str:
        return f"torch-{self.ctx.device.type}"

    async def h_system_info(self, request):
        import platform

        from birdnet_go_tpu_torch.utils.sysinfo import environment_summary

        return _json({
            "version": __version__,
            "platform": platform.platform(),
            "python": platform.python_version(),
            "devices": self._devices(),
            "uptime_seconds": round(time.time() - self.started_at, 1),
            "sources": [s.source_id for s in self.ctx.engine.sources()],
            **environment_summary(),
        })

    async def h_inference_spans(self, request):
        """Per-dispatch prediction spans (classifier/tracing.go role)."""
        from birdnet_go_tpu_torch.utils.tracing import GLOBAL_SPANS

        limit = min(int(request.query.get("limit", 50)), 500)
        return _json({"summary": GLOBAL_SPANS.summary(),
                      "spans": GLOBAL_SPANS.recent(limit)})

    async def h_inference_status(self, request):
        out = []
        for model_id, b in self.ctx.device_loop.batchers.items():
            out.append({
                "model_id": model_id,
                "backend": self._backend(),
                "batch_size": b.max_batch,
                "windows_processed": b.stats.windows_processed,
                "last_latency_ms": b.stats.last_latency_ms,
                "overruns": b.stats.overruns,
                "realtime_budget_ms": b.budget_seconds * 1000,
            })
        return _json(out)

    async def h_scheduler_stats(self, request):
        # capacity_info: configured per-model device ceiling (max_batch ×
        # max_dispatches_per_tick / tick) so operators can compare shipped
        # capacity vs the bench headline (VERDICT r2 #10)
        return _json({
            **self.ctx.device_loop.capacity_info(),
            "running": self.ctx.device_loop._thread is not None,
            "ticks": self.ctx.device_loop.ticks,
            "processor": {
                "results_processed": self.ctx.processor.stats.results_processed,
                "approved": self.ctx.processor.stats.detections_approved,
                "discarded": self.ctx.processor.stats.detections_discarded,
                "discard_reasons": self.ctx.processor.stats.discard_reasons,
                "pending": len(self.ctx.processor.pending_snapshot()),
            },
            "jobqueue": vars(self.ctx.jobqueue.stats),
        })

    # -- handlers: settings ---------------------------------------------------------------------

    async def h_get_settings(self, request):
        import dataclasses

        return _json(_scrub_secrets(dataclasses.asdict(self.ctx.settings)))

    async def h_patch_settings(self, request):
        """Section merge + control signal (reference: settings PATCH →
        control channel signals, api/v2/settings.go)."""
        import dataclasses

        from birdnet_go_tpu_torch.config.control import ControlSignal
        from birdnet_go_tpu_torch.config.settings import _merge_dataclass

        section = request.match_info["section"]
        if not hasattr(self.ctx.settings, section):
            return _json({"error": f"unknown section {section!r}"},
                         status=404)
        body = _strip_masked(await request.json())
        target = getattr(self.ctx.settings, section)
        # Snapshot for rollback: a type-mismatched value must 400 and
        # leave the live tree untouched, never corrupt it and 500 in a
        # later validate() (found by the SPA runtime gate).
        import copy

        from birdnet_go_tpu_torch.config.settings import restore_settings_in_place
        snapshot = copy.deepcopy(self.ctx.settings)
        try:
            if section == "models" and isinstance(body, list):
                # the models section is a LIST of ModelSettings — raw
                # dicts would corrupt settings and crash validate() (same
                # special case as the full PUT path)
                from birdnet_go_tpu_torch.config.settings import ModelSettings

                self.ctx.settings.models = [
                    _merge_dataclass(ModelSettings(), v) for v in body]
            elif section == "models":
                return _json({"error": "models section must be a list"},
                             status=400)
            elif dataclasses.is_dataclass(target):
                if not isinstance(body, dict):
                    # a scalar body would REPLACE the dataclass subtree
                    # (settings.location = "hello") and validate() would
                    # then AttributeError on every later request
                    return _json(
                        {"error": f"section {section!r} requires an "
                                  f"object body, got "
                                  f"{type(body).__name__}"}, status=400)
                _merge_dataclass(target, body)
            else:
                setattr(self.ctx.settings, section, body)
            warnings = self.ctx.settings.validate()
        except Exception as e:
            # broad on purpose: the snapshot restore must ALWAYS run —
            # any escape here leaves the live tree corrupted for every
            # later request (advisor r4, medium)
            restore_settings_in_place(self.ctx.settings, snapshot)
            status = 400 if isinstance(e, (TypeError, ValueError)) else 500
            # CoerceError names the offending field — structured so the
            # SPA anchors the message to the input instead of a toast
            return _json({"error": str(e),
                          **({"field": e.key}
                             if hasattr(e, "key") else {})}, status=status)
        signals = {
            "range_filter": [ControlSignal.REBUILD_RANGE_FILTER],
            "species": [ControlSignal.RELOAD_SPECIES_CONFIG],
            "models": [ControlSignal.RELOAD_THRESHOLDS],
            "export": [ControlSignal.RELOAD_EXPORT,
                       ControlSignal.REBUILD_EXTENDED_CAPTURE],
            "privacy_filter": [ControlSignal.RELOAD_PRIVACY],
            # the rebuild handler re-resolves BOTH exclusionary species
            # filters (extended capture + daylight)
            "daylight_filter": [ControlSignal.REBUILD_EXTENDED_CAPTURE],
            "mqtt": [ControlSignal.RECONFIGURE_MQTT],
            "birdweather": [ControlSignal.RECONFIGURE_BIRDWEATHER],
            "weather": [ControlSignal.RECONFIGURE_WEATHER],
            "notification": [ControlSignal.RECONFIGURE_NOTIFICATIONS],
            "alerting": [ControlSignal.RECONFIGURE_ALERTING],
            "soundlevel": [ControlSignal.RECONFIGURE_SOUND_LEVEL],
            "dynamic_threshold":
                [ControlSignal.RECONFIGURE_DYNAMIC_THRESHOLDS],
            "realtime": [ControlSignal.UPDATE_DETECTION_INTERVALS,
                         ControlSignal.RECONFIGURE_SOURCES,
                         ControlSignal.RECONFIGURE_QUIET_HOURS],
            "location": [ControlSignal.REBUILD_RANGE_FILTER,
                         ControlSignal.RECONFIGURE_QUIET_HOURS],
        }.get(section, [])
        if self.ctx.control is not None:
            for signal in signals:
                self.ctx.control.send(signal)
        return _json({"updated": section, "warnings": warnings,
                      "signals": [s.value for s in signals],
                      "signal": signals[0].value if signals else None})

    # -- handlers: range filter --------------------------------------------------------------------

    async def h_range_status(self, request):
        inc = self.ctx.processor.included_species
        return _json({
            "enabled": inc is not None,
            "included_count": len(inc) if inc is not None else None,
            "latitude": self.ctx.settings.location.latitude,
            "longitude": self.ctx.settings.location.longitude,
            "threshold": self.ctx.settings.range_filter.threshold,
        })

    async def h_range_list(self, request):
        inc = self.ctx.processor.included_species
        return _json({"species": sorted(inc) if inc else []})

    async def h_range_rebuild(self, request):
        n = self.ctx.rebuild_range_filter()
        return _json({"rebuilt": True, "included_count": n})

    async def h_range_test(self, request):
        body = await request.json()
        try:
            scores = self.ctx.range_filter_scores(
                float(body["latitude"]), float(body["longitude"]),
                int(body.get("week", -1)))
        except (KeyError, ValueError) as e:
            return _json({"error": str(e)}, status=400)
        thr = float(body.get("threshold",
                             self.ctx.settings.range_filter.threshold))
        return _json({"count": int((scores >= thr).sum()),
                      "threshold": thr})

    async def h_range_heatmap(self, request):
        """Batched geomodel over a lat/lon grid (the reference's only true
        batched inference — classifier/heatmap_service.go; one vmapped
        call here)."""
        import numpy as np

        q = request.query
        try:
            res = int(q.get("resolution", 24))
            week = int(q.get("week", -1))
            species_idx = int(q["species_index"]) if "species_index" in q \
                else None
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        res = min(max(res, 4), 90)
        lats = np.linspace(-85, 85, res)
        lons = np.linspace(-180, 180, 2 * res)
        grid = np.stack(np.meshgrid(lats, lons, indexing="ij"), axis=-1)
        coords = np.concatenate(
            [grid.reshape(-1, 2),
             np.full((grid.shape[0] * grid.shape[1], 1), float(week))],
            axis=1)
        import asyncio as _aio

        def _run():
            scores = self.ctx.range_filter_scores_batch(coords)
            if species_idx is not None:
                return scores[:, species_idx]
            return scores.sum(axis=1)

        flat = await _aio.get_event_loop().run_in_executor(None, _run)
        return _json({
            "lats": lats.tolist(), "lons": lons.tolist(),
            "values": flat.reshape(res, 2 * res).tolist(),
        })

    async def h_alert_rules(self, request):
        import dataclasses as dc

        eng = self.ctx.alerting
        if eng is None:
            return _json([])
        return _json([dc.asdict(r) for r in eng.list_rules()])

    async def h_alert_rule_create(self, request):
        from birdnet_go_tpu_torch.analysis.alerting import AlertRule

        eng = self.ctx.alerting
        if eng is None:
            return _json({"error": "alerting inactive"}, status=503)
        body = await request.json()
        try:
            rule = AlertRule(**body)
        except TypeError as e:
            return _json({"error": str(e)}, status=400)
        eng.add_rule(rule)
        return _json({"created": rule.rule_id})

    async def h_alert_rule_delete(self, request):
        eng = self.ctx.alerting
        if eng is None or not eng.remove_rule(request.match_info["id"]):
            return _json({"error": "not found"}, status=404)
        return _json({"deleted": request.match_info["id"]})

    async def h_alert_rule_test(self, request):
        eng = self.ctx.alerting
        if eng is None:
            return _json({"error": "alerting inactive"}, status=503)
        sample = None
        if request.can_read_body:
            try:
                sample = await request.json()
            except Exception:
                sample = None
        try:
            matched = eng.test_rule(request.match_info["id"], sample)
        except KeyError:
            return _json({"error": "not found"}, status=404)
        return _json({"matched": matched})

    async def h_alert_history(self, request):
        import dataclasses as dc

        eng = self.ctx.alerting
        if eng is None:
            return _json([])
        limit = min(int(request.query.get("limit", 50)), 500)
        return _json([dc.asdict(e) for e in eng.history[-limit:]])

    async def h_models_catalog(self, request):
        import dataclasses as dc

        from birdnet_go_tpu_torch.models.catalog import catalog_entries

        return _json([dc.asdict(e) for e in catalog_entries()])

    async def h_models_installed(self, request):
        from birdnet_go_tpu_torch.models.catalog import ModelManager

        return _json(ModelManager().installed())

    async def h_model_load(self, request):
        import asyncio as _aio

        model_id = request.match_info["id"]
        try:
            ok = await _aio.get_event_loop().run_in_executor(
                None, self.ctx.load_model_runtime, model_id)
        except KeyError as e:
            return _json({"error": str(e)}, status=404)
        if not ok:
            return _json({"error": "already loaded"}, status=409)
        return _json({"loaded": model_id})

    async def h_model_unload(self, request):
        ok = self.ctx.unload_model_runtime(request.match_info["id"])
        if not ok:
            return _json({"error": "not loaded"}, status=404)
        return _json({"unloaded": request.match_info["id"]})

    # -- handlers: models/media ------------------------------------------------------------------------

    async def h_models(self, request):
        from birdnet_go_tpu_torch.models.registry import MODEL_REGISTRY

        out = []
        for mid, spec in MODEL_REGISTRY.items():
            out.append({
                "model_id": mid,
                "display_name": spec.display_name,
                "sample_rate": spec.sample_rate,
                "clip_seconds": spec.clip_seconds,
                "num_species": spec.num_species,
                "loaded": mid in self.ctx.device_loop.batchers,
            })
        return _json(out)

    async def h_index(self, request):
        path = Path(__file__).parent / "static" / "index.html"
        return web.FileResponse(path)

    async def h_service_worker(self, request):
        """PWA service worker served at '/' so its scope covers the app
        (reference: frontend PWA via internal/api/pwa.go)."""
        path = Path(__file__).parent / "static" / "sw.js"
        return web.FileResponse(path, headers={
            "Content-Type": "application/javascript",
            "Cache-Control": "no-cache"})

    async def h_metrics(self, request):
        """Prometheus text exposition (reference: observability endpoint)."""
        from birdnet_go_tpu_torch.utils.metrics import REGISTRY

        self._update_runtime_metrics()
        return web.Response(text=REGISTRY.render(),
                            content_type="text/plain")

    def _update_runtime_metrics(self) -> None:
        from birdnet_go_tpu_torch.utils.metrics import REGISTRY

        p = self.ctx.processor
        if p is not None:
            g = REGISTRY.gauge("birdnet_detections_approved_total")
            g.set(p.stats.detections_approved)
            REGISTRY.gauge("birdnet_detections_discarded_total").set(
                p.stats.detections_discarded)
            REGISTRY.gauge("birdnet_results_processed_total").set(
                p.stats.results_processed)
        dl = self.ctx.device_loop
        if dl is not None:
            for model_id, b in dl.batchers.items():
                REGISTRY.gauge("birdnet_windows_processed_total").set(
                    b.stats.windows_processed, labels={"model": model_id})
                REGISTRY.gauge("birdnet_batch_latency_ms").set(
                    b.stats.last_latency_ms, labels={"model": model_id})
                REGISTRY.gauge("birdnet_batch_fill_ratio").set(
                    b.stats.last_batch_fill, labels={"model": model_id})
                REGISTRY.gauge("birdnet_overruns_total").set(
                    b.stats.overruns, labels={"model": model_id})
        if self.ctx.jobqueue is not None:
            st = self.ctx.jobqueue.stats
            for k in ("enqueued", "completed", "failed", "dropped"):
                REGISTRY.gauge(f"birdnet_jobqueue_{k}_total").set(
                    getattr(st, k))
        # every span and counter of the port's recorder (utils/tracing.py)
        from birdnet_go_tpu_torch.utils.tracing import GLOBAL_SPANS

        GLOBAL_SPANS.set_metrics(REGISTRY)
        # live migration progress (reference migration_telemetry.go); read
        # from the persisted state row so it reports across restarts too
        ds = self.ctx.datastore
        if ds is not None:
            try:
                with ds._lock:
                    row = ds._conn.execute(
                        "SELECT state, total_records, migrated_records"
                        " FROM migration_state WHERE id = 1").fetchone()
            except Exception:       # table absent: no migration ever ran
                row = None
            if row is not None:
                from birdnet_go_tpu_torch.datastore.migration import STATES
                code = (STATES.index(row["state"])
                        if row["state"] in STATES else -1)
                REGISTRY.gauge(
                    "birdnet_migration_state",
                    "0=idle 1=migrating 2=validating 3=cutover 4=completed"
                    " 5=paused 6=cancelled 7=failed").set(code)
                REGISTRY.gauge("birdnet_migration_records_total").set(
                    row["total_records"])
                REGISTRY.gauge("birdnet_migration_records_migrated").set(
                    row["migrated_records"])

    async def h_resources(self, request):
        from birdnet_go_tpu_torch.utils.sysmonitor import resources

        return _json(resources(self.ctx.settings.export.path))

    async def h_settings_schema(self, request):
        from birdnet_go_tpu_torch.config.schema import generate_schema

        return _json(generate_schema())

    async def h_species_dict(self, request):
        """Locale name dictionary: scientific → localized common name.
        Served PRECOMPRESSED when the speciesdict dataset is present
        (reference: internal/speciesdict ships gzip blobs verbatim);
        otherwise assembled from the label files."""
        from birdnet_go_tpu_torch.taxonomy.speciesdict import compressed_dictionary

        locale = request.match_info["locale"]
        blob = compressed_dictionary(locale)
        if blob is not None and "gzip" in request.headers.get(
                "Accept-Encoding", ""):
            return web.Response(
                body=blob,
                headers={"Content-Type": "application/json",
                         "Content-Encoding": "gzip",
                         "Vary": "Accept-Encoding",
                         "Cache-Control": "public, max-age=86400"})
        from birdnet_go_tpu_torch.taxonomy.labels import load_labels

        labels = load_labels(self.ctx.settings.data_dir, locale=locale)
        return _json({sp.scientific: sp.common for sp in labels.species})

    async def h_time_of_day(self, request):
        """Detection's position relative to the sun (dawn/day/dusk/night) —
        reference: GET /detections/:id/time-of-day."""
        import datetime as dt

        row = self.ctx.datastore.get_detection(int(request.match_info["id"]))
        if row is None:
            return _json({"error": "not found"}, status=404)
        loc = self.ctx.settings.location
        if loc.latitude is None:
            return _json({"error": "location not configured"}, status=400)
        from birdnet_go_tpu_torch.utils.suncalc import sun_times

        when = dt.datetime.fromtimestamp(row["timestamp"], dt.timezone.utc)
        st = sun_times(when.date(), loc.latitude, loc.longitude)
        phase = "unknown"
        if st.polar == "day":
            phase = "day"
        elif st.polar == "night":
            phase = "night"
        elif st.civil_dawn and st.sunrise and st.sunset and st.civil_dusk:
            if st.civil_dawn <= when < st.sunrise:
                phase = "dawn"
            elif st.sunrise <= when < st.sunset:
                phase = "day"
            elif st.sunset <= when < st.civil_dusk:
                phase = "dusk"
            else:
                phase = "night"
        return _json({"id": row["id"], "phase": phase,
                      "sunrise": st.sunrise, "sunset": st.sunset})

    async def h_recent_errors(self, request):
        from birdnet_go_tpu_torch.utils.health import GLOBAL_ERROR_BUFFER

        limit = min(int(request.query.get("limit", 50)), 256)
        return _json(GLOBAL_ERROR_BUFFER.recent(limit))

    async def h_species_first_seen(self, request):
        tr = getattr(self.ctx, "species_tracker", None)
        if tr is None:
            return _json({"error": "tracker not active"}, status=404)
        fs = tr.first_seen(request.match_info["scientific"])
        return _json({"lifetime": fs.lifetime, "this_year": fs.this_year,
                      "this_season": fs.this_season})

    async def h_weather_hourly(self, request):
        return _json(self.ctx.datastore.get_hourly_weather(
            request.match_info["date"]))

    def _sandboxed_media(self, name: str) -> Path | None:
        """securefs-style sandbox: never resolve outside the clip dir.

        Uses Path.is_relative_to after resolve() — a raw string-prefix
        check would admit sibling dirs sharing the prefix (/clips-evil
        vs /clips) and symlinked escapes."""
        base = Path(self.ctx.settings.export.path).resolve()
        target = (base / name).resolve()
        if target == base or not target.is_relative_to(base):
            return None
        return target

    async def h_media_audio(self, request):
        target = self._sandboxed_media(request.match_info["filename"])
        if target is None or not target.is_file():
            return _json({"error": "not found"}, status=404)
        return web.FileResponse(target)

    async def h_media_spectrogram(self, request):
        target = self._sandboxed_media(request.match_info["filename"])
        if target is None or not target.is_file():
            return _json({"error": "not found"}, status=404)
        return web.FileResponse(target)

    async def h_spectrogram_by_id(self, request):
        """PNG for a detection; generated on cache miss from the clip WAV
        (reference: GET /api/v2/spectrogram/:id, cache-miss path runs the
        generator — here the shared STFT kernel instead of SoX)."""
        import asyncio as _aio

        row = self.ctx.datastore.get_detection(int(request.match_info["id"]))
        if row is None or not row.get("clip_name"):
            return _json({"error": "not found"}, status=404)
        png_name = str(Path(row["clip_name"]).with_suffix(".png"))
        target = self._sandboxed_media(png_name)
        if target is None:
            return _json({"error": "not found"}, status=404)
        if not target.is_file():
            wav = self._sandboxed_media(row["clip_name"])
            if wav is None or not wav.is_file():
                return _json({"error": "clip not available"}, status=404)

            from birdnet_go_tpu_torch.analysis.spectrogram import SIZES

            width = SIZES.get(request.query.get("size", "md"), 800)
            await _aio.get_event_loop().run_in_executor(
                None, functools.partial(self._render_png, wav, target,
                                        width=width))
        return web.FileResponse(target)
