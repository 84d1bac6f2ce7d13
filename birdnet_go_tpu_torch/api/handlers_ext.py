"""Extended /api/v2 route groups (mixin for ApiServer).

Covers the reference surface beyond the core groups in server.py
(internal/api/v2/api.go:610-680): notifications CRUD + SSE, dynamic
thresholds, spectrogram generate/status, system processes/disks/
temperature, audio devices, stream tests, quiet hours, detection comments,
weather daily/moon, species/taxonomy, import jobs, model install/remove,
support dump, and filesystem listing.

A copy of ``birdnet_go_tpu/api/handlers_ext.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_api.py`` holds it to
the original. Where it differs:

- spectrograms render on the app's device, on a CUDA stream of their
  own, and a clip is decoded in the app's codec workers (``_render_png``,
  ``h_audio_process``): the Python FLAC decoder on a thread of the app's
  process held the GIL about a second for a 6 s clip, and the served
  step's latency with it;
- ``system/diagnostics`` names the torch backend and devices
  (``backend``, ``devices``) where JAX names ``jax_backend`` and
  ``jax.devices()``.
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import json
import logging
import time
from pathlib import Path
from typing import Any

from birdnet_go_tpu_torch.api import web

log = logging.getLogger("birdnet_tpu.api")


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status, dumps=lambda d: json.dumps(
        d, default=str))


class ExtendedHandlers:
    """Mixin: self.ctx is the Application, self.sse the broadcaster."""

    def register_ext_routes(self, r, v2: str) -> None:
        # notifications (CRUD + stream — internal/notification API)
        r.add_get(f"{v2}/notifications", self.h_notifications)
        r.add_get(f"{v2}/notifications/unread/count", self.h_notif_unread)
        r.add_get(f"{v2}/notifications/stream", self.h_notifications_stream)
        r.add_post(f"{v2}/notifications/test", self.h_notif_test)
        r.add_put(f"{v2}/notifications/read-all", self.h_notif_read_all)
        r.add_get(f"{v2}/notifications/{{id}}", self.h_notif_get)
        r.add_put(f"{v2}/notifications/{{id}}/read", self.h_notif_read)
        r.add_delete(f"{v2}/notifications/{{id}}", self.h_notif_delete)
        # dynamic thresholds
        r.add_get(f"{v2}/dynamic-thresholds", self.h_dyn_list)
        r.add_get(f"{v2}/dynamic-thresholds/stats", self.h_dyn_stats)
        r.add_get(f"{v2}/dynamic-thresholds/events", self.h_dyn_events)
        r.add_delete(f"{v2}/dynamic-thresholds", self.h_dyn_clear_all)
        r.add_delete(f"{v2}/dynamic-thresholds/{{species}}",
                     self.h_dyn_clear_one)
        # spectrogram job API
        r.add_post(f"{v2}/spectrogram/{{id}}/generate", self.h_spec_generate)
        r.add_get(f"{v2}/spectrogram/{{id}}/status", self.h_spec_status)
        # system detail
        r.add_get(f"{v2}/system/processes", self.h_sys_processes)
        r.add_get(f"{v2}/system/disks", self.h_sys_disks)
        r.add_get(f"{v2}/system/temperature/cpu", self.h_sys_temp)
        r.add_get(f"{v2}/system/jobs", self.h_sys_jobs)
        r.add_get(f"{v2}/system/control/signals", self.h_control_signals)
        r.add_post(f"{v2}/system/control", self.h_control_send)
        r.add_get(f"{v2}/system/diagnostics", self.h_diagnostics)
        r.add_get(f"{v2}/system/database", self.h_database_details)
        r.add_post(f"{v2}/system/storage/reconcile",
                   self.h_storage_reconcile)
        # devices / streams
        r.add_get(f"{v2}/devices", self.h_devices)
        r.add_post(f"{v2}/streams/test", self.h_stream_test)
        r.add_post(f"{v2}/streams/analyze-channels",
                   self.h_analyze_channels)
        r.add_post(f"{v2}/streams/probe", self.h_stream_probe)
        r.add_get(f"{v2}/streams/health/{{source}}", self.h_stream_health_one)
        r.add_post(f"{v2}/restart-source/{{id}}", self.h_restart_source)
        r.add_get(f"{v2}/quiet-hours/status", self.h_quiet_hours)
        # detections extras
        r.add_get(f"{v2}/detections/pending", self.h_pending)
        r.add_get(f"{v2}/detections/pending/stream", self.h_pending_stream)
        r.add_get(f"{v2}/streams/health/stream", self.h_streams_health_sse)
        r.add_get(f"{v2}/detections/new", self.h_detections_new)
        r.add_get(f"{v2}/detections/{{id}}/comments", self.h_comments_list)
        r.add_post(f"{v2}/detections/{{id}}/comments", self.h_comment_add)
        r.add_put(f"{v2}/comments/{{id}}", self.h_comment_update)
        r.add_delete(f"{v2}/comments/{{id}}", self.h_comment_delete)
        r.add_get(f"{v2}/detections/{{id}}/reviews", self.h_reviews_list)
        r.add_get(f"{v2}/detections/{{id}}/results", self.h_results_list)
        r.add_delete(f"{v2}/detections/{{id}}/lock", self.h_unlock)
        r.add_get(f"{v2}/audio/{{id}}", self.h_audio_by_id)
        # analytics extras
        r.add_get(f"{v2}/analytics/dawn-onset", self.h_dawn_onset)
        r.add_get(f"{v2}/analytics/dawn-chorus", self.h_dawn_chorus)
        r.add_get(f"{v2}/analytics/database/stats", self.h_db_stats)
        r.add_get(f"{v2}/analytics/daily-events/{{date}}",
                  self.h_daily_events)
        r.add_get(f"{v2}/analytics/species/daily",
                  self.h_species_daily_summary)
        r.add_get(f"{v2}/analytics/trends", self.h_trends)
        r.add_get(f"{v2}/analytics/dashboard/kpis", self.h_dashboard_kpis)
        # insights (analytics/insights.go RegisterInsightsRoutes)
        r.add_get(f"{v2}/insights/expected-today",
                  self.h_insights_expected_today)
        r.add_get(f"{v2}/insights/expected-today/regional",
                  self.h_insights_expected_regional)
        r.add_get(f"{v2}/insights/phantom-species",
                  self.h_insights_phantom)
        r.add_get(f"{v2}/insights/dawn-chorus",
                  self.h_insights_dawn_chorus)
        r.add_get(f"{v2}/insights/migration", self.h_insights_migration)
        r.add_get(f"{v2}/dashboard/kpis", self.h_insights_kpis)
        # weather
        r.add_get(f"{v2}/weather/daily/{{date}}", self.h_weather_daily)
        r.add_get(f"{v2}/weather/sun/{{date}}", self.h_weather_sun)
        r.add_get(f"{v2}/weather/moon/{{date}}", self.h_weather_moon)
        # species / taxonomy
        r.add_get(f"{v2}/species", self.h_species_detected)
        r.add_get(f"{v2}/species/all", self.h_species_all)
        r.add_get(f"{v2}/species/search", self.h_species_search)
        r.add_get(f"{v2}/species/taxonomy", self.h_species_taxonomy)
        r.add_get(f"{v2}/taxonomy/tree", self.h_taxonomy_tree)
        r.add_get(f"{v2}/taxonomy/genus/{{genus}}", self.h_taxonomy_genus)
        r.add_get(f"{v2}/taxonomy/family/{{family}}",
                  self.h_taxonomy_family)
        r.add_get(f"{v2}/species/{{code}}/thumbnail",
                  self.h_species_code_thumbnail)
        # HLS live audio (fMP4/FLAC segments — audio_hls.go contract)
        r.add_post(f"{v2}/audio/hls/{{source}}/start", self.h_hls_start)
        r.add_post(f"{v2}/audio/hls/{{source}}/heartbeat",
                   self.h_hls_heartbeat)
        r.add_post(f"{v2}/audio/hls/{{source}}/stop", self.h_hls_stop)
        r.add_get(f"{v2}/audio/hls/{{source}}/playlist.m3u8",
                  self.h_hls_playlist)
        r.add_get(f"{v2}/audio/hls/{{source}}/init.mp4", self.h_hls_init)
        r.add_get(f"{v2}/audio/hls/{{source}}/{{seg}}.m4s",
                  self.h_hls_segment)
        # species images (imageprovider)
        r.add_get(f"{v2}/media/species-image", self.h_species_image)
        r.add_get(f"{v2}/species/thumbnail", self.h_species_thumbnail)
        r.add_get(f"{v2}/media/species-image/stats", self.h_image_stats)
        # imports
        r.add_post(f"{v2}/imports/birdnet-pi", self.h_import_start)
        r.add_post(f"{v2}/imports/birdnet-go", self.h_import_birdnet_go)
        r.add_get(f"{v2}/imports/jobs", self.h_import_jobs)
        r.add_get(f"{v2}/imports/jobs/{{id}}", self.h_import_job)
        r.add_post(f"{v2}/imports/jobs/{{id}}/cancel", self.h_import_cancel)
        # live migration (reference internal/datastore/v2/migration)
        r.add_get(f"{v2}/migration/status", self.h_migration_status)
        r.add_post(f"{v2}/migration/start", self.h_migration_start)
        r.add_post(f"{v2}/migration/pause", self.h_migration_ctl)
        r.add_post(f"{v2}/migration/resume", self.h_migration_ctl)
        r.add_post(f"{v2}/migration/cancel", self.h_migration_ctl)
        r.add_post(f"{v2}/migration/rollback", self.h_migration_ctl)
        # models install
        r.add_post(f"{v2}/models/install/{{id}}", self.h_model_install)
        r.add_get(f"{v2}/models/install/{{id}}/progress",
                  self.h_model_install_progress)
        r.add_delete(f"{v2}/models/installed/{{id}}", self.h_model_remove)
        # support / filesystem
        r.add_get(f"{v2}/support/dump", self.h_support_dump)
        r.add_get(f"{v2}/filesystem/clips", self.h_fs_clips)
        # range filter extras (range/species/{count,csv,scores})
        r.add_get(f"{v2}/range/species/count", self.h_range_count)
        r.add_get(f"{v2}/range/species/csv", self.h_range_csv)
        r.add_get(f"{v2}/range/species/scores", self.h_range_scores)
        # alert rules import/export
        r.add_get(f"{v2}/alerts/rules/export", self.h_alerts_export)
        r.add_post(f"{v2}/alerts/rules/import", self.h_alerts_import)
        # aux: update check, telemetry stats, profiling, succession, ebird,
        # openfauna metadata, speciesdict locales
        r.add_get(f"{v2}/system/update-check", self.h_update_check)
        r.add_get(f"{v2}/system/telemetry", self.h_telemetry_stats)
        r.add_get(f"{v2}/debug/profile", self.h_debug_profile)
        r.add_get(f"{v2}/analytics/succession", self.h_succession)
        r.add_get(f"{v2}/ebird/taxonomy", self.h_ebird_taxonomy)
        r.add_get(f"{v2}/ebird/observations", self.h_ebird_observations)
        r.add_get(f"{v2}/species/info", self.h_species_info)
        r.add_get(f"{v2}/species/locales", self.h_species_locales)
        # settings whole-document replace
        r.add_put(f"{v2}/settings", self.h_put_settings)
        # TLS certificate management (internal/api/v2/tls — get/upload/
        # delete/generate/download)
        r.add_get(f"{v2}/tls/certificate", self.h_tls_get)
        r.add_post(f"{v2}/tls/certificate", self.h_tls_upload)
        r.add_delete(f"{v2}/tls/certificate", self.h_tls_delete)
        r.add_post(f"{v2}/tls/certificate/generate", self.h_tls_generate)
        r.add_get(f"{v2}/tls/certificate/download", self.h_tls_download)
        # on-demand clip generation + clip processing (media.go)
        r.add_post(f"{v2}/audio/{{id}}/clip", self.h_audio_clip_generate)
        r.add_post(f"{v2}/audio/{{id}}/process", self.h_audio_process)
        # integrations test group (integrations/*.go)
        r.add_get(f"{v2}/integrations/mqtt/status", self.h_mqtt_status)
        r.add_post(f"{v2}/integrations/mqtt/test", self.h_mqtt_test)
        r.add_post(f"{v2}/integrations/mqtt/homeassistant/discovery",
                   self.h_mqtt_ha_discovery)
        r.add_post(f"{v2}/integrations/birdweather/test",
                   self.h_birdweather_test)
        r.add_post(f"{v2}/integrations/ebird/test", self.h_ebird_test)
        r.add_post(f"{v2}/integrations/weather/test", self.h_weather_test)
        # app bootstrap + SSE/control introspection
        r.add_get(f"{v2}/app/config", self.h_app_config)
        r.add_post(f"{v2}/app/wizard/dismiss", self.h_wizard_dismiss)
        r.add_get(f"{v2}/control/actions", self.h_control_actions)
        r.add_get(f"{v2}/sse/status", self.h_sse_status)
        # system extras
        r.add_get(f"{v2}/system/audio/active", self.h_sys_audio_active)
        r.add_get(f"{v2}/system/audio/sources", self.h_sys_audio_sources)
        r.add_get(f"{v2}/system/audio/equalizer/config",
                  self.h_eq_config_get)
        r.add_put(f"{v2}/system/audio/equalizer/config",
                  self.h_eq_config_put)
        r.add_get(f"{v2}/system/network-interfaces",
                  self.h_network_interfaces)
        r.add_get(f"{v2}/system/restart-status", self.h_restart_status)
        r.add_get(f"{v2}/system/metrics/history", self.h_metrics_history)
        r.add_get(f"{v2}/system/database/overview", self.h_db_overview)
        r.add_post(f"{v2}/system/database/backup", self.h_db_backup_run)
        r.add_get(f"{v2}/system/database/backup/jobs",
                  self.h_db_backup_jobs)
        r.add_post(f"{v2}/system/database/backup/verify",
                   self.h_db_backup_verify)
        r.add_get(f"{v2}/system/events/operational",
                  self.h_events_operational)
        r.add_post(f"{v2}/system/diagnostics/run", self.h_diagnostics_run)
        # imports validation + POST-form support bundle
        r.add_post(f"{v2}/imports/validate", self.h_import_validate)
        r.add_post(f"{v2}/support/generate", self.h_support_dump)

    # -- shared SSE pump -----------------------------------------------------------

    async def _sse_stream(self, request, channel: str):
        from birdnet_go_tpu_torch.api.sse import format_sse

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        q = self.sse.subscribe(channel)
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
            self.sse.unsubscribe(channel, q)
        return resp

    # -- notifications ----------------------------------------------------------------

    @property
    def _inbox(self):
        return self.ctx.notification_inbox

    async def h_notifications(self, request):
        limit = min(int(request.query.get("limit", 100)), 500)
        unread = request.query.get("unread", "") in ("1", "true")
        return _json({"notifications": self._inbox.list(limit, unread),
                      "unread": self._inbox.unread_count()})

    async def h_notif_unread(self, request):
        return _json({"count": self._inbox.unread_count()})

    async def h_notif_get(self, request):
        n = self._inbox.get(int(request.match_info["id"]))
        if n is None:
            return _json({"error": "not found"}, status=404)
        return _json(n)

    async def h_notif_read(self, request):
        if not self._inbox.mark_read(int(request.match_info["id"])):
            return _json({"error": "not found"}, status=404)
        return _json({"read": True})

    async def h_notif_read_all(self, request):
        return _json({"marked": self._inbox.mark_all_read()})

    async def h_notif_delete(self, request):
        if not self._inbox.delete(int(request.match_info["id"])):
            return _json({"error": "not found"}, status=404)
        return _json({"deleted": True})

    async def h_notifications_stream(self, request):
        return await self._sse_stream(request, "notifications")

    async def h_notif_test(self, request):
        from birdnet_go_tpu_torch.integrations.notification import Notification

        body = await request.json() if request.can_read_body else {}
        n = Notification(
            title=body.get("title", "Test notification"),
            message=body.get("message",
                             "This is a test from the notifications API"),
            priority=body.get("priority", "normal"))
        delivered = await asyncio.get_event_loop().run_in_executor(
            None, self.ctx.notifications.notify, n)
        return _json({"delivered": delivered,
                      "stored": self._inbox.unread_count() > 0})

    # -- dynamic thresholds ---------------------------------------------------------------

    async def h_dyn_list(self, request):
        return _json({"thresholds": self.ctx.processor.dynamic.entries()})

    async def h_dyn_stats(self, request):
        return _json(self.ctx.processor.dynamic.stats())

    async def h_dyn_events(self, request):
        limit = min(int(request.query.get("limit", 100)), 1000)
        return _json({"events": self.ctx.datastore.list_threshold_events(
            limit=limit, scientific=request.query.get("species"))})

    async def h_dyn_clear_all(self, request):
        return _json({"cleared": self.ctx.processor.dynamic.clear()})

    async def h_dyn_clear_one(self, request):
        n = self.ctx.processor.dynamic.clear(
            scientific=request.match_info["species"])
        return _json({"cleared": n})

    # -- spectrogram job API -------------------------------------------------------------

    async def h_spec_generate(self, request):
        """Force (re)generation of a detection's spectrogram PNG."""
        det_id = int(request.match_info["id"])
        row = self.ctx.datastore.get_detection(det_id)
        if row is None or not row.get("clip_name"):
            return _json({"error": "not found"}, status=404)
        wav = self._sandboxed_media(row["clip_name"])
        if wav is None or not wav.is_file():
            return _json({"error": "clip not available"}, status=404)
        png = wav.with_suffix(".png")
        await asyncio.get_event_loop().run_in_executor(
            None, self._render_png, wav, png)
        return _json({"generated": True, "path": png.name})

    def _render_png(self, wav: Path, png: Path, **kw) -> None:
        """The clip's spectrogram PNG, rendered on the app's device and,
        on a card, on a CUDA stream of its own (``ops/streams.py``): on
        the served step's stream it would queue between batches. The clip
        is decoded in the app's codec workers (``ClipEncoder.decode``).
        JAX's renders on its default device and decodes on this
        thread."""
        from birdnet_go_tpu_torch.analysis.spectrogram import generate_png
        from birdnet_go_tpu_torch.ops.streams import (
            aux_device,
            on_stream,
            side_stream,
        )

        samples, rate = self.ctx.clip_encoder.decode(wav)
        dev = aux_device(self.ctx.device, "the API's spectrogram render")
        with on_stream(side_stream(dev)):
            generate_png(samples, rate, png, device=dev, **kw)

    async def h_spec_status(self, request):
        det_id = int(request.match_info["id"])
        row = self.ctx.datastore.get_detection(det_id)
        if row is None:
            return _json({"error": "not found"}, status=404)
        status = "unavailable"
        if row.get("clip_name"):
            png = self._sandboxed_media(
                str(Path(row["clip_name"]).with_suffix(".png")))
            wav = self._sandboxed_media(row["clip_name"])
            if png is not None and png.is_file():
                status = "ready"
            elif wav is not None and wav.is_file():
                status = "pending"
        pr = getattr(self.ctx, "prerenderer", None)
        return _json({
            "id": det_id, "status": status,
            "queue_depth": pr.queue_depth() if pr and
            hasattr(pr, "queue_depth") else None,
        })

    # -- system detail ----------------------------------------------------------------------

    async def h_sys_processes(self, request):
        from birdnet_go_tpu_torch.utils.sysmonitor import processes

        limit = min(int(request.query.get("limit", 20)), 100)
        return _json({"processes": processes(limit)})

    async def h_sys_disks(self, request):
        from birdnet_go_tpu_torch.utils.sysmonitor import disks

        return _json({"disks": disks()})

    async def h_sys_temp(self, request):
        from birdnet_go_tpu_torch.utils.sysmonitor import cpu_temperature

        return _json(cpu_temperature())

    async def h_sys_jobs(self, request):
        import dataclasses as dc

        st = dc.asdict(self.ctx.jobqueue.stats)
        # shed-order forensics: categories ordered by their first drop —
        # under overload this shows WHICH actions shed, in what order
        # (priority bands guarantee low-priority categories lead)
        st["shed_order"] = [
            c for c, v in sorted(
                ((c, v) for c, v in st["by_category"].items()
                 if v.get("first_drop_t") is not None),
                key=lambda cv: cv[1]["first_drop_t"])]
        st["pending_by_band"] = {
            str(band): n
            for band, n in self.ctx.jobqueue.pending_by_band().items()}
        return _json(st)

    async def h_control_signals(self, request):
        from birdnet_go_tpu_torch.config.control import ControlSignal

        return _json({"signals": [s.value for s in ControlSignal]})

    async def h_control_send(self, request):
        from birdnet_go_tpu_torch.config.control import ControlSignal

        body = await request.json()
        try:
            sig = ControlSignal(body.get("signal", ""))
        except ValueError:
            return _json({"error": "unknown signal"}, status=400)
        self.ctx.control.send(sig)
        return _json({"sent": sig.value})

    async def h_diagnostics(self, request):
        import platform
        import sys

        return _json({
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "backend": self._backend(),
            "devices": self._devices(),
            "models_loaded": list(self.ctx.classifiers),
            "sources": len(self.ctx._sources),
            "uptime_seconds": round(time.time() - self.started_at, 1),
        })

    # -- devices / streams --------------------------------------------------------------------

    async def h_devices(self, request):
        from birdnet_go_tpu_torch.utils.sysmonitor import audio_devices

        devices = audio_devices()      # /proc/asound cards + USB identity
        alsa = False
        pcms: list = []
        try:
            from birdnet_go_tpu_torch import native

            alsa = native.alsa_available()
            pcms = native.alsa_list_devices()   # snd_device_name_hint
        except Exception:
            pass
        return _json({"devices": devices, "pcms": pcms,
                      "alsa_available": alsa})

    async def h_stream_test(self, request):
        """Connectivity probe for a stream URL (POST /streams/test): DNS +
        TCP reach of the RTSP/HTTP endpoint, without starting FFmpeg."""
        import socket
        from urllib.parse import urlparse

        body = await request.json()
        url = body.get("url", "")
        u = urlparse(url)
        if u.scheme not in ("rtsp", "rtsps", "http", "https"):
            return _json({"ok": False, "error": "unsupported scheme"},
                         status=400)
        port = u.port or {"rtsp": 554, "rtsps": 322,
                          "http": 80, "https": 443}[u.scheme]

        def _probe():
            t0 = time.monotonic()
            with socket.create_connection((u.hostname, port), timeout=5):
                return (time.monotonic() - t0) * 1000.0

        try:
            ms = await asyncio.get_event_loop().run_in_executor(None, _probe)
            return _json({"ok": True, "connect_ms": round(ms, 1)})
        except OSError as e:
            return _json({"ok": False, "error": str(e)})

    async def h_stream_probe(self, request):
        """Full ffprobe stream inventory (ffmpeg/probe.go)."""
        from birdnet_go_tpu_torch.audio.ffmpeg import probe_stream

        body = await request.json()
        out = await asyncio.get_event_loop().run_in_executor(
            None, probe_stream, body.get("url", ""),
            body.get("transport", "tcp"))
        return _json(out, status=200 if out.get("ok") else 503)

    async def h_analyze_channels(self, request):
        """Per-channel RMS so the UI can pick the mic channel."""
        from birdnet_go_tpu_torch.audio.ffmpeg import analyze_channels

        body = await request.json()
        out = await asyncio.get_event_loop().run_in_executor(
            None, lambda: analyze_channels(
                body.get("url", ""),
                seconds=float(body.get("seconds", 3.0)),
                channels=int(body.get("channels", 2))))
        return _json(out, status=200 if out.get("ok") else 503)

    async def h_stream_health_one(self, request):
        sid = request.match_info["source"]
        h = self.ctx.engine.stream_health().get(sid)
        if h is None:
            return _json({"error": "unknown source"}, status=404)
        return _json({"source_id": sid, **h})

    async def h_restart_source(self, request):
        sid = request.match_info["id"]
        if sid not in self.ctx._source_cfgs:
            return _json({"error": "unknown source"}, status=404)
        await asyncio.get_event_loop().run_in_executor(
            None, self.ctx._restart_source, sid)
        return _json({"restarted": sid})

    async def h_quiet_hours(self, request):
        qh = self.ctx.quiet_hours
        now = _dt.datetime.now(_dt.timezone.utc)
        out, windows = {}, {}
        # union of live engine sources and configured ones: a quiet-GATED
        # soundcard is stopped (gone from the engine) exactly when the
        # operator most needs to see its quiet state
        sids = {s.source_id for s in self.ctx.engine.sources()}
        sids.update(getattr(self.ctx, "_source_cfgs", {}))
        for sid in sorted(sids):
            out[sid] = qh.is_quiet(sid, now) if qh is not None else False
            if qh is not None:
                windows[sid] = [
                    {"start": w.start, "end": w.end}
                    for w in qh._windows.get(sid, ())]
        return _json({"time": now.isoformat(), "sources": out,
                      "windows": windows,
                      "capture_gated": sorted(
                          getattr(self.ctx, "_quiet_gated", ()))})

    # -- detections extras -------------------------------------------------------------------

    async def h_pending(self, request):
        return _json({"pending": self.ctx.processor.pending_as_dicts()})

    async def h_pending_stream(self, request):
        return await self._sse_stream(request, "pending")

    async def h_streams_health_sse(self, request):
        """Periodic stream-health pushes (GET /streams/health/stream)."""
        from birdnet_go_tpu_torch.api.sse import format_sse

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        try:
            while True:
                health = self.ctx.engine.stream_health()
                await resp.write(format_sse("health", json.dumps(
                    health, default=str)))
                await asyncio.sleep(5.0)
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        return resp

    async def h_detections_new(self, request):
        since = float(request.query.get("since", time.time() - 3600))
        limit = min(int(request.query.get("limit", 100)), 1000)
        rows = self.ctx.datastore.detections_since(since, limit)
        return _json({"detections": rows, "count": len(rows)})

    async def h_comments_list(self, request):
        return _json({"comments": self.ctx.datastore.list_comments(
            int(request.match_info["id"]))})

    async def h_comment_add(self, request):
        body = await request.json()
        text = (body.get("text") or "").strip()
        if not text:
            return _json({"error": "empty comment"}, status=400)
        try:
            cid = self.ctx.datastore.add_comment(
                int(request.match_info["id"]), text)
        except KeyError:
            return _json({"error": "detection not found"}, status=404)
        return _json({"comment_id": cid})

    async def h_comment_update(self, request):
        body = await request.json()
        ok = self.ctx.datastore.update_comment(
            int(request.match_info["id"]), (body.get("text") or "").strip())
        if not ok:
            return _json({"error": "not found"}, status=404)
        return _json({"updated": True})

    async def h_comment_delete(self, request):
        if not self.ctx.datastore.delete_comment(
                int(request.match_info["id"])):
            return _json({"error": "not found"}, status=404)
        return _json({"deleted": True})

    async def h_taxonomy_genus(self, request):
        """Genus detail: family/order (when genus_taxonomy.json is
        installed) + that genus's species in the primary model
        (reference: taxonomy tree/genus endpoints)."""
        from birdnet_go_tpu_torch.taxonomy.labels import (
            genus_of,
            load_genus_taxonomy,
        )

        genus = request.match_info["genus"]
        tax = load_genus_taxonomy(self.ctx.settings.data_dir) or {}
        info = tax.get(genus) or tax.get(genus.lower()) or {}
        labels = self._primary_labels()
        species = [{"scientific_name": sp.scientific,
                    "common_name": sp.common}
                   for sp in (labels.species if labels else [])
                   if genus_of(sp.scientific).lower() == genus.lower()]
        if not info and not species:
            return _json({"error": "unknown genus"}, status=404)
        return _json({"genus": genus, **info, "species": species})

    async def h_taxonomy_family(self, request):
        """Family → member genera (needs genus_taxonomy.json data)."""
        from birdnet_go_tpu_torch.taxonomy.labels import load_genus_taxonomy

        family = request.match_info["family"].lower()
        tax = load_genus_taxonomy(self.ctx.settings.data_dir)
        if not tax:
            return _json({"error": "taxonomy data not installed"},
                         status=404)
        # data file keys are lowercase (genus_taxonomy.json); present
        # genus names in their conventional capitalized form
        genera = sorted(g.capitalize() for g, v in tax.items()
                        if isinstance(v, dict)
                        and str(v.get("family", "")).lower() == family)
        if not genera:
            return _json({"error": "unknown family"}, status=404)
        return _json({"family": request.match_info["family"],
                      "genera": genera})

    async def h_species_code_thumbnail(self, request):
        """eBird-code addressed thumbnail (reference:
        GET /species/:code/thumbnail) — resolves the code through the
        primary label set, then serves like /species/thumbnail."""
        code = request.match_info["code"].lower()
        labels = self._primary_labels()
        name = None
        if labels is not None and labels.codes:
            for label, c in labels.codes.items():
                if str(c).lower() == code:
                    name = label.split("_")[0]
                    break
        if name is None:
            return _json({"error": "unknown species code"}, status=404)
        svc = getattr(self.ctx, "images", None)
        if svc is None:
            return _json({"error": "image provider disabled"}, status=404)
        info = await asyncio.get_event_loop().run_in_executor(
            None, svc.get_image, name)
        if info is None or not (info.thumbnail_url or info.url):
            return _json({"error": "no image"}, status=404)
        raise web.HTTPFound(info.thumbnail_url or info.url)

    async def h_metrics_history(self, request):
        """Rolling CPU/memory/disk samples (reference: system metrics
        history for the UI charts)."""
        hist = getattr(self.ctx, "metrics_history", None)
        if hist is None:
            return _json({"samples": []})
        limit = min(int(request.query.get("limit", 120)), 1000)
        return _json({"interval_seconds": hist.interval,
                      "samples": hist.history(limit)})

    async def h_trends(self, request):
        """Period-over-period trend (reference: GetDetectionTrends)."""
        days = min(max(int(request.query.get("days", 30)), 1), 365)
        return _json(self.ctx.datastore.detection_trends(days))

    async def h_species_daily_summary(self, request):
        """Species×hour daily grid (reference GET /analytics/species/
        daily, analytics.go:193-265): per-species count, 24 hourly
        buckets, max confidence, first/latest heard, new-species flags,
        and the cached thumbnail when the image provider has one."""
        import datetime as _dt

        date = request.query.get("date") or _dt.date.today().isoformat()
        try:
            min_conf = float(request.query.get("min_confidence", 0))
        except ValueError:
            return _json({"error": "bad min_confidence"}, status=400)
        rows = self.ctx.datastore.daily_species_summary(date, min_conf)
        get_cache = getattr(self.ctx.datastore, "get_image_cache", None)
        if get_cache is not None:
            for r in rows:
                img = get_cache(r["scientific_name"].lower())
                if img and img.get("thumbnail_url"):
                    r["thumbnail_url"] = img["thumbnail_url"]
        return _json({"date": date, "species": rows})

    async def h_daily_events(self, request):
        """Per-day rollup (reference: GetDailyEvents) — maintained on every
        detection insert, recomputed on demand when absent."""
        date = request.match_info["date"]
        ev = self.ctx.datastore.get_daily_events(date)
        if ev is None:
            ev = self.ctx.datastore.save_daily_events(date)
        return _json(ev)

    async def h_results_list(self, request):
        """Secondary predictions stored with a detection — the full top-K
        of the window that produced it (reference: Note.Results)."""
        return _json({"results": self.ctx.datastore.get_results(
            int(request.match_info["id"]))})

    async def h_reviews_list(self, request):
        return _json({"reviews": self.ctx.datastore.get_reviews(
            int(request.match_info["id"]))})

    async def h_unlock(self, request):
        ok = self.ctx.datastore.lock_detection(
            int(request.match_info["id"]), False)
        if not ok:
            return _json({"error": "not found"}, status=404)
        return _json({"locked": False})

    async def h_audio_by_id(self, request):
        """Clip audio by DETECTION id (GET /audio/:id)."""
        row = self.ctx.datastore.get_detection(int(request.match_info["id"]))
        if row is None or not row.get("clip_name"):
            return _json({"error": "not found"}, status=404)
        target = self._sandboxed_media(row["clip_name"])
        if target is None or not target.is_file():
            return _json({"error": "clip not available"}, status=404)
        return web.FileResponse(target)

    # -- analytics extras -----------------------------------------------------------------------

    def _dawn_rows(self, request):
        q = request.query
        return self.ctx.datastore.first_detection_per_day(
            species=q.get("species"), date_from=q.get("from"),
            date_to=q.get("to"))

    async def h_dawn_onset(self, request):
        """Minutes-after-civil-dawn of each species' first daily detection
        (reference: dawn-onset analytics)."""
        from birdnet_go_tpu_torch.utils.suncalc import sun_times

        lat = self.ctx.settings.location.latitude
        lon = self.ctx.settings.location.longitude
        if lat is None:
            return _json({"error": "location not configured"}, status=400)
        out = []
        for row in self._dawn_rows(request):
            d = _dt.date.fromisoformat(row["date"])
            st = sun_times(d, lat, lon)
            if st.civil_dawn is None:
                continue
            hh, mm, ss = (int(x) for x in row["first_time"].split(":"))
            # detections store LOCAL wall-clock time (sqlite fromtimestamp)
            # while suncalc returns tz-aware UTC — attach the host's local
            # offset, or minutes_after_dawn is skewed by the UTC offset
            local_tz = _dt.datetime.now().astimezone().tzinfo
            first = _dt.datetime.combine(d, _dt.time(hh, mm, ss),
                                         tzinfo=local_tz)
            offset = (first - st.civil_dawn).total_seconds() / 60.0
            out.append({**row, "minutes_after_dawn": round(offset, 1)})
        return _json({"dawn_onset": out})

    async def h_dawn_chorus(self, request):
        """Detections per minute-of-day histogram around dawn."""
        rows = self.ctx.datastore.hourly_distribution(
            date=request.query.get("date"))
        return _json({"hourly": rows})

    async def h_database_details(self, request):
        """Storage observability (reference DatabaseSqliteDetails /
        DatabaseTableBreakdown / DatabaseLocksWalCard /
        DetectionRateChart — frontend .../features/system/components)."""
        ds = self.ctx.datastore
        if not hasattr(ds, "database_details"):
            return _json({"error": "not supported by this datastore"},
                         status=501)
        return _json(await asyncio.get_event_loop().run_in_executor(
            None, ds.database_details))

    async def h_db_stats(self, request):
        ds = self.ctx.datastore
        return _json({
            "detections": ds.count_detections(),
            "species": len(ds.species_summary()),
            "path": ds.path,
        })

    async def h_dashboard_kpis(self, request):
        ds = self.ctx.datastore
        today = _dt.date.today().isoformat()
        return _json({
            "detections_total": ds.count_detections(),
            "detections_today": ds.count_detections(date_from=today),
            "species_today": ds.count_species(date_from=today),
            "species_total": ds.count_species(),
            "sources_active": len(self.ctx.engine.sources()),
            "models_loaded": list(self.ctx.classifiers),
        })

    # -- insights (analytics/insights.go) -------------------------------------------

    @staticmethod
    def _thumb_url(scientific: str) -> str:
        from urllib.parse import quote

        return f"/api/v2/species/thumbnail?name={quote(scientific)}"

    async def h_insights_expected_today(self, request):
        """Species expected today from day-of-year history
        (GET /insights/expected-today, insights.go:288-337)."""
        from birdnet_go_tpu_torch.analysis import insights as ins

        today = _dt.date.today()
        ranges = ins.build_year_ranges(today)
        rows = self.ctx.datastore.insights_expected_species(ranges)
        years = {r0[:4] for r0, _ in ranges}
        return _json({
            "species": [{
                "scientific_name": r["scientific_name"],
                "common_name": r["common_name"],
                "years_seen": r["years_seen"],
                "last_seen_date": r["last_seen_date"],
                "thumbnail_url": self._thumb_url(r["scientific_name"]),
            } for r in rows],
            "day_of_year": today.timetuple().tm_yday,
            "years_of_data": len(years),
        })

    async def h_insights_expected_regional(self, request):
        """Regionally expected species from eBird, minus locally known
        ones (GET /insights/expected-today/regional,
        insights.go:340-418). available=false when eBird or the site
        location is unconfigured."""
        from birdnet_go_tpu_torch.analysis import insights as ins

        s = self.ctx.settings
        if (not s.ebird.enabled or not s.ebird.api_token
                or s.location.latitude is None
                or s.location.longitude is None):
            return _json({"species": [], "available": False})
        try:
            obs = await asyncio.get_event_loop().run_in_executor(
                None, lambda: self._ebird.recent_observations(
                    s.location.latitude, s.location.longitude,
                    back_days=14))
        except Exception as e:
            return _json({"error": f"ebird query failed: {e}"},
                         status=502)
        local = {r["scientific_name"]
                 for r in self.ctx.datastore.insights_expected_species(
                     ins.build_year_ranges(_dt.date.today()))}
        seen: set[str] = set()
        items = []
        for o in obs:
            sci = o.get("sciName", "")
            if not sci or sci in local or sci in seen:
                continue
            seen.add(sci)
            items.append({
                "scientific_name": sci,
                "common_name": o.get("comName", ""),
                "observation_date": o.get("obsDt", ""),
                "location_name": o.get("locName", ""),
            })
        return _json({"species": items, "available": True})

    async def h_insights_phantom(self, request):
        """Frequent low-confidence species
        (GET /insights/phantom-species, insights.go:421-459)."""
        from birdnet_go_tpu_torch.analysis import insights as ins

        since = time.time() - ins.PHANTOM_PERIOD_DAYS * 86400
        rows = self.ctx.datastore.insights_phantom_species(
            since, ins.PHANTOM_MIN_DETECTIONS,
            ins.PHANTOM_MAX_AVG_CONFIDENCE)
        return _json({
            "species": [{
                "scientific_name": r["scientific_name"],
                "common_name": r["common_name"],
                "detection_count": r["detection_count"],
                "avg_confidence": round(r["avg_confidence"], 4),
                "max_confidence": round(r["max_confidence"], 4),
                "thumbnail_url": self._thumb_url(r["scientific_name"]),
            } for r in rows],
            "period_days": ins.PHANTOM_PERIOD_DAYS,
            "confidence_threshold": ins.PHANTOM_MAX_AVG_CONFIDENCE,
            "min_detections": ins.PHANTOM_MIN_DETECTIONS,
        })

    async def h_insights_dawn_chorus(self, request):
        """Species ranked by average earliest dawn-band detection
        (GET /insights/dawn-chorus, insights.go:462-538)."""
        from birdnet_go_tpu_torch.analysis import insights as ins

        since = time.time() - ins.DAWN_CHORUS_PERIOD_DAYS * 86400
        raw = self.ctx.datastore.insights_dawn_chorus_raw(
            since, ins.DAWN_CHORUS_START_HOUR, ins.DAWN_CHORUS_END_HOUR)
        items = ins.aggregate_dawn_chorus(raw)
        for it in items:
            it["thumbnail_url"] = self._thumb_url(it["scientific_name"])
        return _json({
            "species": items,
            "period_days": ins.DAWN_CHORUS_PERIOD_DAYS,
            "start_hour": ins.DAWN_CHORUS_START_HOUR,
            "end_hour": ins.DAWN_CHORUS_END_HOUR,
        })

    async def h_insights_migration(self, request):
        """New arrivals + gone-quiet species (GET /insights/migration,
        insights.go:541-600)."""
        from birdnet_go_tpu_torch.analysis import insights as ins

        today = _dt.date.today()
        recent = (today - _dt.timedelta(
            days=ins.MIGRATION_RECENT_DAYS)).isoformat()
        arrivals = self.ctx.datastore.insights_new_arrivals(recent)
        quiet = self.ctx.datastore.insights_gone_quiet(
            recent, ins.MIGRATION_MIN_TOTAL)
        return _json({
            "new_arrivals": [{
                "scientific_name": a["scientific_name"],
                "common_name": a["common_name"],
                "first_detected": a["first_detected"],
                "detection_count": a["detection_count"],
                "thumbnail_url": self._thumb_url(a["scientific_name"]),
            } for a in arrivals],
            "gone_quiet": [{
                "scientific_name": q["scientific_name"],
                "common_name": q["common_name"],
                "last_detected": q["last_detected"],
                "days_since": (today - _dt.date.fromisoformat(
                    q["last_detected"])).days,
                "total_detections": q["total_detections"],
                "thumbnail_url": self._thumb_url(q["scientific_name"]),
            } for q in quiet],
            "recent_days": ins.MIGRATION_RECENT_DAYS,
            "min_total_detections": ins.MIGRATION_MIN_TOTAL,
        })

    async def h_insights_kpis(self, request):
        """Headline dashboard KPIs with the consecutive-day streak
        (GET /dashboard/kpis, insights.go:603-660)."""
        from birdnet_go_tpu_torch.analysis.insights import calculate_streak

        today = _dt.date.today().isoformat()
        k = self.ctx.datastore.insights_dashboard_kpis(today)
        days, start = calculate_streak(k["recent_dates"], today)
        return _json({
            "lifetime_species": k["lifetime_species"],
            "today_detections": k["today_detections"],
            "best_day": {"date": k["best_day_date"],
                         "count": k["best_day_count"]},
            "detection_streak": {"days": days, "start_date": start},
        })

    # -- weather -----------------------------------------------------------------------------------

    async def h_weather_daily(self, request):
        rows = self.ctx.datastore.get_hourly_weather(
            request.match_info["date"])
        if not rows:
            return _json({"date": request.match_info["date"],
                          "available": False})
        temps = [r["temperature"] for r in rows
                 if r.get("temperature") is not None]
        return _json({
            "date": request.match_info["date"], "available": True,
            "temp_min": min(temps) if temps else None,
            "temp_max": max(temps) if temps else None,
            "hours": rows,
        })

    async def h_weather_sun(self, request):
        return await self.h_sun_times(request)

    async def h_weather_moon(self, request):
        from birdnet_go_tpu_torch.utils.suncalc import moon_phase

        d = _dt.date.fromisoformat(request.match_info["date"])
        return _json({"date": d.isoformat(), **moon_phase(d)})

    # -- species / taxonomy -----------------------------------------------------------------------

    def _primary_labels(self):
        return next(iter(self.ctx.labels.values()), None)

    async def h_species_detected(self, request):
        return _json({"species": self.ctx.datastore.species_summary(
            date_from=request.query.get("from"),
            date_to=request.query.get("to"))})

    async def h_species_all(self, request):
        labels = self._primary_labels()
        if labels is None:
            return _json({"species": []})
        limit = min(int(request.query.get("limit", 20000)), 20000)
        offset = int(request.query.get("offset", 0))
        out = [{"scientific_name": sp.scientific, "common_name": sp.common,
                "code": labels.code_for(sp)}
               for sp in list(labels.species)[offset:offset + limit]]
        return _json({"species": out, "total": len(labels)})

    async def h_species_search(self, request):
        q = request.query.get("q", "").lower()
        if len(q) < 2:
            return _json({"error": "query too short"}, status=400)
        labels = self._primary_labels()
        if labels is None:
            return _json({"species": []})
        out = [{"scientific_name": sp.scientific, "common_name": sp.common}
               for sp in labels.species
               if q in sp.scientific.lower() or q in sp.common.lower()]
        return _json({"species": out[:50]})

    async def h_species_taxonomy(self, request):
        from birdnet_go_tpu_torch.taxonomy.labels import (
            genus_of,
            load_genus_taxonomy,
        )

        name = request.query.get("name", "")
        if not name:
            return _json({"error": "name required"}, status=400)
        genus = genus_of(name)
        tax = load_genus_taxonomy(self.ctx.settings.data_dir) or {}
        info = tax.get(genus) or tax.get(genus.lower()) or {}
        return _json({"scientific_name": name, "genus": genus,
                      **(info if isinstance(info, dict) else
                         {"family": info})})

    async def h_taxonomy_tree(self, request):
        """Genus → species tree over the primary model's label set."""
        labels = self._primary_labels()
        if labels is None:
            return _json({"tree": {}})
        from birdnet_go_tpu_torch.taxonomy.labels import genus_of

        tree: dict[str, list[dict]] = {}
        for sp in labels.species:
            tree.setdefault(genus_of(sp.scientific), []).append(
                {"scientific_name": sp.scientific,
                 "common_name": sp.common})
        return _json({"genera": len(tree), "tree": tree})

    # -- HLS live audio (hlsmux) ----------------------------------------------------------

    async def h_hls_start(self, request):
        sid = request.match_info["source"]
        s = self.ctx.hls.start_session(sid)
        if s is None:
            return _json({"error": "unknown source"}, status=404)
        base = f"/api/v2/audio/hls/{sid}"
        return _json({"playlist": f"{base}/playlist.m3u8",
                      "codec": f"{s.codec} (fMP4)",
                      "segment_seconds": s.segment_seconds})

    async def h_hls_heartbeat(self, request):
        if not self.ctx.hls.heartbeat(request.match_info["source"]):
            return _json({"error": "no session"}, status=404)
        return _json({"ok": True})

    async def h_hls_stop(self, request):
        return _json({"stopped": self.ctx.hls.stop_session(
            request.match_info["source"])})

    def _hls_session(self, request):
        return self.ctx.hls.get(request.match_info["source"])

    async def h_hls_playlist(self, request):
        s = self._hls_session(request)
        if s is None:
            return _json({"error": "no session"}, status=404)
        return web.Response(text=s.playlist(),
                            content_type="application/vnd.apple.mpegurl")

    async def h_hls_init(self, request):
        s = self._hls_session(request)
        if s is None:
            return _json({"error": "no session"}, status=404)
        return web.Response(body=s.init, content_type="video/mp4")

    async def h_hls_segment(self, request):
        s = self._hls_session(request)
        if s is None:
            return _json({"error": "no session"}, status=404)
        name = request.match_info["seg"]
        if not name.startswith("seg"):
            return _json({"error": "bad segment"}, status=400)
        seg = s.segment(int(name[3:]))
        if seg is None:
            return _json({"error": "segment expired"}, status=404)
        return web.Response(body=seg, content_type="video/iso.segment")

    # -- species images (imageprovider) -----------------------------------------------------

    async def h_species_image(self, request):
        """Image metadata for a species (GET /media/species-image?name=)."""
        svc = getattr(self.ctx, "images", None)
        name = request.query.get("name", "")
        if svc is None or not name:
            return _json({"error": "image provider disabled" if not name
                          else "name required"}, status=404 if svc is None
                         else 400)
        info = await asyncio.get_event_loop().run_in_executor(
            None, svc.get_image, name)
        if info is None:
            return _json({"error": "no image"}, status=404)
        return _json(info.as_dict())

    async def h_species_thumbnail(self, request):
        """302 to the cached thumbnail (dashboard <img> consumer)."""
        svc = getattr(self.ctx, "images", None)
        name = request.query.get("name", "")
        if svc is None or not name:
            return _json({"error": "unavailable"}, status=404)
        info = await asyncio.get_event_loop().run_in_executor(
            None, svc.get_image, name)
        if info is None or not (info.thumbnail_url or info.url):
            return _json({"error": "no image"}, status=404)
        raise web.HTTPFound(info.thumbnail_url or info.url)

    async def h_image_stats(self, request):
        svc = getattr(self.ctx, "images", None)
        return _json(svc.stats() if svc else {"enabled": False})

    # -- imports -----------------------------------------------------------------------------------

    # -- imports -----------------------------------------------------------------------------------

    @property
    def _import_mgr(self):
        if getattr(self, "_import_mgr_obj", None) is None:
            from birdnet_go_tpu_torch.utils.imports import ImportJobManager

            self._import_mgr_obj = ImportJobManager(self.ctx.datastore)
        return self._import_mgr_obj

    # -- live migration (reference internal/datastore/v2/migration) ---------

    async def h_migration_status(self, request):
        worker = getattr(self, "_migration_worker", None)
        if worker is None:
            # surface persisted state even before a worker exists this boot
            from birdnet_go_tpu_torch.datastore.migration import MigrationStateStore
            st = MigrationStateStore(self.ctx.datastore).get()
            return _json({"state": st["state"],
                          "total_records": st["total_records"],
                          "migrated_records": st["migrated_records"],
                          "legacy_path": st["legacy_path"],
                          "error": st["error"]})
        return _json(worker.status())

    async def h_migration_start(self, request):
        from birdnet_go_tpu_torch.datastore.migration import MigrationWorker

        body = await request.json()
        path = body.get("path", "")
        if not Path(path).is_file():
            return _json({"error": f"no such file: {path}"}, status=400)
        worker = getattr(self, "_migration_worker", None)
        if worker is None or not (worker._thread and
                                  worker._thread.is_alive()):
            worker = MigrationWorker(
                self.ctx.datastore, path,
                dual_write=bool(body.get("dual_write", True)))
            self._migration_worker = worker
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, worker.start, bool(body.get("force", False)))
        except (RuntimeError, ValueError) as e:
            return _json({"error": str(e)}, status=409)
        return _json(worker.status(), status=202)

    async def h_migration_ctl(self, request):
        worker = getattr(self, "_migration_worker", None)
        if worker is None:
            # server restarted mid-migration: rebuild the worker from the
            # persisted state so resume/cancel/rollback keep working
            from birdnet_go_tpu_torch.datastore.migration import (
                MigrationStateStore, MigrationWorker)
            st = MigrationStateStore(self.ctx.datastore).get()
            if not st["legacy_path"] or st["state"] in ("idle", "completed"):
                return _json({"error": "no migration this session"},
                             status=404)
            worker = MigrationWorker(self.ctx.datastore, st["legacy_path"])
            self._migration_worker = worker
        action = request.path.rsplit("/", 1)[-1]
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, {"pause": worker.pause, "resume": worker.resume,
                       "cancel": worker.cancel,
                       "rollback": worker.rollback}[action])
        except RuntimeError as e:
            return _json({"error": str(e)}, status=409)
        return _json(worker.status())

    async def h_import_birdnet_go(self, request):
        """Migrate a reference BirdNET-Go SQLite database in place:
        detections + results + reviews + comments + locks
        (POST /imports/birdnet-go {path})."""
        from birdnet_go_tpu_torch.utils.imports import import_birdnet_go_db

        body = await request.json()
        path = body.get("path", "")
        if not Path(path).is_file():
            return _json({"error": f"no such file: {path}"}, status=400)
        try:
            res = await asyncio.get_event_loop().run_in_executor(
                None, import_birdnet_go_db, self.ctx.datastore, path)
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        return _json({"scanned": res.scanned, "imported": res.imported,
                      "skipped": res.skipped, "errors": res.errors})

    async def h_import_start(self, request):
        body = await request.json()
        path = body.get("path", "")
        if not Path(path).is_file():
            return _json({"error": f"no such file: {path}"}, status=400)
        job = self._import_mgr.submit(
            path, min_confidence=float(body.get("min_confidence", 0.0)))
        return _json({"job": job.as_dict()}, status=202)

    async def h_import_jobs(self, request):
        return _json({"jobs": self._import_mgr.list()})

    async def h_import_job(self, request):
        job = self._import_mgr.get(int(request.match_info["id"]))
        if job is None:
            return _json({"error": "not found"}, status=404)
        return _json(job.as_dict())

    async def h_import_cancel(self, request):
        if not self._import_mgr.cancel(int(request.match_info["id"])):
            return _json({"error": "not found"}, status=404)
        return _json({"cancelled": True})

    # -- model install -------------------------------------------------------------------------------

    @property
    def _install_progress(self) -> dict:
        if getattr(self, "_install_progress_obj", None) is None:
            self._install_progress_obj = {}
        return self._install_progress_obj

    async def h_model_install(self, request):
        from birdnet_go_tpu_torch.models.catalog import ModelManager, get_entry

        model_id = request.match_info["id"]
        entry = get_entry(model_id)
        if entry is None:
            return _json({"error": "unknown model"}, status=404)
        progress = self._install_progress
        progress[model_id] = {"status": "running", "error": ""}

        def _install():
            try:
                ModelManager().install_from_url(entry)
                progress[model_id] = {"status": "completed", "error": ""}
            except Exception as e:  # noqa: BLE001
                progress[model_id] = {"status": "failed", "error": str(e)}
            self.sse.publish("models", "install",
                             {"model_id": model_id, **progress[model_id]})

        asyncio.get_event_loop().run_in_executor(None, _install)
        return _json({"installing": model_id}, status=202)

    async def h_model_install_progress(self, request):
        model_id = request.match_info["id"]
        p = self._install_progress.get(model_id)
        if p is None:
            return _json({"error": "no install in progress"}, status=404)
        return _json({"model_id": model_id, **p})

    async def h_model_remove(self, request):
        from birdnet_go_tpu_torch.models.catalog import ModelManager

        if not ModelManager().remove(request.match_info["id"]):
            return _json({"error": "not installed"}, status=404)
        return _json({"removed": True})

    # -- support / filesystem ---------------------------------------------------------------------------

    async def h_support_dump(self, request):
        from birdnet_go_tpu_torch.utils.support import collect_support_bundle

        bundle = await asyncio.get_event_loop().run_in_executor(
            None, collect_support_bundle, self.ctx)
        return web.Response(
            body=bundle.data,
            headers={"Content-Type": "application/zip",
                     "Content-Disposition":
                     f'attachment; filename="{bundle.name}"'})

    async def h_storage_reconcile(self, request):
        """Run one clip-orphan reconcile pass on demand (clears DANGLING
        clip_name DB references, never files; clip_reconcile.go). Also
        returns the report-only orphan/missing view."""
        dm = self.ctx.diskmanager
        if dm is None:
            from birdnet_go_tpu_torch.utils.diskmanager import (
                DiskManager,
                RetentionPolicy,
            )

            dm = DiskManager(self.ctx.settings.export.path,
                             RetentionPolicy(mode="none"),
                             datastore=self.ctx.datastore)
        loop = asyncio.get_event_loop()
        passed = await loop.run_in_executor(None, dm.reconcile_orphans_pass)
        report = await loop.run_in_executor(None, dm.reconcile)
        return _json({"pass": passed, "report": {
            "orphan_files": report["orphan_files"][:200],
            "missing_files": report["missing_files"][:200]}})

    async def h_fs_clips(self, request):
        base = Path(self.ctx.settings.export.path)
        if not base.is_dir():
            return _json({"files": []})
        files = []
        # clips nest under year/month (buildClipPath layout); name is the
        # clip-dir-relative path the media endpoints accept
        for p in sorted(base.rglob("*")):
            if p.is_file():
                st = p.stat()
                files.append({"name": p.relative_to(base).as_posix(),
                              "size_bytes": st.st_size,
                              "modified": st.st_mtime})
        return _json({"files": files, "count": len(files)})

    # -- range filter extras --------------------------------------------------------------

    async def h_range_count(self, request):
        inc = self.ctx.processor.included_species
        return _json({"count": len(inc) if inc is not None else None,
                      "enabled": inc is not None})

    async def h_range_csv(self, request):
        inc = sorted(self.ctx.processor.included_species or [])
        body = "scientific_name\n" + "\n".join(inc) + ("\n" if inc else "")
        return web.Response(text=body, content_type="text/csv", headers={
            "Content-Disposition":
                'attachment; filename="range_species.csv"'})

    async def h_range_scores(self, request):
        """Per-species occurrence scores at the configured location
        (GET /range/species/scores?limit=)."""
        s = self.ctx.settings
        if s.location.latitude is None:
            return _json({"error": "location not configured"}, status=400)
        import numpy as np

        scores = await asyncio.get_event_loop().run_in_executor(
            None, self.ctx.range_filter_scores,
            s.location.latitude, s.location.longitude, -1)
        labels = self._primary_labels()
        limit = min(int(request.query.get("limit", 100)), 5000)
        order = np.argsort(np.asarray(scores))[::-1][:limit]
        out = [{"scientific_name": labels[int(i)].scientific
                if labels and i < len(labels) else f"#{int(i)}",
                "score": round(float(scores[int(i)]), 4)}
               for i in order]
        return _json({"scores": out,
                      "threshold": s.range_filter.threshold})

    # -- alert rules import/export ----------------------------------------------------------

    async def h_alerts_export(self, request):
        import dataclasses as dc

        eng = self.ctx.alerting
        rules = [dc.asdict(r) for r in eng.list_rules()] if eng else []
        return web.Response(
            text=json.dumps({"version": 1, "rules": rules}, indent=2,
                            default=str),
            content_type="application/json",
            headers={"Content-Disposition":
                     'attachment; filename="alert_rules.json"'})

    async def h_alerts_import(self, request):
        from birdnet_go_tpu_torch.analysis.alerting import AlertRule

        eng = self.ctx.alerting
        if eng is None:
            return _json({"error": "alerting inactive"}, status=503)
        body = await request.json()
        imported, failed = 0, 0
        for raw in body.get("rules", []):
            try:
                eng.add_rule(AlertRule(**raw))
                imported += 1
            except TypeError:
                failed += 1
        return _json({"imported": imported, "failed": failed})

    # -- aux: update / telemetry / profiling / taxonomy chain ---------------------------

    async def h_update_check(self, request):
        from birdnet_go_tpu_torch.utils.update import check_for_update

        out = await asyncio.get_event_loop().run_in_executor(
            None, check_for_update)
        return _json(out)

    async def h_telemetry_stats(self, request):
        from birdnet_go_tpu_torch.utils import telemetry

        return _json(telemetry.stats())

    async def h_debug_profile(self, request):
        """CPU profile of the running process for N seconds (reference:
        token-gated pprof endpoints; here behind the auth middleware)."""
        import cProfile
        import io
        import pstats

        seconds = min(float(request.query.get("seconds", 5)), 60.0)
        prof = cProfile.Profile()
        prof.enable()
        await asyncio.sleep(seconds)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
            .print_stats(40)
        return web.Response(text=buf.getvalue(),
                            content_type="text/plain")

    async def h_succession(self, request):
        q = request.query
        return _json({"succession": self.ctx.datastore.succession(
            date_from=q.get("from"), date_to=q.get("to"),
            top_n=min(int(q.get("top", 10)), 50))})

    @property
    def _ebird(self):
        if getattr(self, "_ebird_client", None) is None:
            from birdnet_go_tpu_torch.integrations.ebird import EBirdClient

            self._ebird_client = EBirdClient(
                api_token=self.ctx.settings.ebird.api_token)
        return self._ebird_client

    async def h_ebird_taxonomy(self, request):
        if not self.ctx.settings.ebird.enabled:
            return _json({"error": "ebird integration disabled"},
                         status=503)
        rows = await asyncio.get_event_loop().run_in_executor(
            None, lambda: self._ebird.taxonomy(
                species_code=request.query.get("species"),
                scientific=request.query.get("scientific")))
        return _json({"taxonomy": rows})

    async def h_ebird_observations(self, request):
        s = self.ctx.settings
        if not s.ebird.enabled:
            return _json({"error": "ebird integration disabled"},
                         status=503)
        if s.location.latitude is None:
            return _json({"error": "location not configured"}, status=400)
        rows = await asyncio.get_event_loop().run_in_executor(
            None, lambda: self._ebird.recent_observations(
                s.location.latitude, s.location.longitude,
                dist_km=int(request.query.get("dist", 25))))
        return _json({"observations": rows})

    async def h_species_info(self, request):
        """Alias resolution + class/order/family metadata (openfauna)."""
        from birdnet_go_tpu_torch.taxonomy.openfauna import (
            canonical_name,
            species_metadata,
        )

        name = request.query.get("name", "")
        if not name:
            return _json({"error": "name required"}, status=400)
        canon = canonical_name(name)
        meta = dict(species_metadata(canon) or {})
        meta.pop("scientific_name", None)      # don't shadow the echo
        from birdnet_go_tpu_torch.taxonomy import nonbird

        out = {"scientific_name": name, "canonical_name": canon,
               "aliased": canon != name, **meta}
        cat = nonbird.category_of(name) or nonbird.category_of(canon)
        if cat:
            # non-taxa sound class (labels/nonbird role): the UI badges
            # these instead of linking taxonomy pages
            out["nonbird_category"] = cat
        return _json(out)

    async def h_species_locales(self, request):
        from birdnet_go_tpu_torch.taxonomy.speciesdict import available_locales

        return _json({"locales": available_locales()})

    # -- settings PUT -------------------------------------------------------------------------------------

    async def h_put_settings(self, request):
        """Whole-document settings update: merges every provided section
        (reference: PUT /settings with section merge + signals)."""
        import dataclasses

        from birdnet_go_tpu_torch.config.control import ControlSignal
        from birdnet_go_tpu_torch.config.settings import (
            ModelSettings,
            _merge_dataclass,
        )

        from birdnet_go_tpu_torch.api.server import _strip_masked

        body = _strip_masked(await request.json())
        updated = []
        # snapshot + rollback on type mismatch, same contract as the
        # per-section PATCH: 400, live tree untouched
        import copy

        from birdnet_go_tpu_torch.config.settings import restore_settings_in_place
        snapshot = copy.deepcopy(self.ctx.settings)
        try:
            for section, value in body.items():
                if not hasattr(self.ctx.settings, section):
                    continue
                target = getattr(self.ctx.settings, section)
                if section == "models" and isinstance(value, list):
                    self.ctx.settings.models = [
                        _merge_dataclass(ModelSettings(), v) for v in value]
                elif dataclasses.is_dataclass(target):
                    if not isinstance(value, dict):
                        # same contract as the per-section PATCH: a scalar
                        # must never replace a dataclass subtree
                        restore_settings_in_place(self.ctx.settings,
                                                  snapshot)
                        return _json(
                            {"error": f"section {section!r} requires an "
                                      f"object body, got "
                                      f"{type(value).__name__}"},
                            status=400)
                    _merge_dataclass(target, value)
                else:
                    setattr(self.ctx.settings, section, value)
                updated.append(section)
            warnings = self.ctx.settings.validate()
        except Exception as e:
            # broad on purpose: the snapshot restore must ALWAYS run
            # (advisor r4, medium — same hole as the PATCH path)
            restore_settings_in_place(self.ctx.settings, snapshot)
            status = 400 if isinstance(e, (TypeError, ValueError)) else 500
            return _json({"error": str(e),
                          **({"field": e.key}
                             if hasattr(e, "key") else {})}, status=status)
        if self.ctx.control is not None and updated:
            # a full-document write may touch anything: fire the broad set
            for sig in (ControlSignal.RELOAD_THRESHOLDS,
                        ControlSignal.RELOAD_SPECIES_CONFIG,
                        ControlSignal.UPDATE_DETECTION_INTERVALS,
                        ControlSignal.RECONFIGURE_SOURCES):
                self.ctx.control.send(sig)
        return _json({"updated": updated, "warnings": warnings})

    # -- TLS certificate management (internal/api/v2/tls/tls.go) -------------------------

    @property
    def _tls_mgr(self):
        from birdnet_go_tpu_torch.utils.tlscert import TLSManager

        return TLSManager(self.ctx.settings.webserver.tls_dir)

    def _tls_restart_note(self):
        """Certificate writes take effect on the next server start
        (tls.go reasonTLSCertRestart → restart banner)."""
        reasons = getattr(self.ctx, "restart_required", None)
        if reasons is not None and "tlsCertificate" not in reasons:
            reasons.append("tlsCertificate")
        try:
            from birdnet_go_tpu_torch.integrations.notification import Notification

            self.ctx.notification_inbox.add(Notification(
                title="Restart required",
                message="TLS certificate changed — restart the web server"
                        " for it to take effect",
                priority="high", payload={"reason": "tlsCertificate"}))
        except Exception:
            pass

    async def h_tls_get(self, request):
        info = self._tls_mgr.info()
        if info.get("installed"):
            info["mode"] = "enabled" \
                if self.ctx.settings.webserver.tls_enabled else "installed"
        return _json(info)

    async def h_tls_upload(self, request):
        from birdnet_go_tpu_torch.utils.tlscert import validate_key_pair

        body = await request.json()
        cert = (body.get("certificate") or "").strip()
        key = (body.get("privateKey") or "").strip()
        if not cert or not key:
            return _json({"error": "certificate and private key are"
                          " required"}, status=400)
        try:
            validate_key_pair(cert, key)
            self._tls_mgr.save(cert, key)
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        self._tls_restart_note()
        return _json({"installed": True, "restartRequired": True})

    async def h_tls_delete(self, request):
        if not self._tls_mgr.delete():
            return _json({"error": "no certificate installed"}, status=404)
        self._tls_restart_note()
        return _json({"deleted": True, "restartRequired": True})

    async def h_tls_generate(self, request):
        from birdnet_go_tpu_torch.utils.tlscert import (
            collect_sans,
            generate_self_signed,
            parse_validity,
        )

        body = await request.json() if request.can_read_body else {}
        try:
            validity = parse_validity(body.get("validity"))
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        ws = self.ctx.settings.webserver
        cert, key = generate_self_signed(
            validity=validity, sans=collect_sans(ws.host, ws.base_url))
        self._tls_mgr.save(cert, key)
        self._tls_restart_note()
        info = self._tls_mgr.info()
        info["restartRequired"] = True
        return _json(info)

    async def h_tls_download(self, request):
        mgr = self._tls_mgr
        if not mgr.exists():
            return _json({"error": "no certificate installed"}, status=404)
        return web.Response(
            body=mgr.cert_path().read_bytes(),
            content_type="application/x-pem-file",
            headers={"Content-Disposition":
                     'attachment; filename="cert.pem"'})

    # -- on-demand clip + processing (media.go clip extraction / ProcessAudioByID) --------

    async def h_audio_clip_generate(self, request):
        status, payload = await asyncio.get_event_loop().run_in_executor(
            None, self.ctx.export_clip_for_detection,
            int(request.match_info["id"]))
        return _json(payload, status=status)

    async def h_audio_process(self, request):
        """Normalize / apply gain to a detection's stored clip and return
        WAV (media.go ProcessAudioRequest {normalize, gain_db})."""
        import io

        import numpy as np

        from birdnet_go_tpu_torch.audio.wav import write_wav

        row = self.ctx.datastore.get_detection(int(request.match_info["id"]))
        if row is None or not row.get("clip_name"):
            return _json({"error": "not found"}, status=404)
        target = self._sandboxed_media(row["clip_name"])
        if target is None or not target.is_file():
            return _json({"error": "clip not available"}, status=404)
        body = await request.json() if request.can_read_body else {}
        gain_db = float(body.get("gain_db", 0.0))
        do_norm = bool(body.get("normalize", False))

        def _process():
            samples, rate = self.ctx.clip_encoder.decode(target)
            if do_norm:
                from birdnet_go_tpu_torch.audio.audionorm import normalize

                samples = normalize(samples, rate)
            if gain_db:
                samples = samples * (10.0 ** (gain_db / 20.0))
            pcm = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
            buf = io.BytesIO()
            write_wav(buf, pcm, rate)
            return buf.getvalue()

        data = await asyncio.get_event_loop().run_in_executor(None, _process)
        return web.Response(body=data, content_type="audio/wav")

    # -- integrations test group ------------------------------------------------------------

    async def h_mqtt_status(self, request):
        m = self.ctx.mqtt
        s = self.ctx.settings.mqtt
        return _json({"enabled": s.enabled, "host": s.host, "port": s.port,
                      "topic": s.topic,
                      "connected": bool(m and m.is_connected)})

    async def h_mqtt_test(self, request):
        """Publish a test message through the live client, or a transient
        one built from settings when MQTT isn't running."""
        s = self.ctx.settings.mqtt

        def _test() -> tuple[bool, str]:
            m = self.ctx.mqtt
            transient = False
            if m is None:
                from birdnet_go_tpu_torch.integrations.mqtt import MqttClient

                m = MqttClient(s.host, s.port, username=s.username,
                               password=s.password, tls=s.tls)
                m.start()
                transient = True
            try:
                if not m.wait_connected(5):
                    return False, "broker not reachable"
                m.publish(f"{s.topic}/test",
                          {"message": "birdnet test", "ok": True})
                return True, "test message published"
            finally:
                if transient:
                    m.stop()

        ok, detail = await asyncio.get_event_loop().run_in_executor(None,
                                                                    _test)
        return _json({"success": ok, "message": detail},
                     status=200 if ok else 502)

    async def h_mqtt_ha_discovery(self, request):
        if self.ctx.mqtt is None or not self.ctx.mqtt.is_connected:
            return _json({"error": "MQTT not connected"}, status=502)
        from birdnet_go_tpu_torch.integrations.mqtt import ha_discovery_payloads

        payloads = ha_discovery_payloads(self.ctx.settings.mqtt.topic)
        for topic, cfg in payloads.items():
            self.ctx.mqtt.publish(topic, cfg, retain=True)
        return _json({"published": len(payloads)})

    async def h_birdweather_test(self, request):
        bw = self.ctx.birdweather
        if bw is None:
            return _json({"error": "BirdWeather not configured"},
                         status=503)
        ok = await asyncio.get_event_loop().run_in_executor(None, bw.probe)
        return _json({"success": ok}, status=200 if ok else 502)

    async def h_ebird_test(self, request):
        if not self.ctx.settings.ebird.enabled:
            return _json({"error": "ebird integration disabled"},
                         status=503)

        def _probe():
            try:
                rows = self._ebird.taxonomy(species_code="houspa")
                return bool(rows), f"{len(rows)} taxonomy rows"
            except Exception as e:  # noqa: BLE001
                return False, str(e)

        ok, detail = await asyncio.get_event_loop().run_in_executor(None,
                                                                    _probe)
        return _json({"success": ok, "message": detail},
                     status=200 if ok else 502)

    async def h_weather_test(self, request):
        poller = self.ctx.weather_poller
        if poller is None:
            return _json({"error": "weather provider not configured"},
                         status=503)

        def _probe():
            try:
                obs = poller.provider.fetch()
                return True, f"{len(obs)} observations"
            except Exception as e:  # noqa: BLE001
                return False, str(e)

        ok, detail = await asyncio.get_event_loop().run_in_executor(None,
                                                                    _probe)
        return _json({"success": ok, "message": detail},
                     status=200 if ok else 502)

    # -- app bootstrap / introspection ---------------------------------------------------------

    def _wizard_flag(self) -> Path:
        base = Path(self.ctx.settings.data_dir or "data")
        return base / ".wizard_dismissed"

    async def h_app_config(self, request):
        """Frontend bootstrap config (GET /app/config)."""
        s = self.ctx.settings
        from birdnet_go_tpu_torch.version import __version__

        return _json({
            "version": __version__,
            "locale": s.models[0].locale if s.models else "en",
            "security_enabled": bool(s.webserver.password
                                     or s.webserver.auth_token),
            "models": [m.model_id for m in s.models],
            "location_configured": s.location.latitude is not None,
            "wizard_dismissed": self._wizard_flag().exists(),
            "tls": bool(getattr(s.webserver, "tls_enabled", False)),
        })

    async def h_wizard_dismiss(self, request):
        flag = self._wizard_flag()
        flag.parent.mkdir(parents=True, exist_ok=True)
        flag.write_text("")
        return _json({"dismissed": True})

    async def h_control_actions(self, request):
        """Available control actions with descriptions (control.go)."""
        from birdnet_go_tpu_torch.config.control import ControlSignal

        return _json({"actions": [
            {"action": sig.value,
             "description": sig.name.replace("_", " ").lower()}
            for sig in ControlSignal]})

    async def h_sse_status(self, request):
        counts = {ch: self.sse.client_count(ch)
                  for ch in ("detections", "notifications", "pending",
                             "health", "soundlevels", "audio-level")}
        return _json({"channels": counts,
                      "total": self.sse.client_count()})

    # -- system extras -----------------------------------------------------------------------

    async def h_sys_audio_active(self, request):
        eng = self.ctx.engine
        health = eng.stream_health() if eng else {}
        return _json({"active": [
            {"source_id": sid, **info} for sid, info in health.items()]})

    async def h_sys_audio_sources(self, request):
        eng = self.ctx.engine
        return _json({"sources": [
            {"source_id": s.source_id, "type": s.source_type.value,
             "display_name": s.display_name, "sample_rate": s.sample_rate}
            for s in (eng.sources() if eng else [])]})

    async def h_eq_config_get(self, request):
        eq = self.ctx.settings.audio_filters
        return _json({"enabled": eq.enabled, "filters": eq.filters})

    async def h_eq_config_put(self, request):
        """Hot-swap the per-stream equalizer chains (builder.go swap)."""
        body = await request.json()
        eq = self.ctx.settings.audio_filters
        if "enabled" in body:
            eq.enabled = bool(body["enabled"])
        if "filters" in body:
            if not isinstance(body["filters"], list):
                return _json({"error": "filters must be a list"},
                             status=400)
            # validate designs before swapping anything live
            from birdnet_go_tpu_torch.audio.equalizer import FilterChain

            try:
                FilterChain.from_config(48000, body["filters"])
            except (KeyError, ValueError) as e:
                return _json({"error": f"bad filter spec: {e}"}, status=400)
            eq.filters = body["filters"]
        if self.ctx.engine is not None:
            self.ctx.engine.set_equalizer(eq.filters if eq.enabled else None)
        return _json({"enabled": eq.enabled, "filters": eq.filters})

    async def h_network_interfaces(self, request):
        import socket

        out = []
        for _idx, name in socket.if_nameindex():
            entry = {"name": name}
            try:
                entry["mac"] = Path(
                    f"/sys/class/net/{name}/address").read_text().strip()
                entry["state"] = Path(
                    f"/sys/class/net/{name}/operstate").read_text().strip()
            except OSError:
                pass
            out.append(entry)
        return _json({"interfaces": out})

    async def h_restart_status(self, request):
        reasons = getattr(self.ctx, "restart_required", [])
        return _json({"restart_required": bool(reasons),
                      "reasons": list(reasons)})

    async def h_db_overview(self, request):
        ds = self.ctx.datastore
        import os

        overview = {
            "engine": "mysql" if str(ds.path).startswith("mysql")
            else "sqlite",
            "path": str(ds.path),
            "detections": ds.count_detections(),
            "species": len(ds.species_summary()),
            "integrity": ds.integrity_check(),
        }
        if not str(ds.path).startswith("mysql") \
                and os.path.isfile(str(ds.path)):
            overview["size_bytes"] = os.path.getsize(str(ds.path))
        return _json(overview)

    async def h_db_backup_run(self, request):
        mgr = self.ctx.backup
        if mgr is None:
            return _json({"error": "backup not configured"}, status=503)
        name = await asyncio.get_event_loop().run_in_executor(None,
                                                              mgr.run_once)
        return _json({"backup": name, "runs": mgr.runs})

    async def h_db_backup_jobs(self, request):
        mgr = self.ctx.backup
        if mgr is None:
            return _json({"jobs": [], "configured": False})
        return _json({"configured": True, "runs": mgr.runs,
                      "history": list(getattr(mgr, "history", []))})

    async def h_db_backup_verify(self, request):
        """Restore verification: fetch latest (or ?name=) archive from
        the target, decrypt, check manifest hashes, and integrity-check
        the restored database (utils.backup.verify_archive)."""
        mgr = self.ctx.backup
        if mgr is None:
            return _json({"error": "backup not configured"}, status=503)
        name = request.query.get("name")
        try:
            report = await asyncio.get_event_loop().run_in_executor(
                None, lambda: mgr.verify(name))
        except Exception as e:
            return _json({"verified": False, "error": str(e)}, status=422)
        return _json({"verified": True, **report})

    async def h_events_operational(self, request):
        bus = self.ctx.events
        if bus is None:
            return _json({"events": []})
        limit = min(int(request.query.get("limit", 50)), 200)
        return _json({"events": bus.recent(limit,
                                           kind=request.query.get("kind"))})

    async def h_diagnostics_run(self, request):
        """Run every registered health check NOW and return the results
        (system/diagnostics/run)."""
        import dataclasses as dc

        reg = self.ctx.health
        if reg is None:
            return _json({"error": "health registry not running"},
                         status=503)
        results = await asyncio.get_event_loop().run_in_executor(
            None, reg.run_all)
        return _json({"checks": [dc.asdict(r) for r in results],
                      "healthy": all(r.healthy for r in results)})

    async def h_import_validate(self, request):
        """Parse a BirdNET-Pi export without inserting anything
        (import/validate)."""
        from birdnet_go_tpu_torch.utils.imports import parse_birdnet_pi_log

        body = await request.json()
        path = body.get("path", "")
        if not path or not Path(path).is_file():
            return _json({"valid": False, "error": "file not found"},
                         status=400)

        def _validate():
            try:
                rows = parse_birdnet_pi_log(path)
                return {"valid": True, "detections": len(rows),
                        "species": len({d.species.scientific
                                        for d in rows})}
            except Exception as e:  # noqa: BLE001
                return {"valid": False, "error": str(e)}

        out = await asyncio.get_event_loop().run_in_executor(None,
                                                             _validate)
        return _json(out, status=200 if out["valid"] else 422)
