"""HTTP API (reference: internal/api/v2 — REST + SSE under /api/v2).

A copy of ``birdnet_go_tpu/api/__init__.py`` for the port: the server runs
on its own thread and event loop (``api/web.py``, the standard library's
``asyncio``), so the threaded realtime pipeline (device loop, processor,
job queue) stays framework-agnostic; cross-thread events reach SSE
clients via call_soon_threadsafe. ``static/`` is the SPA, byte for byte
the JAX package's.
"""

from birdnet_go_tpu_torch.api.server import ApiServer

__all__ = ["ApiServer"]
