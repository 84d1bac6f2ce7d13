"""Server-sent-events broadcaster (reference SSE channels: detections,
notifications, audio level, soundlevels — SURVEY.md Appendix A).

A copy of ``birdnet_go_tpu/api/sse.py`` for the port, which imports nothing
of the JAX package; ``tests/test_torch_api.py`` holds it to the original.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any


class SseBroadcaster:
    """Per-channel fan-out to connected SSE clients. Thread-safe publish."""

    def __init__(self):
        self._clients: dict[str, set[asyncio.Queue]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None

    def bind(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def subscribe(self, channel: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self._clients.setdefault(channel, set()).add(q)
        return q

    def unsubscribe(self, channel: str, q: asyncio.Queue) -> None:
        self._clients.get(channel, set()).discard(q)

    def publish(self, channel: str, event: str, data: Any) -> None:
        """Callable from any thread."""
        if self._loop is None:
            return
        payload = json.dumps(data, default=str)
        self._loop.call_soon_threadsafe(self._publish_local, channel,
                                        event, payload)

    def _publish_local(self, channel: str, event: str, payload: str) -> None:
        for q in list(self._clients.get(channel, ())):
            try:
                q.put_nowait((event, payload))
            except asyncio.QueueFull:
                pass                      # slow consumer: drop (bounded)

    def client_count(self, channel: str | None = None) -> int:
        if channel is not None:
            return len(self._clients.get(channel, ()))
        return sum(len(s) for s in self._clients.values())


def format_sse(event: str, payload: str) -> bytes:
    return f"event: {event}\ndata: {payload}\n\n".encode()
