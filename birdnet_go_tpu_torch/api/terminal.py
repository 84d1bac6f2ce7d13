"""Browser terminal: WebSocket ↔ PTY bridge (reference: GET /api/v2/system/ws
xterm-over-PTY via creack/pty; here Python's stdlib pty + a WebSocket).

Security: the endpoint rides behind the auth middleware when security is
enabled; with security disabled it only accepts DIRECT local connections
(a shell must never be reachable from the open network by default).

A copy of ``birdnet_go_tpu/api/terminal.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_terminal.py`` holds it to
the original. Its WebSocket is ``api/web.py``'s ``WebSocketResponse``
(the standard library's ``asyncio`` under aiohttp's names), where JAX's
is aiohttp's; the checks, the shell and its reaping are JAX's.
"""

from __future__ import annotations

import asyncio
import fcntl
import logging
import os
import pty
import signal
import struct
import termios

from birdnet_go_tpu_torch.api import web
from birdnet_go_tpu_torch.api.auth import is_local_address
from birdnet_go_tpu_torch.api.web import WSMsgType

log = logging.getLogger("birdnet_tpu.terminal")


class TerminalHandlers:
    """Mixin for ApiServer."""

    def register_terminal_routes(self, r, v2: str) -> None:
        r.add_get(f"{v2}/system/ws", self.h_terminal_ws)

    async def h_terminal_ws(self, request):
        # Cross-site WebSocket hijacking guard: browsers send cookies and
        # apply NO same-origin policy to WS handshakes, so a malicious page
        # could otherwise open a shell with the victim's session (or their
        # local-subnet position). A browser always sends Origin — it must
        # match the request host; non-browser clients (no Origin) pass.
        origin = request.headers.get("Origin")
        if origin:
            from urllib.parse import urlparse

            if urlparse(origin).netloc != request.host:
                return web.json_response(
                    {"error": "cross-origin terminal access denied"},
                    status=403)
        sec = getattr(self, "security", None)
        secured = sec is not None and sec.enabled
        proxied = ("X-Forwarded-For" in request.headers
                   or "X-Real-IP" in request.headers
                   or "Forwarded" in request.headers)
        if not secured and (proxied or not request.remote
                            or not is_local_address(request.remote)):
            return web.json_response(
                {"error": "terminal requires authentication"}, status=403)

        ws = web.WebSocketResponse()
        await ws.prepare(request)

        pid, master = pty.fork()
        if pid == 0:                     # child: exec the shell
            env = dict(os.environ, TERM="xterm-256color")
            shell = os.environ.get("SHELL", "/bin/bash")
            try:
                os.execvpe(shell, [shell, "-i"], env)
            finally:
                os._exit(1)

        loop = asyncio.get_event_loop()
        os.set_blocking(master, False)

        def _resize(cols: int, rows: int) -> None:
            try:
                fcntl.ioctl(master, termios.TIOCSWINSZ,
                            struct.pack("HHHH", rows, cols, 0, 0))
            except OSError:
                pass

        _resize(120, 32)

        async def pump_pty_to_ws():
            while not ws.closed:
                try:
                    data = os.read(master, 65536)
                except BlockingIOError:
                    await asyncio.sleep(0.02)
                    continue
                except OSError:
                    break
                if not data:
                    break
                try:
                    await ws.send_bytes(data)
                except ConnectionError:
                    break
            if not ws.closed:
                await ws.close()

        reader = loop.create_task(pump_pty_to_ws())
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    if msg.data.startswith("\x00resize:"):
                        try:
                            cols, rows = msg.data[8:].split("x")
                            _resize(int(cols), int(rows))
                        except ValueError:
                            pass
                        continue
                    os.write(master, msg.data.encode())
                elif msg.type == WSMsgType.BINARY:
                    os.write(master, msg.data)
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            reader.cancel()
            try:
                os.close(master)
            except OSError:
                pass
            _reap_child(pid)
        return ws


def _reap_child(pid: int) -> None:
    """SIGHUP the shell, then reap it off-thread (a single WNOHANG right
    after the signal races the shell's exit and leaks a zombie)."""
    import threading

    try:
        os.kill(pid, signal.SIGHUP)
    except ProcessLookupError:
        pass

    def waiter():
        deadline = 5.0
        step = 0.05
        waited = 0.0
        while waited < deadline:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                return
            if done:
                return
            import time as _t

            _t.sleep(step)
            waited += step
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass

    threading.Thread(target=waiter, name=f"pty-reap-{pid}",
                     daemon=True).start()
