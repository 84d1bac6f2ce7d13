"""MQTT 3.1.1 client + embedded test broker (no external MQTT library).

Reference: internal/mqtt — Paho client with reconnect loop, TLS, Home
Assistant discovery (discovery.go), detection DTO publishing; an embedded
broker (broker.go) backs the in-process tests. This implements the MQTT
3.1.1 wire protocol directly: CONNECT/CONNACK, PUBLISH (QoS 0/1) /PUBACK,
SUBSCRIBE/SUBACK, PINGREQ/PINGRESP, DISCONNECT, with exponential-backoff
reconnect.

A copy of ``birdnet_go_tpu/integrations/mqtt.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_integrations.py``
holds it to the original, each client against either broker. One
addition: ``MiniBroker`` keeps the last retained message of each topic
(``retained``: a PUBLISH with the RETAIN flag; an empty one clears it, as
MQTT 3.1.1 §3.3.1.3 says) and sends those that match to a new
subscription, as a broker does; JAX's test broker keeps none.
"""

from __future__ import annotations

import json
import logging
import socket
import ssl as ssl_mod
import struct
import threading
import time
from typing import Callable

log = logging.getLogger("birdnet_tpu.mqtt")

_CONNECT, _CONNACK, _PUBLISH, _PUBACK = 0x10, 0x20, 0x30, 0x40
_SUBSCRIBE, _SUBACK, _PINGREQ, _PINGRESP = 0x82, 0x90, 0xC0, 0xD0
_DISCONNECT = 0xE0


def _encode_remaining(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _read_exact(sock, 1)[0]
    mult, length = 1, 0
    while True:
        b = _read_exact(sock, 1)[0]
        length += (b & 0x7F) * mult
        if not (b & 0x80):
            break
        mult *= 128
    payload = _read_exact(sock, length) if length else b""
    return hdr, payload


class MqttClient:
    """Threaded MQTT 3.1.1 client with auto-reconnect."""

    def __init__(self, host: str, port: int = 1883, client_id: str = "birdnet-tpu",
                 username: str | None = None, password: str | None = None,
                 keepalive: int = 60, tls: bool = False):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.username = username
        self.password = password
        self.keepalive = keepalive
        self.tls = tls
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._wlock = threading.Lock()     # serializes socket writes
        self._packet_id = 0
        self._connected = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._subs: dict[str, Callable[[str, bytes], None]] = {}
        self.published = 0
        self.errors = 0
        self.reconnects = 0

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="mqtt",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(bytes([_DISCONNECT, 0]))
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._connected.clear()

    def wait_connected(self, timeout: float = 5.0) -> bool:
        return self._connected.wait(timeout)

    @property
    def is_connected(self) -> bool:
        return self._connected.is_set()

    # -- wire --------------------------------------------------------------------

    def _connect_once(self) -> None:
        raw = socket.create_connection((self.host, self.port), timeout=10)
        if self.tls:
            ctx = ssl_mod.create_default_context()
            raw = ctx.wrap_socket(raw, server_hostname=self.host)
        flags = 0x02                                     # clean session
        payload = _encode_str(self.client_id)
        if self.username:
            flags |= 0x80
            payload += _encode_str(self.username)
            if self.password:
                flags |= 0x40
                payload += _encode_str(self.password)
        var = (_encode_str("MQTT") + bytes([4, flags])
               + struct.pack(">H", self.keepalive))
        pkt = bytes([_CONNECT]) + _encode_remaining(len(var) + len(payload)) \
            + var + payload
        raw.sendall(pkt)
        hdr, body = _read_packet(raw)
        if hdr & 0xF0 != _CONNACK or len(body) < 2 or body[1] != 0:
            raise ConnectionError(f"CONNACK refused: {body!r}")
        with self._lock:
            self._sock = raw
        self._connected.set()
        # re-subscribe after reconnect
        for topic in list(self._subs):
            self._send_subscribe(topic)

    def _run(self) -> None:
        backoff = 1.0
        while not self._stop.is_set():
            session_start = None        # set only once CONNACK succeeds
            try:
                self._connect_once()
                session_start = time.monotonic()
                self._read_loop()
            except (OSError, ConnectionError) as e:
                self._connected.clear()
                if self._stop.is_set():
                    return
                self.errors += 1
                # a session only counts as recovered after a CONNECTED
                # stretch ≥30 s — connect-succeeds-then-read-loop-dies
                # flapping (duplicate client id, broker killing the
                # session right after CONNACK) and slow-FAILING connects
                # (dead DNS blocking ~40 s per attempt) must both keep
                # accumulating toward the persistent-failure tag instead
                # of resetting backoff every lap
                if session_start is not None \
                        and time.monotonic() - session_start >= 30.0:
                    self._consec_errors = 0
                    backoff = 1.0
                consec = getattr(self, "_consec_errors", 0) + 1
                if consec == 5:
                    # persistent (not transient) failure → tagged error in
                    # the ring + telemetry; once per outage (the counter
                    # resets on a successful connect)
                    from birdnet_go_tpu_torch.utils.errors import (
                        Category,
                        from_exception,
                    )

                    from_exception(e, "mqtt", Category.NETWORK)
                self._consec_errors = consec
                log.warning("mqtt connection lost (%s); retry in %.0fs",
                            e, backoff)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 60.0)
                self.reconnects += 1

    def _read_loop(self) -> None:
        sock = self._sock
        sock.settimeout(self.keepalive / 2 if self.keepalive else 30)
        while not self._stop.is_set():
            try:
                hdr, body = _read_packet(sock)
            except socket.timeout:
                with self._wlock:
                    sock.sendall(bytes([_PINGREQ, 0]))   # keepalive
                continue
            t = hdr & 0xF0
            if t == _PUBLISH:
                tl = struct.unpack(">H", body[:2])[0]
                topic = body[2:2 + tl].decode()
                rest = body[2 + tl:]
                qos = (hdr >> 1) & 3
                if qos:
                    pid = struct.unpack(">H", rest[:2])[0]
                    rest = rest[2:]
                    with self._wlock:
                        sock.sendall(bytes([_PUBACK, 2])
                                     + struct.pack(">H", pid))
                self._dispatch(topic, rest)
            # PINGRESP/PUBACK/SUBACK need no action at QoS ≤ 1

    def _dispatch(self, topic: str, payload: bytes) -> None:
        for pattern, handler in self._subs.items():
            if _topic_matches(pattern, topic):
                try:
                    handler(topic, payload)
                except Exception:
                    log.exception("mqtt handler failed for %s", topic)

    # -- API -----------------------------------------------------------------------

    def publish(self, topic: str, payload: bytes | str | dict,
                qos: int = 0, retain: bool = False) -> bool:
        if isinstance(payload, dict):
            payload = json.dumps(payload, default=str)
        if isinstance(payload, str):
            payload = payload.encode()
        hdr = _PUBLISH | (qos << 1) | (1 if retain else 0)
        var = _encode_str(topic)
        if qos:
            with self._lock:
                self._packet_id = self._packet_id % 65535 + 1
                var += struct.pack(">H", self._packet_id)
        pkt = bytes([hdr]) + _encode_remaining(len(var) + len(payload)) \
            + var + payload
        with self._lock:
            sock = self._sock
        if sock is None:
            self.errors += 1
            return False
        try:
            # a partial PUBLISH interleaved with the read loop's PINGREQ /
            # PUBACK would corrupt the stream — one writer at a time
            with self._wlock:
                sock.sendall(pkt)
            self.published += 1
            return True
        except OSError:
            self.errors += 1
            self._connected.clear()
            return False

    def subscribe(self, topic: str,
                  handler: Callable[[str, bytes], None]) -> None:
        self._subs[topic] = handler
        if self.is_connected:
            self._send_subscribe(topic)

    def _send_subscribe(self, topic: str) -> None:
        with self._lock:
            self._packet_id = self._packet_id % 65535 + 1
            pid = self._packet_id
            sock = self._sock
        var = struct.pack(">H", pid) + _encode_str(topic) + bytes([0])
        pkt = bytes([_SUBSCRIBE]) + _encode_remaining(len(var)) + var
        if sock is not None:
            sock.sendall(pkt)


def _topic_matches(pattern: str, topic: str) -> bool:
    pp = pattern.split("/")
    tp = topic.split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return True
        if i >= len(tp):
            return False
        if p != "+" and p != tp[i]:
            return False
    return len(pp) == len(tp)


# ---------------------------------------------------------------------------
# Home Assistant discovery (reference: internal/mqtt/discovery.go)
# ---------------------------------------------------------------------------


def ha_discovery_payloads(base_topic: str = "birdnet",
                          device_name: str = "BirdNET-TPU",
                          node_id: str = "birdnet_tpu") -> dict[str, dict]:
    """topic → retained discovery config for Home Assistant MQTT discovery."""
    device = {
        "identifiers": [node_id],
        "name": device_name,
        "manufacturer": "birdnet-tpu",
        "model": "TPU bioacoustics server",
    }
    return {
        f"homeassistant/sensor/{node_id}/last_detection/config": {
            "name": "Last detection",
            "state_topic": f"{base_topic}/detections",
            "value_template": "{{ value_json.common_name }}",
            "json_attributes_topic": f"{base_topic}/detections",
            "unique_id": f"{node_id}_last_detection",
            "device": device,
        },
        f"homeassistant/sensor/{node_id}/confidence/config": {
            "name": "Last detection confidence",
            "state_topic": f"{base_topic}/detections",
            "value_template": "{{ (value_json.confidence * 100) | round(1) }}",
            "unit_of_measurement": "%",
            "unique_id": f"{node_id}_confidence",
            "device": device,
        },
    }


# ---------------------------------------------------------------------------
# Embedded test broker (reference: internal/mqtt/broker.go)
# ---------------------------------------------------------------------------


def _publish_packet(topic: str, payload: bytes, retain: bool = False
                    ) -> bytes:
    """A QoS 0 PUBLISH of `payload` on `topic`."""
    return (bytes([_PUBLISH | (1 if retain else 0)])
            + _encode_remaining(2 + len(topic.encode()) + len(payload))
            + _encode_str(topic) + payload)


class MiniBroker:
    """In-process MQTT 3.1.1 broker for tests: CONNECT, SUBSCRIBE, PUBLISH
    routing w/ + and # wildcards, PING. Not for production."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(16)
        self.port = self._server.getsockname()[1]
        self._clients: list[tuple[socket.socket, list[str]]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.messages: list[tuple[str, bytes]] = []
        self.retained: dict[str, bytes] = {}

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, name="minibroker",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            for sock, _ in self._clients:
                try:
                    sock.close()
                except OSError:
                    pass
            self._clients.clear()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            entry = (sock, [])
            with self._lock:
                self._clients.append(entry)
            t = threading.Thread(target=self._client_loop, args=(entry,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _client_loop(self, entry) -> None:
        sock, subs = entry
        try:
            while not self._stop.is_set():
                hdr, body = _read_packet(sock)
                t = hdr & 0xF0
                if t == _CONNECT:
                    sock.sendall(bytes([_CONNACK, 2, 0, 0]))
                elif t == _SUBSCRIBE & 0xF0 and hdr == _SUBSCRIBE:
                    pid = struct.unpack(">H", body[:2])[0]
                    pos = 2
                    granted = []
                    new = []
                    while pos < len(body):
                        tl = struct.unpack(">H", body[pos:pos + 2])[0]
                        topic = body[pos + 2:pos + 2 + tl].decode()
                        subs.append(topic)
                        new.append(topic)
                        pos += 2 + tl + 1
                        granted.append(0)
                    sock.sendall(bytes([_SUBACK, 2 + len(granted)])
                                 + struct.pack(">H", pid) + bytes(granted))
                    with self._lock:
                        kept = [(rt, rp) for rt, rp in self.retained.items()
                                if any(_topic_matches(n, rt) for n in new)]
                    for rt, rp in kept:
                        sock.sendall(_publish_packet(rt, rp, retain=True))
                elif t == _PUBLISH:
                    tl = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tl].decode()
                    rest = body[2 + tl:]
                    qos = (hdr >> 1) & 3
                    if qos:
                        pid = struct.unpack(">H", rest[:2])[0]
                        rest = rest[2:]
                        sock.sendall(bytes([_PUBACK, 2])
                                     + struct.pack(">H", pid))
                    self.messages.append((topic, rest))
                    if hdr & 0x01:                   # RETAIN
                        with self._lock:
                            if rest:
                                self.retained[topic] = rest
                            else:
                                self.retained.pop(topic, None)
                    self._route(topic, rest, exclude=None)
                elif hdr == _PINGREQ:
                    sock.sendall(bytes([_PINGRESP, 0]))
                elif t == _DISCONNECT:
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                if entry in self._clients:
                    self._clients.remove(entry)
            try:
                sock.close()
            except OSError:
                pass

    def _route(self, topic: str, payload: bytes, exclude) -> None:
        pkt = _publish_packet(topic, payload)
        with self._lock:
            clients = list(self._clients)
        for sock, subs in clients:
            if any(_topic_matches(p, topic) for p in subs):
                try:
                    sock.sendall(pkt)
                except OSError:
                    pass
