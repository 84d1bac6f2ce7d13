"""Host resource monitoring (reference: internal/monitor via gopsutil).

Pure-stdlib sampling of CPU load, memory, and disk for the
/api/v2/system/resources endpoint and health checks.

A copy of ``birdnet_go_tpu/utils/sysmonitor.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import os
import shutil
import time


def cpu_load() -> dict:
    try:
        la1, la5, la15 = os.getloadavg()
    except OSError:
        la1 = la5 = la15 = 0.0
    return {"load_1m": round(la1, 2), "load_5m": round(la5, 2),
            "load_15m": round(la15, 2), "cores": os.cpu_count()}


def memory_info() -> dict:
    info = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("MemTotal", "MemAvailable", "MemFree"):
                    info[key] = int(rest.strip().split()[0]) * 1024
    except OSError:
        return {}
    total = info.get("MemTotal", 0)
    avail = info.get("MemAvailable", info.get("MemFree", 0))
    return {
        "total_bytes": total,
        "available_bytes": avail,
        "used_percent": round(100.0 * (total - avail) / total, 1)
        if total else 0.0,
    }


def disk_info(path: str = ".") -> dict:
    try:
        u = shutil.disk_usage(path)
    except OSError:
        return {}
    return {
        "total_bytes": u.total,
        "free_bytes": u.free,
        "used_percent": round(100.0 * (u.total - u.free) / u.total, 1),
    }


def resources(clip_dir: str = ".") -> dict:
    return {
        "time": time.time(),
        "cpu": cpu_load(),
        "memory": memory_info(),
        "disk": disk_info(clip_dir),
    }


def processes(limit: int = 20) -> list[dict]:
    """Top processes by RSS from /proc (reference: GET /system/processes
    via gopsutil). Pure stdlib; returns [] on non-Linux."""
    procs = []
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return []
    page = os.sysconf("SC_PAGE_SIZE")
    hz = os.sysconf("SC_CLK_TCK")
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            # comm may contain spaces/parens: split around the last ')'
            lparen = stat.index("(")
            rparen = stat.rindex(")")
            comm = stat[lparen + 1:rparen]
            fields = stat[rparen + 2:].split()
            utime, stime = int(fields[11]), int(fields[12])
            rss_pages = int(fields[21])
            procs.append({
                "pid": int(pid),
                "name": comm,
                "cpu_seconds": round((utime + stime) / hz, 1),
                "rss_bytes": rss_pages * page,
            })
        except (OSError, ValueError, IndexError):
            continue
    procs.sort(key=lambda p: p["rss_bytes"], reverse=True)
    return procs[:limit]


def disks() -> list[dict]:
    """Usage for every real mounted filesystem (GET /system/disks)."""
    out = []
    seen = set()
    try:
        with open("/proc/mounts") as f:
            mounts = [line.split()[:3] for line in f]
    except OSError:
        mounts = [("", "/", "")]
    for dev, mountpoint, fstype in mounts:
        if fstype in ("proc", "sysfs", "devpts", "tmpfs", "cgroup",
                      "cgroup2", "overlay", "devtmpfs", "securityfs",
                      "debugfs", "tracefs", "fusectl", "configfs",
                      "pstore", "bpf", "mqueue", "hugetlbfs", "autofs",
                      "binfmt_misc", "rpc_pipefs", "nsfs"):
            continue
        if mountpoint in seen:
            continue
        seen.add(mountpoint)
        info = disk_info(mountpoint)
        if info:
            out.append({"mountpoint": mountpoint, "device": dev,
                        "fstype": fstype, **info})
    return out


def cpu_temperature() -> dict:
    """CPU temperature from /sys/class/thermal (GET /system/temperature/cpu).
    Returns {"available": False} when no sensor exists (VMs, containers)."""
    base = "/sys/class/thermal"
    try:
        zones = sorted(z for z in os.listdir(base)
                       if z.startswith("thermal_zone"))
    except OSError:
        zones = []
    for zone in zones:
        try:
            with open(f"{base}/{zone}/type") as f:
                ztype = f.read().strip()
            with open(f"{base}/{zone}/temp") as f:
                millic = int(f.read().strip())
            return {"available": True, "celsius": round(millic / 1000.0, 1),
                    "sensor": ztype}
        except (OSError, ValueError):
            continue
    return {"available": False}


def audio_devices() -> list[dict]:
    """ALSA card inventory from /proc/asound (GET /devices). The native
    library's enumeration (when loaded) supplements with PCM device names."""
    cards = []
    try:
        with open("/proc/asound/cards") as f:
            text = f.read()
    except OSError:
        return []
    import re

    for m in re.finditer(r"^\s*(\d+)\s+\[(\S+)\s*\]:\s*(.*)$", text,
                         re.MULTILINE):
        idx, cid, desc = int(m.group(1)), m.group(2), m.group(3).strip()
        devices = []
        try:
            with open(f"/proc/asound/card{idx}/pcm0c/info") as f:
                for line in f:
                    if line.startswith("name:"):
                        devices.append(line.split(":", 1)[1].strip())
        except OSError:
            pass
        card = {"index": idx, "id": cid, "description": desc,
                "alsa_name": f"hw:{idx},0", "capture_pcm": devices}
        card.update(usb_identity(idx))
        cards.append(card)
    return cards


def usb_identity(card_index: int) -> dict:
    """USB vendor/product fingerprint for a sound card (reference:
    usb_linux.go — re-match a configured device after replug/reorder by
    identity, not index). {} for non-USB cards."""
    import os.path

    base = f"/sys/class/sound/card{card_index}/device"
    out = {}
    # walk up to the USB device directory (it has idVendor/idProduct)
    node = os.path.realpath(base)
    for _ in range(4):
        if os.path.isfile(f"{node}/idVendor"):
            for key, name in (("idVendor", "usb_vendor"),
                              ("idProduct", "usb_product"),
                              ("serial", "usb_serial"),
                              ("product", "usb_name")):
                try:
                    with open(f"{node}/{key}") as f:
                        out[name] = f.read().strip()
                except OSError:
                    pass
            break
        node = os.path.dirname(node)
    return out


class MetricsHistory:
    """Rolling resource samples for the System page's charts (reference:
    system metrics history endpoint). Bounded ring; sampling thread owned
    by the Application lifecycle."""

    def __init__(self, interval_seconds: float = 30.0, keep: int = 360,
                 clip_dir: str = "."):
        import collections
        import threading
        import time

        self.interval = interval_seconds
        self.clip_dir = clip_dir
        self._ring = collections.deque(maxlen=keep)
        self._stop = threading.Event()
        self._thread = None
        self._threading = threading
        self._time = time

    def sample_once(self) -> dict:
        r = resources(self.clip_dir)
        s = {"time": self._time.time(),
             "load_1m": r.get("cpu", {}).get("load_1m"),
             "memory_pct": r.get("memory", {}).get("used_percent"),
             "disk_pct": r.get("disk", {}).get("used_percent")}
        self._ring.append(s)
        return s

    def history(self, limit: int | None = None) -> list[dict]:
        out = list(self._ring)
        return out[-limit:] if limit else out

    def start(self) -> None:
        self.sample_once()
        self._stop.clear()
        self._thread = self._threading.Thread(
            target=self._run, name="metrics-history", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception:   # noqa: BLE001 — keep sampling
                pass
