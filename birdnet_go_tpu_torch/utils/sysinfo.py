"""Runtime-environment detection: container / VM / WSL2 / bare metal,
CPU architecture naming, external-media mount probing, and process RSS.

Reference: internal/sysinfo (environment.go — ordered detection: sentinel
files → `container` env var → cgroup → systemd marker → WSL2 kernel →
DMI vendor → cpuinfo hypervisor flag; externalmedia.go — device-id
mountpoint probe; memory.go — RSS). `root` is injectable everywhere so
tests build fake filesystems (environment_test.go does the same).

A copy of ``birdnet_go_tpu/utils/sysinfo.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_api.py`` holds it to the
original.
"""

from __future__ import annotations

import functools
import os
import platform
from pathlib import Path

ENV_DOCKER = "Docker"
ENV_PODMAN = "Podman"
ENV_LXC = "LXC"
ENV_NSPAWN = "systemd-nspawn"
ENV_CONTAINER = "Container"

_CONTAINER_ENVS = {ENV_DOCKER, ENV_PODMAN, ENV_LXC, ENV_NSPAWN,
                   ENV_CONTAINER}

# the host path where install scripts bind-mount external media
DEFAULT_EXTERNAL_MOUNT = "/external"


def _read(path: Path) -> str:
    try:
        return path.read_text(errors="replace").strip()
    except OSError:
        return ""


def _map_container_var(value: str) -> tuple[str, str]:
    v = value.lower()
    if v == "docker":
        return ENV_DOCKER, ""
    if v == "podman":
        return ENV_PODMAN, ""
    if v == "lxc":
        return ENV_LXC, ""
    if v == "systemd-nspawn":
        return ENV_NSPAWN, ""
    return ENV_CONTAINER, value


def detect_environment(root: str = "/") -> tuple[str, str]:
    """(env_type, detail). Detection order mirrors environment.go:137-181:
    containers first, then WSL2, then hypervisors, else bare metal."""
    if platform.system() != "Linux":
        return "Native", ""
    r = Path(root)
    if (r / ".dockerenv").exists():
        return ENV_DOCKER, ""
    if (r / "run" / ".containerenv").exists():
        return ENV_PODMAN, ""
    # the `container` env var only counts in production (root == "/") so a
    # containerized test runner can't leak into fake-root tests
    if root == "/" and os.environ.get("container"):
        return _map_container_var(os.environ["container"])
    cgroup = _read(r / "proc" / "self" / "cgroup")
    for needle, env in (("docker", ENV_DOCKER), ("podman", ENV_PODMAN),
                        ("lxc", ENV_LXC)):
        if needle in cgroup:
            return env, ""
    systemd = _read(r / "run" / "systemd" / "container")
    if systemd:
        return _map_container_var(systemd)
    version = _read(r / "proc" / "version").lower()
    if "microsoft-standard-wsl" in version:       # WSL2, not WSL1
        return "WSL2", ""
    env = _detect_dmi(r)
    if env[0]:
        return env
    if _has_hypervisor_flag(r / "proc" / "cpuinfo"):
        return "Virtual Machine", ""
    return "Bare Metal", ""


def _detect_dmi(r: Path) -> tuple[str, str]:
    dmi = r / "sys" / "class" / "dmi" / "id"
    vendor = _read(dmi / "sys_vendor").lower()
    product = _read(dmi / "product_name")
    if not vendor:
        return "", ""
    if "qemu" in vendor or "kvm" in vendor:
        return "KVM", product
    if "vmware" in vendor:
        return "VMware", product
    if "microsoft" in vendor and "virtual" in product.lower():
        return "Hyper-V", product
    if "innotek" in vendor or "oracle" in vendor:
        return "VirtualBox", product
    if "xen" in vendor:
        return "Xen", product
    if "parallels" in vendor:
        return "Parallels", product
    return "", ""


def _has_hypervisor_flag(cpuinfo: Path) -> bool:
    """Only the first flags line — the flag is uniform across cores."""
    try:
        with open(cpuinfo, errors="replace") as f:
            for line in f:
                if line.startswith("flags"):
                    return " hypervisor" in line
    except OSError:
        pass
    return False


@functools.lru_cache(maxsize=1)
def get_environment() -> tuple[str, str]:
    """Cached production detection (GetEnvironment's sync.Once)."""
    return detect_environment("/")


def is_container_env(env_type: str) -> bool:
    return env_type in _CONTAINER_ENVS


def is_container() -> bool:
    return is_container_env(get_environment()[0])


def cpu_arch(root: str = "/") -> str:
    """Human-readable arch; 32-bit ARM variants distinguished via
    /proc/cpuinfo 'CPU architecture' (environment.go detectARMVariant)."""
    m = platform.machine()
    if m in ("arm", "armv6l", "armv7l", "armv5l", ""):
        arch_line = ""
        try:
            with open(Path(root) / "proc" / "cpuinfo",
                      errors="replace") as f:
                for line in f:
                    if line.startswith("CPU architecture"):
                        arch_line = line.split(":", 1)[-1].strip()
                        break
        except OSError:
            pass
        return {"7": "armv7l", "6": "armv6l", "5": "armv5l"}.get(
            arch_line, m or "arm")
    return {"AMD64": "x86_64", "aarch64": "aarch64"}.get(m, m)


def cpu_model(root: str = "/") -> str:
    try:
        with open(Path(root) / "proc" / "cpuinfo", errors="replace") as f:
            for line in f:
                if line.lower().startswith(("model name", "hardware")):
                    return line.split(":", 1)[-1].strip()
    except OSError:
        pass
    return platform.processor() or ""


def probe_external_mount(path: str = DEFAULT_EXTERNAL_MOUNT) -> dict:
    """{exists, is_mountpoint, readable}: a path is a mountpoint when its
    device id differs from its parent's (externalmedia probe). Detects the
    'container started without the bind mount' misconfiguration."""
    out = {"exists": False, "is_mountpoint": False, "readable": False}
    try:
        st = os.stat(path)
    except OSError:
        return out
    out["exists"] = True
    try:
        parent = os.stat(os.path.dirname(os.path.abspath(path)) or "/")
        out["is_mountpoint"] = st.st_dev != parent.st_dev
    except OSError:
        pass
    try:
        os.listdir(path)
        out["readable"] = True
    except OSError:
        pass
    return out


def process_rss_bytes(pid: int | None = None) -> int:
    """Resident set size in bytes; 0 = unavailable (callers degrade)."""
    pid = pid or os.getpid()
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return 0


def environment_summary(root: str = "/") -> dict:
    """One dict for /system/info and the support bundle."""
    env_type, detail = (get_environment() if root == "/"
                        else detect_environment(root))
    uname = platform.uname()
    return {
        "environment": env_type,
        "environment_detail": detail,
        "is_container": is_container_env(env_type),
        "os": uname.system,
        "kernel": uname.release,
        "arch": cpu_arch(root),
        "cpu_model": cpu_model(root),
        "process_rss_bytes": process_rss_bytes(),
        "external_media": probe_external_mount(),
    }
