"""Process-wide logging configuration.

Reference: internal/logger (central slog logger, per-module children with
individual levels, buffered rotating file writers) plus the main.go
wiring that tees WARN+ records into the health error ring buffer
(main.go:139-150) so /system/errors and the System Health page surface
recent problems without log-file access.

A copy of ``birdnet_go_tpu/utils/logsetup.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "warn": logging.WARNING,
           "error": logging.ERROR}


def configure_logging(settings=None, debug: bool = False) -> None:
    """Idempotent root-logger setup: stderr + optional rotating file +
    the WARN+ → error-ring tee. Safe to call again on settings reload
    (handlers are replaced, not stacked)."""
    from birdnet_go_tpu_torch.utils.health import GLOBAL_ERROR_BUFFER

    log_cfg = getattr(settings, "log", None)
    level = logging.DEBUG if debug else _LEVELS.get(
        (log_cfg.level if log_cfg else "info").lower(), logging.INFO)

    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter(_FORMAT)

    # replace only the handlers this function owns (marked) so pytest's
    # caplog and embedding applications keep theirs
    for h in list(root.handlers):
        if getattr(h, "_birdnet_owned", False):
            root.removeHandler(h)

    stderr = logging.StreamHandler()
    stderr.setFormatter(fmt)
    stderr._birdnet_owned = True
    root.addHandler(stderr)

    if log_cfg and log_cfg.path:
        path = Path(log_cfg.path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(
            path, maxBytes=int(log_cfg.max_size_mb * 1024 * 1024),
            backupCount=max(0, int(log_cfg.keep)), encoding="utf-8")
        fileh.setFormatter(fmt)
        fileh._birdnet_owned = True
        root.addHandler(fileh)

    # WARN+ tee into the health ring (slog_handler.go role). The buffer is
    # a singleton; adding it twice would double-record.
    if GLOBAL_ERROR_BUFFER not in root.handlers:
        root.addHandler(GLOBAL_ERROR_BUFFER)

    # per-module level overrides (logger children semantics)
    if log_cfg:
        for module, lvl in (log_cfg.module_levels or {}).items():
            name = module if module.startswith("birdnet_tpu") \
                else f"birdnet_tpu.{module}"
            logging.getLogger(name).setLevel(
                _LEVELS.get(str(lvl).lower(), logging.INFO))
