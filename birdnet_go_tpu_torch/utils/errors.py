"""Enhanced error taxonomy (a copy of ``birdnet_go_tpu/utils/errors.py``, so
that the port imports nothing of the JAX package; reference:
internal/errors EnhancedError — component/category/context-tagged errors
feeding the health ring buffer and the event bus instead of bare log lines).

One part is left out: the original's ``ErrorBuilder.build`` also hands each
error to ``birdnet_go_tpu.utils.telemetry.capture_error``, which belongs to
the app's wiring; the port has no app. ``tests/test_torch_hostplane.py``
holds the error and its log record to the original's.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Any

log = logging.getLogger("birdnet_tpu.errors")


class Category:
    NETWORK = "network"
    DATABASE = "database"
    AUDIO = "audio"
    MODEL = "model"
    CONFIG = "configuration"
    FILE_IO = "file-io"
    VALIDATION = "validation"
    SYSTEM = "system"
    NOT_FOUND = "not-found"
    GENERIC = "generic"


class EnhancedError(Exception):
    """Error enriched with component/category/context + timing."""

    def __init__(self, message: str, component: str = "",
                 category: str = Category.GENERIC,
                 context: dict[str, Any] | None = None,
                 cause: BaseException | None = None):
        super().__init__(message)
        self.message = message
        self.component = component
        self.category = category
        self.context = dict(context or {})
        self.cause = cause
        self.timestamp = time.time()

    def as_dict(self) -> dict:
        return {
            "message": self.message,
            "component": self.component,
            "category": self.category,
            "context": self.context,
            "cause": repr(self.cause) if self.cause else None,
            "timestamp": self.timestamp,
        }

    def __str__(self) -> str:
        tag = f"[{self.component}/{self.category}]" if self.component \
            else f"[{self.category}]"
        ctx = f" {self.context}" if self.context else ""
        return f"{tag} {self.message}{ctx}"


class ErrorBuilder:
    """Fluent builder (errors.New(err).Component(...).Category(...).Build()).
    Build() logs one ERROR record, which the health error buffer reads."""

    def __init__(self, err_or_message):
        if isinstance(err_or_message, BaseException):
            self._message = str(err_or_message)
            self._cause = err_or_message
        else:
            self._message = str(err_or_message)
            self._cause = None
        self._component = ""
        self._category = Category.GENERIC
        self._context: dict[str, Any] = {}

    def component(self, name: str) -> "ErrorBuilder":
        self._component = name
        return self

    def category(self, cat: str) -> "ErrorBuilder":
        self._category = cat
        return self

    def context(self, key: str, value: Any) -> "ErrorBuilder":
        self._context[key] = value
        return self

    def build(self) -> EnhancedError:
        err = EnhancedError(self._message, self._component, self._category,
                            self._context, self._cause)
        # the health error ring buffer is a logging handler — one ERROR
        # record feeds the /system/errors endpoint and any log sinks;
        # exc_info carries the traceback so call sites don't need (and
        # must not add) a second log.exception for the same incident
        logging.getLogger(
            f"birdnet_tpu.{err.component or 'app'}").error(
            "%s", err, exc_info=self._cause if self._cause is not None
            and self._cause.__traceback__ is not None else None)
        return err


def new(err_or_message) -> ErrorBuilder:
    return ErrorBuilder(err_or_message)


def from_exception(e: BaseException, component: str,
                   category: str = Category.GENERIC) -> EnhancedError:
    b = ErrorBuilder(e).component(component).category(category)
    b._context["traceback"] = "".join(
        traceback.format_exception_only(type(e), e)).strip()
    return b.build()
