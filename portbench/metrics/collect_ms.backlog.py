"""collect_ms.backlog: ``portbench.readers.collect_ms``."""

from portbench.readers import collect_ms as read  # noqa: F401
