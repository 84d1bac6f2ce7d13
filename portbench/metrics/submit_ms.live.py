"""submit_ms.live: ``portbench.readers.submit_ms``."""

from portbench.readers import submit_ms as read  # noqa: F401
