"""launch_ms.backlog: ``portbench.readers.launch_ms``."""

from portbench.readers import launch_ms as read  # noqa: F401
