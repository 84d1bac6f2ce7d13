"""step_mfu.offline: ``portbench.readers.step_mfu``."""

from portbench.readers import step_mfu as read  # noqa: F401
