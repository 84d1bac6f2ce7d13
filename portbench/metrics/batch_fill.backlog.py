"""batch_fill.backlog: ``portbench.readers.batch_fill``."""

from portbench.readers import batch_fill as read  # noqa: F401
