"""mel_roofline.backlog: ``portbench.readers.mel_roofline``."""

from portbench.readers import mel_roofline as read  # noqa: F401
