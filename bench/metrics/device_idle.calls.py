"""device_idle.calls: see ``bench.readers.device_idle``."""

from bench.readers import device_idle as read  # noqa: F401
