"""dispatch_host_ms.calls: see ``bench.readers.dispatch_host_ms``."""

from bench.readers import dispatch_host_ms as read  # noqa: F401
