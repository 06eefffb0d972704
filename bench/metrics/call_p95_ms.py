"""call_p95_ms: see ``bench.readers.call_p95_ms``."""

from bench.readers import call_p95_ms as read  # noqa: F401
