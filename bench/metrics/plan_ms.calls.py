"""plan_ms.calls: see ``bench.readers.plan_ms``."""

from bench.readers import plan_ms as read  # noqa: F401
