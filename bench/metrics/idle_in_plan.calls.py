"""idle_in_plan.calls: see ``bench.spans.idle_in``."""

from bench.spans import idle_in


def read(view) -> float | None:
    return idle_in(view, "repro.plan")
