"""idle_in_sparse.calls: see ``bench.spans.idle_in``."""

from bench.spans import idle_in


def read(view) -> float | None:
    return idle_in(view, "repro.dispatch.sparse")
