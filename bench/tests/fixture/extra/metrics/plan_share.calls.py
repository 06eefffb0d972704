"""plan_share.calls: percent of the window's call time spent planning."""


def read(view):
    total = sum(p + e for p, e in view.calls)
    return 100.0 * sum(p for p, _ in view.calls) / total if total else None
