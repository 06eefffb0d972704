"""The port's walkthroughs, the counterparts of the reference's
``examples/*.py``: ``quickstart``, ``boson_sampling``,
``sparse_matchings``, ``large_permanent`` and ``service``.

    python -m repro_torch.examples.quickstart [--device cpu|cuda]

Each module's ``main(device=None)`` prints what the reference example
prints and returns the values it printed.  The sizes come from the
device: on the CPU the reference example's own sizes, seeds and order of
draws (so the same matrices come out); on the card (the default) sizes
that run the kernels at the main path's shapes.
"""

from __future__ import annotations

import argparse

__all__ = ["card", "cli"]


def card(device) -> tuple[str, bool]:
    """(device string, whether it is the card); a card that is asked for
    and missing raises."""
    from ..core.ryser import resolve_device
    dev = resolve_device(device)
    return str(dev), dev.type == "cuda"


def cli(main, doc: str | None = None) -> None:
    """Run ``main`` with the ``--device`` of the command line."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the permanents run (default: the card)")
    main(ap.parse_args().device)
