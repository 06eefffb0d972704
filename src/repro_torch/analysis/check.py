"""The port's invariant gate, the counterpart of ``scripts/lint.sh``:

    python -m repro_torch.analysis.check

runs torchlint over ``src/repro_torch``, ``tests`` and ``chip_smoke.py``,
the geometry auditor (``--check``) and torchprove (``--check --device
cpu``), in that order, and exits with the worst of their statuses (0
clean, 1 findings, 2 a usage error).
"""

from __future__ import annotations

import os
import sys

from . import geometry, lint, prove

__all__ = ["main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    if argv:
        print("python -m repro_torch.analysis.check takes no arguments",
              file=sys.stderr)
        return 2
    paths = [os.path.join(_REPO, p) for p in lint.DEFAULT_PATHS]
    steps = (("torchlint", lambda: lint.main(paths)),
             ("geometry", lambda: geometry.main(["--check"])),
             ("torchprove", lambda: prove.main(["--check", "--device",
                                                "cpu"])))
    worst = 0
    for name, step in steps:
        print(f"== {name}", flush=True)
        rc = step()
        print(f"== {name}: exit {rc}", flush=True)
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
