"""CPU tests of the benchmark (``bench/``): tiny cells on the program's
``device="cpu"`` path, where the kernels' plain versions run."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
