"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
``bench/harness.py`` says how a run goes.  Without a CUDA card, or with
fewer than the cell asks for, it exits with code 3 and prints no result.
"""

import time

T0 = time.time()             # set-up is timed from here

import sys                   # noqa: E402
from pathlib import Path     # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout, not bench/, leads the path: names in bench/ must not
# shadow the standard library's; the program lives under src/
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

if __name__ == "__main__":
    from bench.harness import main
    sys.exit(main(sys.argv[1:], T0))
