"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, CUDA, the plan, inputs
from the seed, warm-up) is timed from the first line of this file; the
window then runs for ``--seconds``; the outputs it kept are judged
against the plain reference; the last line of standard output is one
JSON object.  Without a CUDA card it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Fixed cache directories inside the checkout, so that only a checkout's
# first run compiles (the port's nvcc libraries go to its own build/).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / ".cache" / "torch_extensions")
sys.path[0:1] = [str(ROOT)]  # the checkout's root, not portbench/, is on the path

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
