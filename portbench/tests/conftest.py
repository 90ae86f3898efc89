"""The benchmark's CPU tests: the checkout's root on the path, so that
``portbench`` and ``transform360_tpu_torch`` import from it (neither jax
nor the JAX package is imported here)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
