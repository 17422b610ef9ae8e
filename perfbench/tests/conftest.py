"""The harness's own tests.  Run from the checkout's root:

    python -m pytest perfbench/tests -q

Tests marked ``gpu`` need a CUDA device and skip without one; on the card
run them with ``-m gpu``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
