"""Puts the checkout's root and ``src/`` on the path for the benchmark's own
tests: ``python -m pytest -q cardbench/tests`` from the root."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)
