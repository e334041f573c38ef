"""The harness's tests: small configurations on the CPU, one test on the
card (marked `cuda`). Run from the repository's root:

    python -m pytest -q bench/tests
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
