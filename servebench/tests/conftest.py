"""Paths for the benchmark's own tests: the repository root (for
``servebench``) and ``src`` (for the program under test)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
