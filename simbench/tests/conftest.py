"""Puts the repository root (for ``simbench``), ``src`` (for the port) and
this folder (for the sizes one test module shares with another) on the path of the benchmark's own tests."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
