"""Work counts and the table of peaks, from shapes alone: the yardstick the
rooflines and shares of peak are taken against."""
from __future__ import annotations

import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> dict:
    """The table of peaks, with ``int32_ops_per_s`` derived from it: SMs ×
    INT32 lanes an SM × the highest SM clock."""
    with open(_PEAKS) as f:
        p = json.load(f)
    p["int32_ops_per_s"] = (p["sm_count"] * p["int32_lanes_per_sm"]
                            * p["max_sm_mhz"] * 1e6)
    return p
