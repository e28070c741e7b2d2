"""The readings each check's limit is set from: runs of a cell through the
harness's own ``run_cell``, one seed after another in one process, each
printing its ``correct`` and every compared number (not run by the
benchmark's runs).

    python3 simbench/tools/readings.py --workload <name> --seeds 1 2 3 \
        [--control | --fault one_token] [--seconds 1] [--out <file>]

``--control`` puts the cell's control in the program's place (the
reference at the next lower precision); ``--fault one_token`` plants one
altered token in the port (``simbench/harness/faults.py``).  Without
either, the readings are the sound program's.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from simbench.harness import faults, spec  # noqa: E402
from simbench.harness.main import run_cell  # noqa: E402


def _planted(fault: str | None, traffic: dict):
    if fault is None:
        return contextlib.nullcontext()
    if fault == "one_token":
        return faults.one_token(max(n for _, n in traffic["requests"]))
    raise ValueError(f"unknown fault {fault!r}")


def readings(workload: str, seeds_, device: str, seconds: float,
             control: bool = False, fault: str | None = None,
             config: dict | None = None, traffic: dict | None = None,
             verbose: bool = False) -> list[dict]:
    """One row a seed: its ``correct``, checks and notes."""
    import torch
    bench = spec.load_benchmark()
    _, cfg_file, traffic_file = spec.find_cell(bench, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    rows = []
    for seed in seeds_:
        t = time.perf_counter()
        with _planted(fault, traffic):
            r = run_cell(bench, workload, seed, seconds, False, device, t,
                         config, traffic, control=control)
        row = {"seed": seed, "control": control, "fault": fault,
               "correct": r["correct"], "checks": r["checks"],
               "notes": r["notes"], "seconds": time.perf_counter() - t}
        if verbose:
            print(json.dumps(row), flush=True)
        rows.append(row)
        del r
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    how = p.add_mutually_exclusive_group()
    how.add_argument("--control", action="store_true")
    how.add_argument("--fault", choices=["one_token"])
    p.add_argument("--out")
    args = p.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.device, args.seconds,
                    args.control, args.fault, verbose=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
