"""Measure a cell's spread: sets of runs, each run its own process, as the
benchmark's check makes them.

    python3 simbench/tools/sets.py --workload <name> --seconds 30 \
        --seeds 1 2 3 4 5 6 --sets 2 [--trace-seeds 7 8 9] [--more-seeds 10 11] \
        --out chiprun_out/sets.json

Every set runs the same seeds in turn.  For each end-to-end metric it
prints each set's median and spread (quartile distance over the median,
by ``statistics.quantiles``), the spread with each set's run farthest
from the median left out, and five times the widest spread (never under
0.01), the bound that spread supports.  ``setup_s`` of the first run,
which builds the kernels, is reported apart and left out of its medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from simbench.harness.stats import spread, trimmed_spread  # noqa: E402


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(ROOT / "simbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall,
            "result": result, "stderr_tail": p.stderr[-2000:]}


def summary(sets: list[list[dict]]) -> dict:
    out = {}
    names = set()
    for runs in sets:
        for r in runs:
            if r["result"]:
                names |= set(r["result"]["metrics"])
    for name in sorted(names):
        per_set = []
        for k, runs in enumerate(sets):
            vals = [r["result"]["metrics"][name]["value"] for i, r in
                    enumerate(runs) if r["result"]
                    and name in r["result"]["metrics"]
                    and not (name == "setup_s" and k == 0 and i == 0)]
            if len(vals) >= 2:
                per_set.append({"values": vals,
                                "median": statistics.median(vals),
                                "spread": spread(vals),
                                "trimmed": trimmed_spread(vals)
                                if len(vals) >= 3 else None})
        if per_set:
            widest = max(s["spread"] for s in per_set)
            out[name] = {"sets": per_set, "widest_spread": widest,
                         "bound_5x": max(0.01, 5 * widest)}
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    p.add_argument("--more-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sets = []
    for _ in range(args.sets):
        sets.append([one_run(args.workload, s, args.seconds, 0)
                     for s in args.seeds])
    traced = [one_run(args.workload, s, args.seconds, 1)
              for s in args.trace_seeds]
    more = [one_run(args.workload, s, args.seconds, 0)
            for s in args.more_seeds]
    report = {"workload": args.workload, "seconds": args.seconds,
              "sets": sets, "traced": traced, "more": more,
              "summary": summary(sets)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    for run in [r for s in sets for r in s] + traced + more:
        res = run["result"] or {}
        print(f"seed {run['seed']} trace {run['trace']} rc {run['rc']} "
              f"wall {run['wall_s']:.1f} s correct {res.get('correct')} "
              f"checks {json.dumps(res.get('checks'))} "
              f"metrics {json.dumps({k: v['value'] for k, v in res.get('metrics', {}).items()})}")
        if run["rc"] or not res.get("correct"):
            print(run["stderr_tail"][-1500:])
    for name, s in report["summary"].items():
        print(f"{name}: " + "; ".join(
            f"median {x['median']:.6g} spread {x['spread']:.4f} trimmed "
            f"{x['trimmed'] if x['trimmed'] is None else round(x['trimmed'], 4)}"
            for x in s["sets"]) + f"; 5x widest {s['bound_5x']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
