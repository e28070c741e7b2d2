"""One run of one cell: the command line, the run and its result line.

``run_cell`` drives the cell's traffic through its driver and assembles
the result; ``main`` adds what only a measured run has: the refusal
without a CUDA device, the import guard once the window has closed, and
the printing (the compared numbers as the last lines of standard error,
the result as the last line of standard output, its ``checks`` last).
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time

from simbench.harness import guard, spec


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="simbench/run.py",
        description="Measure one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, config: dict | None = None,
             traffic: dict | None = None, control: bool = False) -> dict:
    """Run ``workload`` once on ``device`` (``config``/``traffic`` replace
    the cell's files, for tests at small sizes).  ``t0`` is the process's
    start on the host clock.  ``control`` puts the cell's control (its
    reference at the next lower precision) in the program's place; the
    benchmark's runs never do."""
    import torch
    entry, cfg_file, traffic_file = spec.find_cell(bench, workload)
    config = config or cfg_file
    traffic = traffic or traffic_file
    driver = spec.load_module(spec.driver_path(traffic["kind"]),
                              f"simbench_driver_{traffic['kind']}")
    window = {}

    def mark_window():
        window["start"] = time.perf_counter()

    res = driver.run(config, traffic, seed, seconds, trace, device,
                     mark_window, control=control)
    setup_s = window["start"] - t0
    metrics = {}
    if not trace:
        for m in spec.end_to_end_metrics(bench, workload):
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = res["ctx"]
        for m in spec.per_layer_metrics(bench, workload):
            reader = spec.load_module(spec.metric_path(m["name"]),
                                      "simbench_metric_" + m["name"])
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(0) if cuda
                    else platform.processor() or "cpu"),
           "count": entry["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    tr = res["ctx"].get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {k: [list(x) for x in v]
                            for k, v in tr["breakdown"].items()}
    out["notes"] = res.get("notes", {})
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["checks"].items()}
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    entry = spec.find_cell(bench, args.workload)[0]
    import torch
    if not torch.cuda.is_available():
        print("simbench: no CUDA device (torch.cuda.is_available() is "
              "False); a run measures the card and never the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"simbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"simbench: the run loaded modules of the JAX side: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
