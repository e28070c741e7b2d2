"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is ``simbench/configs/<config>.json``, the traffic mix
``simbench/traffic/<traffic>.json``, the traffic's driver
``simbench/drivers/<kind>.py`` and each per-layer metric's reader
``simbench/metrics/<metric name>.py``.  Nothing here knows a cell by name.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config_path(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def driver_path(kind: str) -> Path:
    return BENCH_DIR / "drivers" / f"{kind}.py"


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name`` (file names may
    hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return (w, load_json(config_path(w["config"])),
                    load_json(traffic_path(w["traffic"])))
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end_metrics(bench: dict, workload: str) -> list[dict]:
    """The end-to-end metrics ``workload`` reports."""
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer_metrics(bench: dict, workload: str) -> list[dict]:
    """The per-layer metrics ``workload`` reports: those that list it, and
    those without a list whose moved metric it reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
