"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import json
import re
from pathlib import Path

import pytest

from simbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {w["name"] for w in BENCH["workloads"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    need, may = KEYS[section]
    for entry in BENCH[section]:
        assert need <= set(entry) <= need | may, entry["name"]


def test_names_units_and_lines():
    names = []
    for section in KEYS:
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in paths)
                         for f in files)
    for p in paths:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert PATH.match(rel), rel


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_configs_are_used_and_their_files_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert Path(ROOT / c["file"]) == spec.config_path(c["name"])
        data = spec.load_json(ROOT / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_workloads_find_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, config, traffic = spec.find_cell(BENCH, w["name"])
        assert spec.driver_path(traffic["kind"]).is_file()
        assert (ROOT / "simbench" / "reference"
                / f"{config['reference']}.py").is_file()
        if "n_bits" in traffic:
            assert (ROOT / "simbench" / "reference" / "dram_cost"
                    / f"{config['name']}-{traffic['n_bits']}b.json").is_file()
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.end_to_end_metrics(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert spec.per_layer_metrics(BENCH, cell), cell


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert spec.metric_path(m["name"]).is_file(), m["name"]
        cells = m.get("workloads", sorted(CELLS))
        assert set(cells) <= CELLS
        for cell in cells:
            reported = {x["name"] for x in spec.end_to_end_metrics(BENCH, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= CELLS


def test_shares_of_a_peak_are_named_for_it():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
