"""The readers of the program's spans and counters: a traced run of each
cell, at the small sizes the control tests use, on the CPU, reports every
one of them, and the count of index lists a bbop follows from the ops."""
import sys
import time

import pytest
from test_simbench_control import BBOP_CELL, LM_CELL, SMALL_LM

from simbench.harness import spec
from simbench.harness.main import run_cell

BBOP_METRICS = ("bbop_host_us", "meter_host_us", "k1_host_us",
                "layout_host_us", "index_lists_per_bbop", "memory_compile_s")
LM_METRICS = ("step_host_ms", "moe_host_ms", "weight_cast_gb")
# the traced request decodes trace_steps + 3 tokens into a cache sized for
# its own new tokens, so each request here has at least 5 (the cell's
# fewest is 38)
LM_REQUESTS = [[16, 6], [32, 5], [48, 8]]


def _traced(workload: str, **small) -> dict:
    from repro_torch import telemetry
    telemetry.reset()
    bench = spec.load_benchmark()
    config, traffic = spec.find_cell(bench, workload)[1:]
    return run_cell(bench, workload, 2 ** 31 + 17, small.pop("seconds"),
                    True, "cpu", time.perf_counter(),
                    config=dict(config, **small.pop("config")),
                    traffic=dict(traffic, **small.pop("traffic")))


@pytest.mark.parametrize("workload,metrics,small", [
    (BBOP_CELL, BBOP_METRICS,
     {"seconds": 0.2, "config": {"banks": 2, "lanes": 256}, "traffic": {}}),
    (LM_CELL, LM_METRICS,
     {"seconds": 0.1, "config": SMALL_LM,
      "traffic": {"requests": LM_REQUESTS, "trace_steps": 2}}),
], ids=["bbop", "lm"])
def test_a_traced_run_reports_every_telemetry_metric(workload, metrics,
                                                     small):
    out = _traced(workload, **small)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in spec.per_layer_metrics(
        spec.load_benchmark(), workload)}
    for name in metrics:
        assert name in listed, name
        assert out["metrics"][name]["value"] > 0, (name, out["metrics"])


def test_index_lists_a_bbop_follow_from_its_operands():
    out = _traced(BBOP_CELL, seconds=0.2, config={"banks": 2, "lanes": 256},
                  traffic={})
    ops = spec.find_cell(spec.load_benchmark(), BBOP_CELL)[2]["ops"]
    # a list of rows and one of bits for each operand, one of rows for
    # the output: 82 a round of the 16 ops
    want = sum(2 * len(roles) + 1 for _, roles in ops) / len(ops)
    assert want == 82 / 16
    assert out["metrics"]["index_lists_per_bbop"]["value"] == want


TELEMETRY_METRICS = BBOP_METRICS + LM_METRICS


@pytest.mark.parametrize("name", TELEMETRY_METRICS)
def test_a_program_without_the_registry_gives_nothing(name, monkeypatch):
    # as on a program before the registry: importing it fails
    import repro_torch
    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    reader = spec.load_module(spec.metric_path(name), f"_reader_{name}")
    assert reader.read({}) is None
