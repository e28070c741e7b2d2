"""The reader of ``graph_replay_share``: nothing from a program without
the telemetry registry or without a replay, and replays over forwards
from counters set by hand."""
import sys

import pytest

from simbench.harness import spec


def reader():
    return spec.load_module(spec.metric_path("graph_replay_share"),
                            "_reader_graph_replay_share")


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    assert reader().read({}) is None


@pytest.mark.parametrize("forwards,replays,want", [
    (675, 667, 667 / 675), (1341, 1325, 1325 / 1341), (4, 0, None),
    (0, 0, None)])
def test_replays_over_forwards(forwards, replays, want):
    from repro_torch import telemetry
    names = ("models.forwards", "models.graph.replays")
    saved = {k: telemetry.counter(k) for k in names}
    telemetry.reset(*names)
    try:
        telemetry.count("models.forwards", forwards)
        telemetry.count("models.graph.replays", replays)
        assert reader().read({}) == want
    finally:
        telemetry.reset(*names)
        for k, n in saved.items():
            telemetry.count(k, n)


def test_it_is_listed_for_both_decode_cells():
    m = {x["name"]: x for x in spec.load_benchmark()["per_layer"]}
    entry = m["graph_replay_share"]
    assert (entry["layer"], entry["moves"]) == ("models",
                                               "decode_tokens_per_s")
    assert entry["workloads"] == ["olmoe-1b-7b.decode-host",
                                  "deepseek-v2-lite.decode-agent"]
