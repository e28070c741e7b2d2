"""The reader of ``decode_attn_kernel_share``: nothing from a program
without the telemetry registry or without a one-token attention call, and
kernel launches over one-token calls from counters set by hand."""
import sys

import pytest

from simbench.harness import spec

NAMES = ("models.attn.one_token", "kernels.decode_attn")


def reader():
    return spec.load_module(spec.metric_path("decode_attn_kernel_share"),
                            "_reader_decode_attn_kernel_share")


@pytest.mark.parametrize("calls,launches,want", [
    (16 * 1325, 16 * 1325, 1.0), (6 * 1341, 6 * 1341, 1.0),
    (96, 0, 0.0), (96, 48, 0.5), (0, 0, None)])
def test_launches_over_one_token_calls(calls, launches, want):
    from repro_torch import telemetry
    saved = {k: telemetry.counter(k) for k in NAMES}
    telemetry.reset(*NAMES)
    try:
        telemetry.count(NAMES[0], calls)
        telemetry.count(NAMES[1], launches)
        assert reader().read({}) == want
    finally:
        telemetry.reset(*NAMES)
        for k, n in saved.items():
            telemetry.count(k, n)


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    # as on a program before the registry: importing it fails
    import repro_torch
    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    assert reader().read({}) is None


def test_it_is_listed_for_the_two_gqa_decode_cells():
    m = {x["name"]: x for x in spec.load_benchmark()["per_layer"]}
    entry = m["decode_attn_kernel_share"]
    assert (entry["layer"], entry["moves"], entry["source"]) == (
        "models", "decode_tokens_per_s", "program_counter")
    # a later GQA decode cell is appended to the list as data
    assert {"olmoe-1b-7b.decode-host",
            "nemotron-3-nano-30b-a3b.decode-agent-hybrid"} <= set(
        entry["workloads"])
