"""The port's spans and counters (``repro_torch.telemetry``), on the CPU.

Spans record only under a torch profiler, where they sit in its trace
beside the aten calls they enclose; counters are always on.  The layers'
spans nest as the layer map says (a bbop encloses its μProgram fetch, its
metering, the FSM kernel's path and its transposition passes), the row
file's index lists are counted from the trace's own row map, the models'
weight casts from the parameters' sizes, and the decode loop's spans from
its steps.
"""
import dataclasses
import json
import threading

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.ops import SimdramMachine
from repro_torch.ops.bbops import (bbop_abs, bbop_add, bbop_if_else,
                                   bbop_max, simdram_pipeline)
from repro_torch.serve.decode import greedy_decode
from repro_torch.simdram.layout import (TRANSPOSE_STATS,
                                        reset_transpose_stats,
                                        transpose_counts)
from repro_torch.simdram.timing import DRAMTiming

BANKS, LANES = 2, 64
BBOP_SPANS = ("bbop", "memory.fetch", "machine.meter", "kernels.run_trace",
              "kernels.row_file", "kernels.k1", "layout.to_planes",
              "layout.from_planes")


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset()
    yield
    telemetry.reset()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _operands(k: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 200, (BANKS, LANES), generator=g,
                          dtype=torch.int32) for _ in range(k)]


def _machine():
    return SimdramMachine(timing=DRAMTiming(), banks=BANKS, device="cpu")


def test_without_a_profiler_spans_record_nothing_and_counters_count():
    with telemetry.span("outer", {"k": 1}):
        with telemetry.span("inner"):
            telemetry.count("c")
            telemetry.count("c", 4)
    snap = telemetry.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"] == {"c": 5}
    assert telemetry.counter("c") == 5 and telemetry.counter("absent") == 0
    assert telemetry.span_count("outer") == telemetry.span_total_ns("outer") \
        == 0
    telemetry.reset("c")
    assert telemetry.snapshot()["counters"] == {}


def test_a_span_records_only_what_a_profiler_saw_whole():
    early = telemetry.span("early")
    early.__enter__()                    # entered before the profiler ran
    with _profile():
        with telemetry.span("whole"):
            pass
        late = telemetry.span("late")
        late.__enter__()                 # its profiler stops before it exits
    early.__exit__(None, None, None)
    late.__exit__(None, None, None)
    assert set(telemetry.snapshot()["spans"]) == {"whole"}


def test_a_spans_args_show_with_its_event(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        with telemetry.span("with_args", {"op": "addition", "n_bits": 32,
                                          "other": (1, 2)}):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("name") == "with_args"]
    assert {k: ev["args"][k] for k in ("op", "n_bits", "other")} == \
        {"op": "addition", "n_bits": 32, "other": "(1, 2)"}


def test_a_bbop_nests_its_layers_spans_on_the_profilers_clock():
    m = _machine()
    a, b = _operands(2)
    with m.timed():
        with m.session():
            bbop_add(a, b, 8)            # compiles outside the profile
        telemetry.reset()
        with _profile() as prof:
            with m.session():
                bbop_add(a, b, 8)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    spans = {}
    for e in events:
        if e.name() in BBOP_SPANS:
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    snap = telemetry.snapshot()["spans"]
    assert set(spans) == set(BBOP_SPANS) == set(snap)
    for name, got in spans.items():
        assert snap[name]["n"] == len(got), name
        assert 0 <= snap[name]["self_ns"] <= snap[name]["total_ns"], name
    assert len(spans["bbop"]) == 1 and len(spans["layout.to_planes"]) == 2
    assert len(spans["layout.from_planes"]) == 1

    def inside(child, parent):
        (cs, ce), (ps, pe) = child, parent
        return ps <= cs and ce <= pe

    (bbop,) = spans["bbop"]
    (run_trace,) = spans["kernels.run_trace"]
    for name in BBOP_SPANS[1:]:
        for iv in spans[name]:
            assert inside(iv, bbop), name
    for name in ("kernels.row_file", "kernels.k1"):
        assert inside(spans[name][0], run_trace), name
    # the aten calls under the FSM kernel's span share the clock with it
    k1 = spans["kernels.k1"][0]
    aten = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name().startswith("aten::") and k1[0] <= e.start_ns() < k1[1]]
    assert aten and all(inside(iv, k1) for iv in aten)
    # a span's self time leaves out its recorded children's
    kids = sum(snap[n]["total_ns"] for n in ("kernels.row_file", "kernels.k1"))
    assert snap["kernels.run_trace"]["self_ns"] == \
        snap["kernels.run_trace"]["total_ns"] - kids
    assert telemetry.counter("ops.bbops") == 1


@pytest.mark.parametrize("case", ["unary", "binary", "three_operands"])
def test_index_lists_follow_the_traces_row_map(case):
    m = _machine()
    with m.session():
        if case == "unary":
            (a,) = _operands(1)
            call, op, names = (lambda: bbop_abs(a, 8)), "abs", ("a",)
        elif case == "binary":
            a, b = _operands(2)
            call, op, names = (lambda: bbop_add(a, b, 8)), "addition", \
                ("a", "b")
        else:
            a, b = _operands(2)
            sel = torch.randint(0, 2, (BANKS, LANES), dtype=torch.int32)
            call, op, names = (lambda: bbop_if_else(sel, a, b, 8)), \
                "if_else", ("a", "b", "sel")
        trace = m.memory.get(op, 8)[1]
        telemetry.reset()
        call()
    # one list of rows and one of bits for each operand with rows, one
    # list of rows for each output
    want = sum(2 for n in names if any(k[0] == n for k in trace.row_index
                                       if isinstance(k, tuple)))
    want += len(trace.outputs)
    assert want == {"unary": 3, "binary": 5, "three_operands": 7}[case]
    assert telemetry.counter("kernels.index_lists") == want
    assert telemetry.counter("ops.bbops") == 1


def _tiny_moe(compute_dtype: str):
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"),
                              compute_dtype=compute_dtype)
    model = Transformer(cfg, device="cpu")
    model.draw_params(torch.Generator().manual_seed(0))
    return cfg, model


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_weight_casts_count_their_bytes(compute_dtype):
    cfg, model = _tiny_moe(compute_dtype)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model({"tokens": tokens})
    # every float32 parameter is cast at its use but the embedding table
    # (its gathered rows are cast) and the routers (kept float32): 4 bytes
    # read and 2 written an element
    cast = sum(p.numel() for n, p in model.named_parameters()
               if n != "embed" and not n.endswith(".router"))
    want = 6 * cast if compute_dtype == "bfloat16" else 0
    assert telemetry.counter("models.weight_cast_bytes") == want
    assert telemetry.counter("models.forwards") == 1


def test_greedy_decode_spans_its_prefill_steps_and_picks():
    cfg, model = _tiny_moe("bfloat16")
    prompt = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(2))
    steps = 4
    with _profile() as prof:
        out = greedy_decode(model, cfg, prompt, steps=steps)
    assert out.shape == (2, steps)
    snap = telemetry.snapshot()["spans"]
    assert snap["decode.step"]["n"] == steps - 1
    assert snap["decode.pick"]["n"] == steps
    assert snap["models.forward"]["n"] == steps
    assert snap["models.attn"]["n"] == snap["models.ffn"]["n"] \
        == steps * cfg.n_layers
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("decode.step") == steps - 1
    assert names.count("models.ffn") == steps * cfg.n_layers
    assert telemetry.counter("models.forwards") == steps
    # the prefill's forward and first pick lie outside every step
    iv = {}
    for e in prof.profiler.kineto_results.events():
        iv.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    first_step = min(iv["decode.step"])[0]
    assert min(iv["models.forward"])[1] <= first_step
    assert min(iv["decode.pick"])[1] <= first_step


def test_without_a_profiler_a_span_is_one_shared_object():
    assert telemetry.span("a") is telemetry.span("b", {"k": 1})
    with _profile():
        assert telemetry.span("a") is not telemetry.span("a")


def test_spans_record_through_the_plain_record_function_where_torch_lacks_the_fast_one(
        monkeypatch):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    with _profile() as prof:
        with telemetry.span("plain", {"op": "addition"}):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("plain") == 1
    assert telemetry.span_count("plain") == 1


def test_a_signed_maximum_is_two_bbops_side_by_side():
    m = _machine()
    a, b = _operands(2)
    with m.session():
        bbop_max(a - 100, b - 100, 8, signed=True)   # compiles unprofiled
        telemetry.reset()
        with _profile() as prof:
            bbop_max(a - 100, b - 100, 8, signed=True)
    bbops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "bbop")
    assert len(bbops) == 2 and bbops[0][1] <= bbops[1][0]
    assert telemetry.counter("ops.bbops") == 2
    assert telemetry.counter("kernels.index_lists") == 5 + 7


def test_a_recorded_op_counts_as_no_bbop():
    vals = torch.arange(64, dtype=torch.int32)
    with simdram_pipeline(machine=_machine(), fused_trace=True) as p:
        a, b = p.load([vals, vals + 1], n_bits=8)
        s = bbop_add(a, b, 8)
        assert telemetry.counter("ops.bbops") == 0
        p.store(s)
    assert telemetry.counter("ops.bbops") == 0
    assert telemetry.counter("kernels.index_lists") > 0


def test_counts_of_ended_threads_fold_and_reset():
    worker = threading.Thread(target=telemetry.count, args=("folded", 3))
    worker.start()
    worker.join()
    later = threading.Thread(target=telemetry.count, args=("folded", 4))
    later.start()
    later.join()
    telemetry.count("folded")
    assert telemetry.counter("folded") == 8
    assert telemetry.snapshot()["counters"]["folded"] == 8
    telemetry.reset("folded")
    assert telemetry.counter("folded") == 0


def test_counts_from_threads_are_never_lost():
    def work():
        for _ in range(10_000):
            telemetry.count("threads")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert telemetry.counter("threads") == 40_000


def test_transposition_passes_read_the_registry():
    vals = torch.arange(64, dtype=torch.int32)
    reset_transpose_stats()
    with simdram_pipeline(machine=_machine()) as p:
        a, b = p.load([vals, vals + 1], n_bits=8)
        p.store(bbop_add(a, b, 8))
    assert transpose_counts() == (1, 1)
    assert dict(TRANSPOSE_STATS) == {"to_bitplanes": 1, "from_bitplanes": 1}
    assert (telemetry.counter("layout.to_planes"),
            telemetry.counter("layout.from_planes")) == (1, 1)
    reset_transpose_stats()
    assert transpose_counts() == (0, 0)
