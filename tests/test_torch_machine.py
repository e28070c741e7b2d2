"""The whole slice: the quickstart flow (``examples/quickstart.py``) on the
port's ``SimdramMachine(device="cpu")`` and on ``repro``'s machine, step
for step.

Values, transposition-unit pass counts, μProgram Memory counters, replay
timing, ``perf_report()``/``snapshot()``, the ``ScheduleResult`` of a
two-tenant ``submit``/``drain`` (batched and unbatched) and the per-tenant
meters must all be equal.  The reference runs its ``unrolled`` backend (as
the quickstart does), the port its default ``kernel`` backend.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as ref_graph
import repro.core.uprogram as ref_uprogram
import repro.ops as ref_ops
import repro.simdram.layout as ref_layout
import repro.simdram.timing as ref_timing
import repro_torch.core.graph as port_graph
import repro_torch.core.uprogram as port_uprogram
import repro_torch.ops as port_ops
import repro_torch.simdram.layout as port_layout
import repro_torch.simdram.timing as port_timing

PKGS = {
    "ref": types.SimpleNamespace(
        ops=ref_ops, layout=ref_layout, timing=ref_timing, graph=ref_graph,
        uprogram=ref_uprogram, arr=lambda x: jnp.asarray(x, jnp.int32),
        machine_kw={"backend": "unrolled"},
        backends=("reference", "unrolled", "pallas")),
    "port": types.SimpleNamespace(
        ops=port_ops, layout=port_layout, timing=port_timing, graph=port_graph,
        uprogram=port_uprogram, arr=lambda x: torch.as_tensor(x, dtype=torch.int32),
        machine_kw={"device": "cpu"},
        backends=("reference", "kernel", "unrolled")),
}


def _host(x) -> list:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) \
        .astype(np.int64).tolist()


def quickstart(pkg: str, batch: bool) -> dict:
    """Run the quickstart flow on one package; returns everything it
    observed, as plain Python/numpy values."""
    P = PKGS[pkg]
    ops, layout = P.ops, P.layout
    rng = np.random.default_rng(0)
    seen: dict = {}
    machine = ops.SimdramMachine(timing=P.timing.DRAMTiming(), banks=16,
                                 cache_capacity=32, **P.machine_kw)

    # paper Listing 1: predicated add/sub through the bbop ISA
    a, b, pred = (P.arr(rng.integers(0, 128, 16)) for _ in range(3))
    layout.reset_transpose_stats()
    with machine.session():
        d = ops.bbop_add(a, b, 8)
        e = ops.bbop_sub(a, b, 8)
        f = ops.bbop_greater(a, pred, 8)
        seen["listing1"] = _host(ops.bbop_if_else(f, d, e, 8))
    an, bn, pn = (np.asarray(_host(v)) for v in (a, b, pred))
    assert seen["listing1"] == np.where(an > pn, (an + bn) & 255,
                                        (an - bn) & 255).tolist()
    seen["listing1_passes"] = layout.transpose_counts()

    # a bound op
    x = P.arr(rng.integers(0, 256, 64))
    y = P.arr(rng.integers(0, 256, 64))
    seen["addition"] = _host(machine.op("addition")(x, y, n_bits=8))
    xn, yn = np.asarray(_host(x)), np.asarray(_host(y))
    assert seen["addition"] == ((xn + yn) & 255).tolist()
    seen["cache_after_op"] = machine.cache_stats()

    # a user-defined operation, on every backend and under replay timing
    def build_gated_sub(g):
        av, bv, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
        bg = g.gate_and(bv, gate)
        axb = g.gate_xor(av, bg)
        g.add_output("out", g.gate_xor(axb, w))
        g.add_output("borrow", g.gate_or_node(
            g.gate_and(P.graph.lit_not(av), bg),
            g.gate_and(w, P.graph.lit_not(axb))))

    gated_sub = machine.define_op(
        "gated_sub", build_gated_sub,
        invariants={"gate": P.uprogram.DRow("gate", 0, fixed=True)},
        states={"borrow": 0})
    gprog, gtrace = gated_sub.program(n_bits=8)
    seen["gated_sub_program"] = (gprog.command_count(), gtrace.n_commands,
                                 gtrace.fingerprint)
    gmask = P.arr(rng.integers(0, 2, 64))
    seen["gated_sub"] = {be: _host(gated_sub(x, y, gmask, n_bits=8, backend=be))
                         for be in P.backends}
    assert seen["gated_sub"]["reference"] == np.where(
        np.asarray(_host(gmask)), (xn - yn) & 255, xn).tolist()
    with machine.timed(mode="replay") as st:
        gated_sub(x, y, gmask, n_bits=8)
    seen["gated_sub_replay"] = (st.replay_ns, st.exec_ns, st.snapshot())

    # plane-resident 16-bank pipeline, unfused and fused
    av, bv, cv = (P.arr(rng.integers(0, 256, (16, 64))) for _ in range(3))
    for fused in (False, True):
        layout.reset_transpose_stats()
        with machine.pipeline(timed=True, fused_trace=fused) as p:
            pa, pb, pc = p.load([av, bv, cv], 8)
            res = p.store(ops.bbop_relu(ops.bbop_add(ops.bbop_mul(pa, pb, 8),
                                                     pc, 8), 8))
        seen[f"pipeline_fused={fused}"] = (_host(res),
                                           layout.transpose_counts())
        raw = (np.asarray(_host(av)) * np.asarray(_host(bv))
               + np.asarray(_host(cv))) & 255
        assert seen[f"pipeline_fused={fused}"][0] == \
            np.where(raw >> 7, 0, raw).tolist()
    seen["report"] = machine.perf_report()
    seen["snapshot"] = machine.stats.snapshot()

    # two tenants through submit / drain
    sched = ops.SimdramMachine(banks=16, mode="replay", **P.machine_kw)
    futs = []
    for i in range(5):
        p, q = (P.arr(rng.integers(0, 256, 96)) for _ in range(2))
        futs.append(sched.submit("addition", p, q, tenant="A"))
        futs.append(sched.submit("multiplication", p, q, tenant="B",
                                 priority=i % 2))
    futs.append(sched.submit("relu", P.arr(rng.integers(0, 256, 96)),
                             tenant="A"))
    result = sched.drain(batch=batch)
    seen["futures"] = [(f.name, f.tenant, _host(f.result()),
                        dataclasses.asdict(f.timing)) for f in futs]
    seen["schedule"] = dataclasses.asdict(result)
    seen["per_tenant"] = result.per_tenant()
    seen["tenant_snapshots"] = {t: s.snapshot()
                                for t, s in sched.stats.tenants.items()}
    seen["sched_snapshot"] = sched.stats.snapshot()
    return seen


@pytest.mark.parametrize("batch", [False, True])
def test_quickstart_flow_matches_reference(batch):
    ref = quickstart("ref", batch)
    port = quickstart("port", batch)
    assert set(port) == set(ref)
    ref_gated, port_gated = ref.pop("gated_sub"), port.pop("gated_sub")
    for be, got in [*ref_gated.items(), *port_gated.items()]:
        assert got == ref_gated["reference"], be
    for key in ref:
        assert port[key] == ref[key], key
    assert port["pipeline_fused=False"][1] == (1, 1)
    assert port["snapshot"]["movement"]["per_kind"]["elided"]["n"] == 2
    assert port["schedule"]["n_requests"] == (3 if batch else 11)


def test_cuda_machine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ops.SimdramMachine()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ops.SimdramMachine(device="cuda:0")
    assert port_ops.SimdramMachine(device="cpu").device == torch.device("cpu")


# -- 32-bit signed compares (ROADMAP C.1) ------------------------------------

SIGNED_OPS = {"greater": np.greater, "greater_equal": np.greater_equal,
              "max": np.maximum, "min": np.minimum}


def signed_extremes() -> tuple:
    """Seeded int32 operands with the ±2³¹ extremes paired every way."""
    lo, hi = -2**31, 2**31 - 1
    rng = np.random.default_rng(31)
    a = rng.integers(lo, hi + 1, 200, dtype=np.int64)
    b = rng.integers(lo, hi + 1, 200, dtype=np.int64)
    a[:9] = [lo, lo, lo, hi, hi, hi, 0, -1, lo + 1]
    b[:9] = [lo, hi, 0, lo, hi, -1, lo, hi, lo]
    return a, b


@pytest.mark.parametrize("op", sorted(SIGNED_OPS))
def test_signed_32bit_compares_match_numpy(op):
    """``bbop_<op>(signed=True, n_bits=32)`` on the port's int32 tensors
    equals numpy, extremes included.  The reference cannot be the oracle
    here: on its int32 arrays, ``repro.ops.bbops._flip_msb`` computes
    ``x ^ (1 << 31)``, which does not fit and raises ``OverflowError``.
    On int64 operands both packages compute, and agree."""
    a, b = signed_extremes()
    want = SIGNED_OPS[op](a, b).astype(np.int64)
    fn = getattr(port_ops, f"bbop_{op}")
    with port_ops.SimdramMachine(device="cpu").session():
        got = fn(torch.from_numpy(a.astype(np.int32)),
                 torch.from_numpy(b.astype(np.int32)), 32, signed=True)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
        wide = fn(a, b, 32, signed=True)
    np.testing.assert_array_equal(wide.numpy().astype(np.int64), want)
    ref_fn = getattr(ref_ops, f"bbop_{op}")
    with pytest.raises(OverflowError):
        ref_fn(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), 32,
               signed=True)
    np.testing.assert_array_equal(
        np.asarray(ref_fn(a, b, 32, signed=True)).astype(np.int64), want)
