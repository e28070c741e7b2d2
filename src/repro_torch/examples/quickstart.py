"""Quickstart: the SIMDRAM framework end to end on the port.

1. Steps 1-2: compile an operation (AOIG → MIG → μProgram) and inspect it.
2. Step 3: execute it on the faithful subarray model.
3. The paper's Listing 1: predicated vector add/sub via bbops.
4. ``SimdramMachine``: the session-scoped end-to-end API — one object owning
   DRAM timing, banks, backend, its own μProgram Memory and PerfStats.
5. **User-defined operations**: register an arbitrary AOIG with
   ``machine.define_op`` and execute it on every registered backend
   (``reference``, ``unrolled``, ``kernel``), with replay timing.
6. Plane-resident pipelines + timed execution on the machine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise; on a CUDA device the
``kernel`` backend runs the FSM kernel and every load and store the
transposition kernels.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core.circuits import PAPER_COUNTS, compile_operation
from repro_torch.core.executor import from_planes, run_program
from repro_torch.core.graph import lit_not
from repro_torch.core.uprogram import DRow
from repro_torch.device import resolve_device
from repro_torch.ops import (SimdramMachine, bbop_add, bbop_greater,
                             bbop_if_else, bbop_mul, bbop_relu, bbop_sub)
from repro_torch.simdram.layout import reset_transpose_stats, transpose_counts
from repro_torch.simdram.timing import DRAMTiming, SimdramPerfModel


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description="compile, execute and time SIMDRAM operations")
    ap.add_argument("--device", default="cuda",
                    help="where the machines run (default: %(default)s)")
    device = resolve_device(ap.parse_args(argv).device)

    def on_device(values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int32, device=device)

    # --- compile full addition for 8-bit elements ---------------------------
    prog = compile_operation("addition", 8)
    print(prog.pretty())
    print(f"\ncommand sequences: {prog.command_count()} "
          f"(paper Table 5: {PAPER_COUNTS['addition'](8)})")
    m = SimdramPerfModel()
    print(f"modeled throughput @16 banks: "
          f"{m.throughput_gops(prog, 16):.1f} GOps/s\n")

    # --- run on the faithful DRAM subarray model ----------------------------
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 256, 8), rng.integers(0, 256, 8)
    outs, sa = run_program(prog, {"a": a, "b": b})
    print("subarray executor:", from_planes(outs["out"], 8),
          "(expected", (a + b) % 256, ")")
    print("DRAM command stats:", sa.stats, "\n")

    # --- paper Listing 1: predicated execution via the bbop ISA -------------
    A = on_device(rng.integers(0, 128, 16))
    B = on_device(rng.integers(0, 128, 16))
    pred = on_device(rng.integers(0, 128, 16))
    with SimdramMachine(device=device).session():
        D = bbop_add(A, B, 8)
        E = bbop_sub(A, B, 8)
        F = bbop_greater(A, pred, 8)
        C = bbop_if_else(F, D, E, 8)
    exp = np.where(host(A) > host(pred), (host(A) + host(B)) & 255,
                   (host(A) - host(B)) & 255)
    assert np.array_equal(host(C), exp)
    print("Listing-1 predicated add/sub: OK ->", host(C)[:8], "...")

    # --- SimdramMachine: the whole configuration in one session object ------
    machine = SimdramMachine(timing=DRAMTiming(), banks=16,
                             backend="unrolled", cache_capacity=32,
                             device=device)
    x = on_device(rng.integers(0, 256, 64))
    y = on_device(rng.integers(0, 256, 64))
    out = machine.op("addition")(x, y, n_bits=8)
    assert np.array_equal(host(out), (host(x) + host(y)) & 255)
    print(f"\n{machine}")
    print("machine.op('addition'): OK   μProgram Memory:",
          machine.cache_stats())

    # --- user-defined operation: the paper's Steps 1-3 as API ---------------
    # Step 1 — describe the 1-bit slice as an AOIG: out = a - b·gate
    # (a borrow-chained subtract whose subtrahend is predicated per lane)
    def build_gated_sub(g):
        av, bv, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
        bg = g.gate_and(bv, gate)
        axb = g.gate_xor(av, bg)
        g.add_output("out", g.gate_xor(axb, w))
        g.add_output("borrow", g.gate_or_node(
            g.gate_and(lit_not(av), bg), g.gate_and(w, lit_not(axb))))

    # Steps 1-2 — synthesize to an optimized MIG, allocate B-group rows,
    # generate + lower the μProgram (cached in the machine's memory)
    gated_sub = machine.define_op(
        "gated_sub", build_gated_sub,
        invariants={"gate": DRow("gate", 0, fixed=True)},
        states={"borrow": 0})
    gprog, gtrace = gated_sub.program(n_bits=8)
    print(f"\nuser-defined gated_sub: {gprog.command_count()} command "
          f"sequences at 8 bits, {gtrace.n_commands} in the lowered trace")

    # Step 3 — execute on every registered backend, no other changes
    gmask = on_device(rng.integers(0, 2, 64))
    expect = np.where(host(gmask), (host(x) - host(y)) & 255, host(x))
    for be in ("reference", "unrolled", "kernel"):
        got = gated_sub(x, y, gmask, n_bits=8, backend=be)
        assert np.array_equal(host(got), expect), be
    print("gated_sub on reference/unrolled/kernel: OK ->", expect[:8], "...")

    # ... and with cycle-accurate replay timing, also for free
    with machine.timed(mode="replay") as st:
        gated_sub(x, y, gmask, n_bits=8)
    print(f"gated_sub replay timing: {st.replay_ns:.0f} ns replayed >= "
          f"{st.exec_ns:.0f} ns analytic")

    # --- plane-resident pipeline on the machine (one transpose pair) --------
    av = on_device(rng.integers(0, 256, (16, 64)))
    bv = on_device(rng.integers(0, 256, (16, 64)))
    cv = on_device(rng.integers(0, 256, (16, 64)))
    reset_transpose_stats()
    with machine.pipeline(timed=True) as p:
        pa, pb, pc = p.load([av, bv, cv], 8)
        res = p.store(bbop_relu(bbop_add(bbop_mul(pa, pb, 8), pc, 8), 8))
    raw = (host(av) * host(bv) + host(cv)) & 255
    assert np.array_equal(host(res), np.where(raw >> 7, 0, raw))
    assert transpose_counts() == (1, 1)     # one fused pass each way
    print(f"\nfused 16-bank relu(add(mul(a,b),c)): transposition-unit "
          f"passes (to, from) = {transpose_counts()} ->",
          host(res)[0, :8], "...")
    print("\ntimed chain on the machine's own accumulator "
          "(μProgram AAP/AP latencies + movement + transposition):")
    print(machine.perf_report())

    # --- machines are isolated: a second session, different substrate -------
    other = SimdramMachine(timing=DRAMTiming(tRAS_ns=64.0),
                           backend="reference", device=device)
    other.op("addition")(x, y, n_bits=8)
    print(f"\nsecond machine (slow tRAS, reference backend) kept its own "
          f"cache {other.cache_stats()['entries']} entries; first machine "
          f"unchanged: {machine.cache_stats()['entries']} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
