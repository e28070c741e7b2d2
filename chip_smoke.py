#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SIMDRAM (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi``) and build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (timed);
2. the transposition kernels against their plain PyTorch versions, both
   directions, n_bits 1/8/16/32, signed and unsigned, at 16 × 65,536 lanes;
3. the FSM kernel against its plain version on banked 16 × 2,048-word row
   files: all 16 builtins at 8 bits, addition/multiplication/division at 32
   bits and one fused chain trace;
4. the main path on ``SimdramMachine(device="cuda", banks=16,
   mode="replay")`` at 16 × 65,536 lanes — the quickstart flow, every value
   checked against numpy, with the kernels' launch counters read around it;
5. kernel times with CUDA events beside the plain versions' and the bound.

Every comparison is exact: the values are integers.  The last line is the
``{"ok": true, "device": ...}`` object; the line before it names the card
and its power limit; the ``{"kernels": [...]}`` line comes before that.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BANKS = 16
LANES = 65_536                  # bitlines of one 8 KB DRAM row
WORDS = LANES // 32             # plane words per bank
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64         # Hopper SM: 4 partitions × 16 INT32 lanes
SEED = 0x51D0
# kernel → largest |kernel − plain version| seen in phases 2 and 3
MAX_ABS_ERR: dict[str, int] = {}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _equal(got, want, what: str, kernel: str | None = None) -> None:
    _check(got.shape == want.shape, f"{what}: shapes {tuple(got.shape)} "
           f"and {tuple(want.shape)} differ")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if kernel is not None:
        MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
    _check(err == 0, f"{what}: kernel and plain version disagree by {err}")


# -- phase 1 -----------------------------------------------------------------

def build_kernels() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"kernel library {name}: {path.relative_to(ROOT)}")
        if name in _build.BUILD_LOG:
            for line in _build.BUILD_LOG[name][1].splitlines():
                if "registers" in line or "smem" in line:
                    print(f"  ptxas: {line.strip()}")
    print(f"build: {seconds:.2f} s")
    return seconds


# -- phase 2 -----------------------------------------------------------------

def check_transpose(device, lanes: int) -> None:
    import torch

    from repro_torch.kernels.bitplane_transpose import (
        from_planes, from_planes_plain, to_planes, to_planes_plain)
    g = torch.Generator(device=device).manual_seed(SEED)
    values = torch.randint(-2**31, 2**31, (lanes,), dtype=torch.int32,
                           device=device, generator=g)
    for n_bits in (1, 8, 16, 32):
        planes = to_planes(values, n_bits)
        _equal(planes, to_planes_plain(values, n_bits), f"to_planes/{n_bits}b",
               "bitplane_to_planes")
        for signed in (False, True):
            back = from_planes(planes, signed=signed)
            _equal(back, from_planes_plain(planes, signed),
                   f"from_planes/{n_bits}b signed={signed}",
                   "bitplane_from_planes")
            # the round trip keeps the low n_bits (sign-extended if signed)
            s = 32 - n_bits
            want = (values << s) >> s if signed else \
                (values & ((1 << n_bits) - 1) if n_bits < 32 else values)
            _equal(back, want, f"round trip/{n_bits}b signed={signed}")
    print(f"phase 2: transposition kernels == plain versions "
          f"(n_bits 1/8/16/32, signed/unsigned, {lanes} lanes)")


# -- phase 3 -----------------------------------------------------------------

def fsm_cases(full: bool = True) -> list:
    """(label, trace) pairs phase 3 runs the FSM kernel on."""
    from repro_torch.core.circuits import list_operations
    from repro_torch.core.trace import compile_chain_trace, compile_trace
    cases = [(f"{op}/8b", compile_trace(op, 8)[1]) for op in list_operations()]
    if full:
        cases += [(f"{op}/32b", compile_trace(op, 32)[1])
                  for op in ("addition", "multiplication", "division")]
    chain = (("multiplication", ("a", "b"), "t"), ("addition", ("t", "c"), "u"),
             ("relu", ("u",), "v"))
    cases.append(("chain relu(add(mul))/8b",
                  compile_chain_trace(chain, 8, outputs=("v",))[1]))
    return cases


def random_rows(trace, banks: int, words: int, device, seed: int):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (banks, trace.n_rows, words),
                         dtype=torch.int32, device=device, generator=g)


def check_fsm(device, banks: int, words: int, full: bool = True) -> None:
    import torch

    from repro_torch.kernels.uprog_executor import (uprog_execute,
                                                    uprog_execute_plain)
    for k, (label, trace) in enumerate(fsm_cases(full)):
        cmds = torch.as_tensor(trace.cmds, dtype=torch.int32, device=device)
        rows = random_rows(trace, banks, words, device, SEED + k)
        _equal(uprog_execute(cmds, rows), uprog_execute_plain(cmds, rows),
               f"uprog_execute {label}", "uprog_execute")
        print(f"phase 3: FSM kernel == plain on {label} "
              f"(R={trace.n_rows}, N={trace.n_commands}, "
              f"{banks}x{words} words)")


# -- phase 4 -----------------------------------------------------------------

def main_path(device, banks: int, lanes: int) -> dict:
    """The quickstart flow on the port, every value checked against numpy.
    Returns the machine's report and timings."""
    import numpy as np
    import torch

    from repro_torch.core.graph import lit_not
    from repro_torch.core.uprogram import DRow
    from repro_torch.ops import (SimdramMachine, bbop_add, bbop_greater,
                                 bbop_if_else, bbop_mul, bbop_relu, bbop_sub)
    from repro_torch.simdram.layout import (reset_transpose_stats,
                                            transpose_counts)
    from repro_torch.simdram.timing import DRAMTiming

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    machine = SimdramMachine(timing=DRAMTiming(), banks=banks, mode="replay",
                             device=device)
    _check(machine.backend is None, "machine must run the default backend")
    shape = (banks, lanes)
    x, y = rng.integers(0, 256, shape), rng.integers(0, 256, shape)

    # Step 3 through a bound op
    out = machine.op("addition")(x, y, n_bits=8)
    _check(out.device.type == torch.device(device).type,
           "result left the machine's device")
    _check(np.array_equal(host(out), (x + y) & 255), "op('addition')")

    # paper Listing 1: predicated add/sub through the bbop ISA
    a, b = rng.integers(0, 128, shape), rng.integers(0, 128, shape)
    pred = rng.integers(0, 128, shape)
    with machine.session():
        d = bbop_add(a, b, 8)
        e = bbop_sub(a, b, 8)
        f = bbop_greater(a, pred, 8)
        c = bbop_if_else(f, d, e, 8)
    _check(np.array_equal(host(c), np.where(a > pred, (a + b) & 255,
                                            (a - b) & 255)),
           "Listing-1 predicated add/sub")

    # user-defined operation: Steps 1-3 as API
    def build_gated_sub(g):
        av, bv, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
        bg = g.gate_and(bv, gate)
        axb = g.gate_xor(av, bg)
        g.add_output("out", g.gate_xor(axb, w))
        g.add_output("borrow", g.gate_or_node(
            g.gate_and(lit_not(av), bg), g.gate_and(w, lit_not(axb))))

    gated_sub = machine.define_op(
        "gated_sub", build_gated_sub,
        invariants={"gate": DRow("gate", 0, fixed=True)},
        states={"borrow": 0})
    gmask = rng.integers(0, 2, shape)
    with machine.timed(mode="replay") as st:
        got = gated_sub(x, y, gmask, n_bits=8)
    _check(np.array_equal(host(got), np.where(gmask, (x - y) & 255, x)),
           "define_op('gated_sub')")
    _check(st.replay_ns >= st.exec_ns > 0, "gated_sub replay timing")

    # plane-resident pipeline: relu(add(mul)), unfused and fused
    av, bv, cv = (rng.integers(0, 256, shape) for _ in range(3))
    raw = (av * bv + cv) & 255
    want = np.where(raw >> 7, 0, raw)
    for fused in (False, True):
        reset_transpose_stats()
        with machine.pipeline(timed=True, fused_trace=fused) as p:
            pa, pb, pc = p.load([av, bv, cv], 8)
            res = p.store(bbop_relu(bbop_add(bbop_mul(pa, pb, 8), pc, 8), 8))
        _check(np.array_equal(host(res), want),
               f"pipeline relu(add(mul)) fused={fused}")
        _check(transpose_counts() == (1, 1),
               f"pipeline transposition passes {transpose_counts()}")

    # two tenants, one bank-stacked request each: submit / drain(batch=True)
    ops_a = [(rng.integers(0, 256, lanes), rng.integers(0, 256, lanes))
             for _ in range(banks)]
    ops_b = [(rng.integers(0, 16, lanes), rng.integers(0, 16, lanes))
             for _ in range(banks)]
    meters = ("exec_ns", "exec_nj", "replay_ns", "elem_ops")
    before = {m: getattr(machine.stats, m) for m in meters}
    futs = [machine.submit("addition", p, q, tenant="A") for p, q in ops_a]
    futs += [machine.submit("multiplication", p, q, tenant="B")
             for p, q in ops_b]
    sched = machine.drain(batch=True)
    _check(sched.n_requests == 2, f"batched drain issued {sched.n_requests} "
           "requests, expected one per tenant")
    for fut, (p, q) in zip(futs, ops_a + ops_b):
        want = (p + q) & 255 if fut.name == "addition" else (p * q) & 255
        _check(np.array_equal(host(fut.result()), want),
               f"drained {fut.name} for tenant {fut.tenant}")
    tenants = machine.stats.tenants
    _check(set(tenants) == {"A", "B"}, f"tenants {sorted(tenants)}")
    for meter in meters:        # the drain's share of the machine meters
        total = sum(getattr(t, meter) for t in tenants.values())
        drained = getattr(machine.stats, meter) - before[meter]
        _check(total > 0 and abs(total - drained) <= 1e-9 * total,
               f"tenant {meter} {total} does not sum to the drain's {drained}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"report": machine.perf_report(), "seconds": seconds,
            "makespan_ns": sched.ns}


# -- phase 5 -----------------------------------------------------------------

def cuda_ms(fn, inputs: list, iters: int) -> float:
    """Mean device time of ``fn(*inputs[i % len])`` over ``iters`` calls,
    after two warm-up calls, with CUDA events; the inputs rotate so the
    working set exceeds the 50 MB L2 where it can."""
    import torch
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, args, kernel: str, iters: int = 20) -> float | None:
    """Mean device time of the kernel named ``kernel`` per the profiler
    (None if the trace shows no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
    except RuntimeError as exc:        # CUPTI tracing not permitted here
        print(f"profiler unavailable: {exc}")
        return None
    times = [e.device_time_total for e in prof.key_averages()
             if kernel in e.key]
    return sum(times) / iters / 1e3 if times else None


def device_breakdown(device) -> None:
    """Run the main path once more under the profiler and print how much
    of its wall time the device was busy, and with which kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            seconds = main_path(device, BANKS, LANES)["seconds"]
    except RuntimeError as exc:        # CUPTI tracing not permitted here
        print(f"profiler unavailable: {exc}")
        return
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    print(f"main path under the profiler: {seconds:.3f} s wall, device busy "
          f"{busy:.3f} ms ({100 * busy / 1e3 / seconds:.2f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5} {key[:90]}")
    torch.cuda.synchronize()


def fsm_ops_per_word(cmds) -> int:
    """Integer operations one word column needs for a command stream: one
    3-input logic op per MAJ, one NOT more where a MAJ writes a complement,
    one NOT per COPY whose source and destination differ in polarity."""
    op, a, b, c = (cmds[:, i] for i in range(4))
    maj = op == 1
    return int(maj.sum() + (maj & ((a < 0) | (b < 0) | (c < 0))).sum()
               + (~maj & ((a < 0) != (b < 0))).sum())


def bound_ms(nbytes: float, ops: float, int_ops_per_s: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(device, launches: dict, int_ops_per_s: float) -> list:
    import torch

    from repro_torch.core.trace import compile_trace
    from repro_torch.kernels.bitplane_transpose import (
        from_planes, from_planes_plain, to_planes, to_planes_plain)
    from repro_torch.kernels.uprog_executor import (uprog_execute,
                                                    uprog_execute_plain)
    fsm_src = "src/repro_torch/kernels/csrc/uprog_executor.cu"
    k2_src = "src/repro_torch/kernels/csrc/bitplane_transpose.cu"
    rows_out = []
    for op, n_bits in (("multiplication", 8), ("division", 32)):
        trace = compile_trace(op, n_bits)[1]
        cmds = torch.as_tensor(trace.cmds, dtype=torch.int32, device=device)
        file_bytes = trace.n_rows * BANKS * WORDS * 4
        copies = max(2, min(8, int(200e6 // file_bytes)))
        inputs = [(cmds, random_rows(trace, BANKS, WORDS, device, SEED + i),
                   False) for i in range(copies)]
        ms = cuda_ms(uprog_execute, inputs, iters=50)
        plain_ms = cuda_ms(uprog_execute_plain, [inputs[0][:2]], iters=1)
        kernel_ms = profiled_ms(uprog_execute, inputs[0], "uprog_execute")
        nbytes = 2 * file_bytes + trace.cmds.nbytes
        ops = fsm_ops_per_word(trace.cmds) * BANKS * WORDS
        bound, by = bound_ms(nbytes, ops, int_ops_per_s)
        rows_out.append({
            "name": f"uprog_execute/{op}_{n_bits}b", "route": "cuda",
            "source": fsm_src,
            "replaces": "src/repro/kernels/uprog_executor.py:76",
            "launches": launches["uprog_execute"],
            "max_abs_err": MAX_ABS_ERR["uprog_execute"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "kernel_ms": kernel_ms,
            "shape": f"R={trace.n_rows} N={trace.n_commands} "
                     f"{BANKS}x{WORDS} words"})
    n_bits, lanes = 8, BANKS * LANES
    g = torch.Generator(device=device).manual_seed(SEED)
    vals = [(torch.randint(-2**31, 2**31, (lanes,), dtype=torch.int32,
                           device=device, generator=g), n_bits)
            for _ in range(24)]                 # 24 × 4 MB > L2
    planes = [(to_planes_plain(v, n_bits), True) for v, _ in vals]
    nbytes = lanes * 4 + n_bits * lanes // 8
    bound, by = bound_ms(nbytes, n_bits * lanes, int_ops_per_s)
    for name, fn, plain, inputs in (
            ("bitplane_to_planes", to_planes, to_planes_plain, vals),
            ("bitplane_from_planes", from_planes, from_planes_plain, planes)):
        rows_out.append({
            "name": name, "route": "cuda", "source": k2_src,
            "replaces": "src/repro/kernels/bitplane_transpose.py:66",
            "launches": launches[name], "max_abs_err": MAX_ABS_ERR[name],
            "ms": cuda_ms(fn, inputs, iters=200),
            "plain_ms": cuda_ms(plain, inputs, iters=20),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "kernel_ms": profiled_ms(fn, inputs[0], name.split("_", 1)[1]),
            "shape": f"{n_bits} planes x {lanes} lanes"})
    return rows_out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.bitplane_transpose import from_planes, to_planes
    from repro_torch.kernels.uprog_executor import uprog_execute

    card = _smi("name,power.limit")
    print(f"card: {card}")
    device = "cuda"
    build_kernels()
    check_transpose(device, BANKS * LANES)
    check_fsm(device, BANKS, WORDS)

    wrappers = {"uprog_execute": uprog_execute, "bitplane_to_planes": to_planes,
                "bitplane_from_planes": from_planes}
    for w in wrappers.values():
        w.launches = 0
    path = main_path(device, BANKS, LANES)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"phase 4: main path OK in {path['seconds']:.2f} s "
          f"(drain makespan {path['makespan_ns']:.1f} modeled ns); "
          f"launches {launches}")
    print(path["report"])
    idle = [name for name, n in launches.items() if n == 0]
    _check(not idle, f"kernels not launched on the main path: {idle}")
    device_breakdown(device)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    int_ops_per_s = sms * INT32_LANES_PER_SM * max_mhz * 1e6
    print(f"INT32 peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{max_mhz:.0f} MHz = {int_ops_per_s / 1e12:.2f} Tops/s")
    kernels = measure(device, launches, int_ops_per_s)
    print(json.dumps({"kernels": kernels}))
    print(_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
