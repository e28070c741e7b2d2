"""``bbop_stream``: one caller issuing rounds of bbops on a SimdramMachine.

Configuration (``kind`` ``simdram_machine``): ``banks`` × ``lanes``
elements an op, the machine's ``backend``.  Traffic: ``n_bits``, ``ops``
(each ``[operation, [operand roles]]``), ``pool`` operand sets made on the
device from the seed, ``check_rounds`` rounds kept for the check and
``trace_rounds`` rounds profiled, and the limit of the check.  Roles:
``a``, ``b`` (never 0), ``c``, ``d`` (``a`` where ``sel`` is 1, else
``b``: equal values) and ``sel`` (0 or 1).

Closed loop: each round runs every op once, in an order drawn from the
seed, each on an operand set drawn from the seed; every op is one call of
the port's ``bbop_*`` on horizontal values, so one transposition in a
source, the μProgram, one transposition out.  The warm-up round and the
window run inside the machine's timed scope, so the machine meters the
modeled DRAM cost of every op, as a simulator's user reads it.  Set-up
compiles every op (timed as the span ``uprog_compile``) and runs one round.

The check compares every value of a sample of rounds (drawn from the seed
by reservoir sampling, and the last round) with the NumPy reference, and
the machine's meters (``exec_ns``, ``exec_nj``, ``elem_ops``,
``n_commands``) with the sums of the reference's table of each μProgram's
cost over every op issued, both exactly.  With ``control`` the NumPy
reference one bit narrower stands in the program's place.
"""
from __future__ import annotations

import time

import torch

from simbench.counts import peaks
from simbench.counts.uprog import op_bounds
from simbench.harness import seeds
from simbench.harness.profile import Trace
from simbench.harness.stats import rate
from simbench.reference import bbop_numpy, dram_meters

# operation → the port's bbop function; reductions take their sources as
# one list
BBOPS = {
    "abs": "bbop_abs", "addition": "bbop_add", "bitcount": "bbop_bitcount",
    "division": "bbop_div", "equal": "bbop_equal", "greater": "bbop_greater",
    "greater_equal": "bbop_greater_equal", "if_else": "bbop_if_else",
    "maximum": "bbop_max", "minimum": "bbop_min",
    "multiplication": "bbop_mul", "relu": "bbop_relu",
    "subtraction": "bbop_sub", "and_reduction": "bbop_and",
    "or_reduction": "bbop_or", "xor_reduction": "bbop_xor",
}
REDUCTIONS = ("and_reduction", "or_reduction", "xor_reduction")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_pool(n_sets: int, banks: int, lanes: int, n_bits: int, seed: int,
              device) -> list[dict]:
    """``n_sets`` operand sets of (banks, lanes) int32 values, drawn on
    ``device`` in one call each."""
    g = seeds.torch_generator(seed, 0, device)
    lo, hi = (-2 ** 31, 2 ** 31) if n_bits == 32 else (0, 2 ** n_bits)
    vals = torch.randint(lo, hi, (n_sets, 3, banks, lanes), generator=g,
                         dtype=torch.int32, device=device)
    sel = torch.randint(0, 2, (n_sets, banks, lanes), generator=g,
                        dtype=torch.int32, device=device)
    pool = []
    for i in range(n_sets):
        a, b, c = vals[i, 0], vals[i, 1], vals[i, 2]
        b = torch.where(b == 0, torch.ones_like(b), b)
        s = sel[i]
        pool.append({"a": a, "b": b, "c": c, "sel": s,
                     "d": torch.where(s.bool(), a, b)})
    return pool


def _caller(machine, op: str, roles, n_bits: int, pool: list):
    """The port's bbop of ``op`` on operand set ``s`` of ``pool``."""
    from repro_torch.ops import bbops
    fn = getattr(bbops, BBOPS[op])

    def call(s: int):
        args = [pool[s][r] for r in roles]
        with machine.session():
            if op in REDUCTIONS:
                return fn(args, n_bits)
            return fn(*args, n_bits)
    return call


def _stand_in(op: str, roles, n_bits: int, host: list):
    """The control: the NumPy reference at ``n_bits`` in the program's
    place."""
    def call(s: int):
        args = [host[s][r] for r in roles]
        return torch.from_numpy(bbop_numpy.expected(op, args, n_bits))
    return call


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, mark_window, control: bool = False) -> dict:
    from repro_torch.ops import SimdramMachine
    from repro_torch.simdram.timing import DRAMTiming

    n_bits = traffic["n_bits"]
    banks, lanes = config["banks"], config["lanes"]
    elements = banks * lanes
    ops = [(op, tuple(roles)) for op, roles in traffic["ops"]]
    pk = peaks()
    machine = SimdramMachine(timing=DRAMTiming(), banks=banks,
                             backend=config["backend"], device=device)

    # Steps 1-2 for every op, timed: the μProgram Memory's compiles
    bounds = []
    t = time.perf_counter()
    for op, roles in ops:
        _, lowered = machine.memory.get(op, n_bits, True)
        in_bits = [1 if r == "sel" else n_bits for r in roles]
        bounds.append(op_bounds(lowered.cmds, lowered.n_rows, in_bits,
                                bbop_numpy.out_bits(op, n_bits), elements, pk))
    compile_s = time.perf_counter() - t
    pool = make_pool(traffic["pool"], banks, lanes, n_bits, seed, device)
    host = [{k: v.cpu().numpy() for k, v in s.items()} for s in pool] \
        if control else None
    if control:
        calls = [_stand_in(op, roles, n_bits - 1, host) for op, roles in ops]
    else:
        calls = [_caller(machine, op, roles, n_bits, pool)
                 for op, roles in ops]
    issued: list[str] = []                     # every metered op, in order
    with machine.timed():
        for j, call in enumerate(calls):       # warm-up: one round
            call(0)
            issued.append(ops[j][0])
    _sync(device)

    order = seeds.rng(seed, 1)
    keep = seeds.rng(seed, 2)

    def one_round():
        perm = order.permutation(len(ops))
        sets = order.integers(0, len(pool), len(ops))
        return [(int(j), int(s), calls[j](int(s))) for j, s in zip(perm, sets)]

    n_keep = traffic["check_rounds"]
    kept: list = []
    rounds = 0
    with machine.timed():
        mark_window()
        t0 = time.perf_counter()
        while True:
            outs = one_round()
            issued += [ops[j][0] for j, _, _ in outs]
            if rounds < n_keep:
                kept.append((rounds, outs))
            else:
                j = int(keep.integers(0, rounds + 1))
                if j < n_keep:
                    kept[j] = (rounds, outs)
            last = (rounds, outs)
            rounds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    st = machine.stats
    metered = {k: getattr(st, k) for k in
               ("exec_ns", "exec_nj", "elem_ops", "n_commands")}
    n_ops = rounds * len(ops)
    ctx = {"spans": {"uprog_compile": compile_s}, "window_s": wall,
           "window_least_s": rounds * sum(b["op"] for b in bounds),
           "trace": None}
    if trace:
        tr = Trace(device)
        tr.start()
        one_round()                             # the profiler's warm-up
        tr.open_window()
        for _ in range(traffic["trace_rounds"]):
            one_round()
        tr.close_window()
        ctx["trace"] = tr.stop()
        ctx["profiled_bounds"] = {
            k: traffic["trace_rounds"] * sum(b[k] for b in bounds)
            for k in ("k1", "k2")}
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    # the check: every value of the sampled rounds, against NumPy; the
    # machine's meters against the reference's sums over every op issued
    if last[0] not in {r for r, _ in kept}:
        kept.append(last)
    host = host or [{k: v.cpu().numpy() for k, v in s.items()} for s in pool]
    bad = checked = 0
    for _, outs in kept:
        for j, s, out in outs:
            op, roles = ops[j]
            args = [host[s][r] for r in roles]
            got = out.cpu().numpy()
            bad += bbop_numpy.mismatches(op, args, got, n_bits)
            checked += got.size
    want = dram_meters.meters(dram_meters.table(config["name"], n_bits),
                              issued, banks, lanes)
    lim = traffic["checks"]
    checks = {"mismatched_values": (bad, lim["mismatched_values"])}
    for k, v in want.items():
        checks[f"{k}_off"] = (abs(metered[k] - v), lim["meters_off"])
    return {
        "e2e": {"bbop_elems_per_s": rate(n_ops * elements, wall) / 1e9},
        "ctx": ctx,
        "checks": checks,
        "correct": checked > 0 and all(v <= t for v, t in checks.values()),
        "attempted": n_ops, "failed": 0,
        "memory_peak_bytes": peak,
        "notes": {"rounds": rounds, "values_checked": checked,
                  "exec_ns": metered["exec_ns"], "exec_nj": metered["exec_nj"]},
    }
