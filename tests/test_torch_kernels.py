"""The port's main-path kernels: the control-unit FSM and the transposition
unit.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the reference's Pallas kernel (``interpret=True``) and its jnp
oracle (``repro.kernels.ref``).  The ``gpu``-marked tests hold each CUDA
kernel against its plain version on the card; without a CUDA device they
skip with the reason "no CUDA device".  The reference package and JAX
are imported inside the CPU tests only, so the ``gpu`` tests also run on a
machine that has no JAX (``pytest -m gpu``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.trace import compile_chain_trace, compile_trace
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bitplane_transpose import (from_planes,
                                                    from_planes_plain,
                                                    to_planes, to_planes_plain)
from repro_torch.kernels.ops import run_trace_kernel, run_uprogram_kernel
from repro_torch.kernels.ref import uprog_maj_ref
from repro_torch.kernels.uprog_executor import (check_cmds, uprog_execute,
                                                uprog_execute_plain)

RNG = np.random.default_rng(0xF5A)
OPS = ("addition", "greater", "if_else")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def random_words(shape) -> np.ndarray:
    return RNG.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def operand_planes(trace, n_bits: int, words: int, banks: int | None = None):
    names = dict.fromkeys(trace.inputs)
    lead = () if banks is None else (banks,)
    return {name: random_words((*lead, n_bits, words)) for name in names}


def aliased_stream(rng, n_rows: int, n_cmds: int) -> np.ndarray:
    """A seeded int32[n_cmds, 4] command stream whose ports alias: MAJ with
    a == b, MAJ with a == -c, COPY onto its own source (plain or
    complemented), beside MAJ and COPY on independent random ports."""
    a, b, c = (rng.integers(1, n_rows + 1, n_cmds)
               * rng.choice((-1, 1), n_cmds) for _ in range(3))
    kind = np.arange(n_cmds) % 5
    op = np.isin(kind, (0, 1, 3)).astype(np.int64)
    b = np.where(kind == 0, a, np.where(kind == 2, a * rng.choice((-1, 1),
                                                                 n_cmds), b))
    c = np.where(kind == 1, -a, np.where(op == 0, b, c))
    return np.stack([op, a, b, c], axis=1).astype(np.int32)


def run_decoded(cmds: np.ndarray, rows: np.ndarray, order=(0, 1, 2),
                unroll: int = 16) -> np.ndarray:
    """The CUDA FSM on numpy, as ``csrc/uprog_executor.cu`` decodes it: a
    MAJ's ports (a, b, c), read and written in ``order``; a COPY a ← b as
    ports (b, b, a) that reads port 0 and writes port 2; each port a byte
    offset (|i| − 1) · 128 into a 32-column file, bit-inverted for a
    complement port (mask = port >> 31, offset = port ^ mask); the stream
    padded to whole unrolled groups with COPY 1 ← 1."""
    def encode(i):
        off = (np.abs(i) - 1) * 128
        return np.where(i < 0, ~off, off).astype(np.int32)

    pad = np.tile(np.array([[0, 1, 1, 1]], np.int32),
                  (-len(cmds) % unroll, 1))
    file = rows.copy()
    for op, a, b, c in np.concatenate([cmds, pad]):
        e = encode(np.array((a, b, c) if op == 1 else (b, b, a)))
        mask = e >> 31
        row = (e ^ mask) // 128
        if op == 1:
            v = [file[r] ^ m for r, m in zip(row, mask)]
            maj = (v[0] & v[1]) | (v[0] & v[2]) | (v[1] & v[2])
            for k in order:
                file[row[k]] = maj ^ mask[k]
        else:
            file[row[2]] = file[row[0]] ^ mask[0] ^ mask[2]
    return file


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("op", OPS)
def test_fsm_plain_matches_pallas_kernel(op):
    """run_trace_kernel (plain FSM on CPU) ≡ the reference's Pallas FSM in
    interpret mode, on the same operand planes."""
    import jax.numpy as jnp

    from repro.core.trace import compile_trace as ref_compile_trace
    from repro.kernels.ops import run_trace_kernel as ref_run_trace_kernel
    trace = compile_trace(op, 8)[1]
    ref_trace = ref_compile_trace(op, 8)[1]
    assert trace.fingerprint == ref_trace.fingerprint
    ops = operand_planes(trace, 8, words=6)
    want = ref_run_trace_kernel(ref_trace, {k: jnp.asarray(v)
                                            for k, v in ops.items()},
                                interpret=True)
    got = run_trace_kernel(trace, {k: torch.from_numpy(v.view(np.int32))
                                   for k, v in ops.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(u32(got[name]), np.asarray(want[name]))


@pytest.mark.parametrize("op", OPS)
def test_fsm_plain_matches_uprog_maj_ref(op):
    """The plain FSM ≡ ``repro.kernels.ref.uprog_maj_ref`` on a random row
    file (every row random, so aliasing and complement writes all show)."""
    import jax.numpy as jnp

    from repro.kernels.ref import uprog_maj_ref as jax_uprog_maj_ref
    trace = compile_trace(op, 8)[1]
    rows = random_words((trace.n_rows, 8))
    want = np.asarray(jax_uprog_maj_ref(jnp.asarray(rows),
                                        jnp.asarray(trace.cmds)))
    cmds = torch.from_numpy(trace.cmds.astype(np.int32))
    got = uprog_execute(cmds, torch.from_numpy(rows.view(np.int32)))
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(
        u32(uprog_maj_ref(torch.from_numpy(rows.view(np.int32)), cmds)), want)


@pytest.mark.parametrize("n_rows,n_cmds,seed",
                         [(3, 48, 0), (8, 97, 1), (32, 200, 2)])
def test_fsm_plain_matches_pallas_on_aliased_streams(n_rows, n_cmds, seed):
    """On streams whose ports alias (a == b, a == -c, COPY onto its own
    source), the plain FSM ≡ the reference's Pallas FSM (interpret mode)
    ≡ ``repro.kernels.ref.uprog_maj_ref``: the MAJ writes a, then b, then
    c, and the last write wins."""
    import jax.numpy as jnp

    from repro.kernels.ref import uprog_maj_ref as jax_uprog_maj_ref
    from repro.kernels.uprog_executor import uprog_execute as pallas_execute
    rng = np.random.default_rng(seed)
    cmds = aliased_stream(rng, n_rows, n_cmds)
    op, a, b, c = cmds.T
    assert ((op == 1) & (a == b)).any() and ((op == 1) & (a == -c)).any()
    assert ((op == 0) & (a == b)).any() and ((op == 0) & (a == -b)).any()
    rows = random_words((n_rows, 128))
    got = u32(uprog_execute_plain(torch.from_numpy(cmds),
                                  torch.from_numpy(rows.view(np.int32))))
    kernel = np.asarray(pallas_execute(jnp.asarray(cmds), jnp.asarray(rows),
                                       interpret=True))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(
        got, np.asarray(jax_uprog_maj_ref(jnp.asarray(rows),
                                          jnp.asarray(cmds))))


@pytest.mark.parametrize("n_rows,n_cmds,seed",
                         [(3, 48, 3), (8, 97, 4), (235, 600, 5)])
def test_fsm_kernel_decode_matches_plain(n_rows, n_cmds, seed):
    """The CUDA kernel's decoded ports, padding and MAJ (modelled on numpy)
    ≡ the plain FSM on aliased streams; writing a MAJ's ports in another
    order than a, b, c does not, so the streams hold that order."""
    rng = np.random.default_rng(seed)
    cmds = aliased_stream(rng, n_rows, n_cmds)
    rows = random_words((n_rows, 32)).view(np.int32)
    want = uprog_execute_plain(torch.from_numpy(cmds),
                               torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(run_decoded(cmds, rows), want)
    assert not np.array_equal(run_decoded(cmds, rows, order=(2, 1, 0)), want)


def test_to_planes_shuffle_network_is_the_transpose():
    """The to-planes kernel's 5-stage network (modelled on numpy, lanes on
    an axis): stage j rotates the partner's word by j (lanes without bit
    j) or 32 − j (lanes with it) and replaces the columns ``keep``
    selects; lane i ends with plane word i."""
    x = random_words((50, 32))                     # 50 groups of 32 lanes
    lane = np.arange(32)
    v = x.astype(np.uint64)
    for j in (16, 8, 4, 2, 1):
        low = 0xFFFFFFFF // ((1 << j) + 1)
        upper = (lane & j) == 0
        keep = np.where(upper, ~low & 0xFFFFFFFF, low).astype(np.uint64)
        p = v[:, lane ^ j]
        s = np.where(upper, j, 32 - j).astype(np.uint64)
        moved = ((p << s) | (p >> (np.uint64(32) - s))) & 0xFFFFFFFF
        v = v ^ ((v ^ moved) & keep)
    want = to_planes_plain(torch.from_numpy(x.reshape(-1).view(np.int32)), 32)
    np.testing.assert_array_equal(v.astype(np.uint32).T, u32(want))


def test_fsm_banked_row_file_is_per_bank():
    trace = compile_trace("multiplication", 8)[1]
    cmds = torch.from_numpy(trace.cmds.astype(np.int32))
    rows = torch.from_numpy(random_words((3, trace.n_rows, 5)).view(np.int32))
    got = uprog_execute_plain(cmds, rows)
    for b in range(3):
        assert torch.equal(got[b], uprog_execute_plain(cmds, rows[b]))
    assert torch.equal(rows, rows.clone())      # input untouched


def test_fsm_rejects_row_zero_and_out_of_range_rows():
    trace = compile_trace("addition", 8)[1]
    assert (trace.cmds[:, 1:] != 0).all()       # encode_uops never emits 0
    bad = trace.cmds.copy()
    bad[3, 2] = 0
    rows = torch.zeros((trace.n_rows, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="row 0"):
        uprog_execute(torch.from_numpy(bad), rows)
    with pytest.raises(ValueError, match="row 0"):
        run_trace_kernel(dataclasses.replace(trace, cmds=bad,
                                             _fingerprint=None),
                         {"a": rows[:8], "b": rows[:8]})
    far = trace.cmds.copy()
    far[0, 1] = -(trace.n_rows + 1)
    with pytest.raises(ValueError, match="beyond"):
        check_cmds(far, trace.n_rows)
    with pytest.raises(ValueError, match="opcodes"):
        check_cmds(np.array([[2, 1, 1, 1]], np.int32), 4)


def test_cpu_fsm_counts_no_launch():
    trace = compile_trace("relu", 8)[1]
    n = uprog_execute.launches
    run_trace_kernel(trace, {"a": torch.zeros((8, 4), dtype=torch.int32)})
    assert uprog_execute.launches == n


def chain_trace():
    return compile_chain_trace(
        (("multiplication", ("a", "b"), "t"), ("addition", ("t", "c"), "u")),
        8, outputs=("u",))[1]


def plane_operands(trace, banks: int | None, words: int = 5):
    """Random planes for each input: 8 planes, 1 for ``sel``."""
    lead = () if banks is None else (banks,)
    return {name: torch.from_numpy(random_words(
                (*lead, 1 if name == "sel" else 8, words)).view(np.int32))
            for name in dict.fromkeys(trace.inputs)}


def rows_by_lists(trace, operands) -> torch.Tensor:
    """The row file built from index lists made on each call, as
    ``run_trace_kernel`` built it before its plans: the reference the
    plan's row file is held to."""
    first = next(iter(operands.values()))
    rows = torch.zeros((*first.shape[:-2], trace.n_rows, first.shape[-1]),
                       dtype=torch.int32)
    for name, planes in operands.items():
        dst, src = [], []
        for bit in range(planes.shape[-2]):
            idx = trace.row_index.get((name, bit))
            if idx is not None:
                dst.append(idx - 1)
                src.append(bit)
        if dst:
            rows[..., dst, :] = planes[..., src, :]
    rows[..., trace.row_index["C1"] - 1, :] = -1
    return rows


@pytest.fixture
def no_plans(monkeypatch):
    """An empty plan cache, and ``kernels.row_plans`` at 0."""
    from repro_torch import telemetry
    monkeypatch.setattr(kops, "_PLANS", {})
    telemetry.reset("kernels.row_plans")
    yield lambda: telemetry.counter("kernels.row_plans")
    telemetry.reset("kernels.row_plans")


PLAN_CASES = {
    "unary": (lambda: compile_trace("abs", 8)[1], None, None),
    "binary": (lambda: compile_trace("addition", 8)[1], None, None),
    "binary_banked": (lambda: compile_trace("addition", 8)[1], 3, None),
    "three_operands": (lambda: compile_trace("if_else", 8)[1], None, None),
    "three_operands_banked": (lambda: compile_trace("if_else", 8)[1], 3,
                              None),
    "one_plane_out_banked": (lambda: compile_trace("greater", 8)[1], 2,
                             {"out": 1}),
    "chain": (chain_trace, None, None),
    "chain_banked": (chain_trace, 2, None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_row_file_and_outputs_equal_the_per_call_lists(case, no_plans):
    """Cold (the plan built) and warm (the plan reused), the row file and
    the outputs equal, bit for bit, those of index lists made on the
    call."""
    trace_of, banks, out_bits = PLAN_CASES[case]
    trace = trace_of()
    operands = plane_operands(trace, banks)
    cold = run_trace_kernel(trace, operands, out_bits)
    warm = run_trace_kernel(trace, operands, out_bits)
    assert no_plans() == 1
    plan = kops._row_plan(trace, operands, out_bits or {})
    want_rows = rows_by_lists(trace, operands)
    assert torch.equal(kops._row_file(trace, operands, plan), want_rows)
    final = uprog_execute_plain(torch.from_numpy(trace.cmds), want_rows)
    assert set(cold) == set(warm) == set(trace.outputs)
    for name in trace.outputs:
        ids = trace.out_row_ids(name, (out_bits or {}).get(name,
                                                           trace.n_bits))
        want = final[..., ids, :]
        assert torch.equal(cold[name], want), name
        assert torch.equal(warm[name], want), name


def test_a_plan_is_built_once_per_plane_counts_and_widths(no_plans):
    """The bank and word counts stay out of the key; another operand
    plane count or another output width builds a plan of its own, and an
    output wider than the trace's reads the C0 row past its bits."""
    trace = compile_trace("addition", 8)[1]
    (out,) = trace.outputs
    ops8 = plane_operands(trace, None)
    full = run_trace_kernel(trace, ops8)
    assert torch.equal(run_trace_kernel(trace, ops8)[out], full[out])
    assert no_plans() == 1
    run_trace_kernel(trace, plane_operands(trace, 4, words=3))
    assert no_plans() == 1
    run_trace_kernel(trace, {"a": ops8["a"][:5], "b": ops8["b"]})
    assert no_plans() == 2
    narrow = run_trace_kernel(trace, ops8, {out: 4})
    assert no_plans() == 3
    wide = run_trace_kernel(trace, ops8, {out: trace.n_bits + 2})
    assert no_plans() == 4
    assert torch.equal(narrow[out], full[out][:4])
    assert torch.equal(wide[out][:trace.n_bits], full[out])
    assert not wide[out][trace.n_bits:].any()
    c0 = trace.row_index["C0"] - 1
    assert kops._row_plan(trace, ops8, {out: trace.n_bits + 2}) \
        .gathers[0][1][trace.n_bits:].tolist() == [c0, c0]


def test_the_plan_cache_evicts_its_oldest_plan(no_plans, monkeypatch):
    monkeypatch.setattr(kops, "_PLANS_CAP", 2)
    trace = compile_trace("addition", 8)[1]
    (out,) = trace.outputs
    ops8 = plane_operands(trace, None)
    for width in (8, 7, 6):
        run_trace_kernel(trace, ops8, {out: width})
    assert [key[-1] for key in kops._PLANS] == [(7,), (6,)]
    run_trace_kernel(trace, ops8, {out: 6})
    assert no_plans() == 3
    run_trace_kernel(trace, ops8, {out: 8})
    assert no_plans() == 4


def test_the_fingerprint_fixes_the_row_map():
    """A plan's key holds the trace's fingerprint but not its row map:
    ``lower_program``, the only place the port makes a trace, numbers the
    D rows the fingerprint hashes in order, then C0, C1 and the B cells."""
    import ast
    import inspect
    from pathlib import Path

    import repro_torch
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.uprogram import N_B_CELLS
    makers = []
    for path in Path(repro_torch.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and "LoweredTrace" in (
                    getattr(node.func, "id", None),
                    getattr(node.func, "attr", None)):
                makers.append((path.name, node.lineno))
    lines, first = inspect.getsourcelines(trace_mod.lower_program)
    assert [name for name, _ in makers] == ["trace.py"]
    assert first <= makers[0][1] < first + len(lines)
    for trace in [compile_trace(op, n)[1] for op, n in
                  (("abs", 8), ("addition", 16), ("if_else", 8),
                   ("division", 4))] + [chain_trace()]:
        keys = [*trace.d_rows, "C0", "C1",
                *(("cell", c) for c in range(N_B_CELLS))]
        assert trace.row_index == {k: i + 1 for i, k in enumerate(keys)}


@pytest.mark.gpu
def test_fsm_kernel_matches_plain_on_gpu():
    dev = cuda_or_skip()
    traces = [compile_trace(op, 8)[1] for op in OPS + ("division",)]
    traces.append(compile_chain_trace(
        (("multiplication", ("a", "b"), "t"), ("addition", ("t", "c"), "u")),
        8, outputs=("u",))[1])
    for trace in traces:
        cmds = torch.as_tensor(trace.cmds, dtype=torch.int32, device=dev)
        rows = torch.from_numpy(random_words((4, trace.n_rows, 96))
                                .view(np.int32)).to(dev)
        n = uprog_execute.launches
        got = uprog_execute(cmds, rows)
        assert uprog_execute.launches == n + 1
        assert torch.equal(got, uprog_execute_plain(cmds, rows)), trace.name


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,n_cmds", [(3, 5), (3, 600), (32, 600),
                                           (235, 600)])
def test_fsm_kernel_matches_plain_on_aliased_streams_on_gpu(n_rows, n_cmds):
    """Aliased ports at R 3/32/235 on 3 banks × 97 words (columns not a
    multiple of the 32-column block), N below one unrolled group and above
    one staged chunk of 256 (not a multiple of it)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(n_rows + n_cmds)
    cmds = torch.from_numpy(aliased_stream(rng, n_rows, n_cmds)).to(dev)
    rows = torch.from_numpy(random_words((3, n_rows, 97))
                            .view(np.int32)).to(dev)
    n = uprog_execute.launches
    got = uprog_execute(cmds, rows)
    assert uprog_execute.launches == n + 1
    assert torch.equal(got, uprog_execute_plain(cmds, rows))


@pytest.mark.gpu
def test_to_planes_kernel_every_width_on_gpu():
    """to-planes at every n_bits 1–32, at 37 groups (below one block of
    128) and 300 (not a multiple of it)."""
    dev = cuda_or_skip()
    for groups in (37, 300):
        v = torch.from_numpy(random_words(32 * groups).view(np.int32)).to(dev)
        for n_bits in range(1, 33):
            n = to_planes.launches
            got = to_planes(v, n_bits)
            assert to_planes.launches == n + 1
            assert torch.equal(got, to_planes_plain(v, n_bits)), \
                (groups, n_bits)


@pytest.mark.gpu
def test_transpose_kernels_match_plain_on_gpu():
    dev = cuda_or_skip()
    v = torch.from_numpy(random_words(32 * 1000).view(np.int32)).to(dev)
    for n_bits in (1, 7, 8, 32):
        planes = to_planes(v, n_bits)
        assert torch.equal(planes, to_planes_plain(v, n_bits))
        for signed in (False, True):
            assert torch.equal(from_planes(planes, signed),
                               from_planes_plain(planes, signed))
    # from-planes loops n_bits times: every width, at a group count below
    # one block (33) and one that is not a multiple of 32 (1,000)
    for groups in (33, 1000):
        planes32 = torch.from_numpy(random_words((32, groups))
                                    .view(np.int32)).to(dev)
        for n_bits in range(1, 33):
            planes = planes32[:n_bits].contiguous()
            for signed in (False, True):
                n = from_planes.launches
                got = from_planes(planes, signed)
                assert from_planes.launches == n + 1
                assert torch.equal(got, from_planes_plain(planes, signed)), \
                    (groups, n_bits, signed)


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_run_uprogram_kernel_on_gpu_matches_the_cpu_run(op):
    """The μProgram-level entry on the card (one FSM launch) equals its CPU
    run at 8 bits, banked, greater's output cut to 1 plane."""
    dev = cuda_or_skip()
    prog, trace = compile_trace(op, 8)
    operands = {name: torch.from_numpy(
        random_words((16, 1 if name == "sel" else 8, 2048)).view(np.int32))
        for name in dict.fromkeys(prog.inputs)}
    out_bits = {"out": 1} if op == "greater" else None
    n = uprog_execute.launches
    got = run_uprogram_kernel(prog, {k: v.to(dev) for k, v in
                                     operands.items()}, out_bits)
    assert uprog_execute.launches == n + 1
    want = run_uprogram_kernel(prog, operands, out_bits)
    for name in want:
        assert got[name].device.type == "cuda"
        assert torch.equal(got[name].cpu(), want[name]), name


@pytest.mark.gpu
def test_cuda_machine_goes_through_both_kernels():
    """The machine on the card equals the same machine on the CPU, and its
    load, FSM and store ran as kernel launches."""
    from repro_torch.ops import SimdramMachine, bbop_greater, bbop_if_else
    dev = cuda_or_skip()
    a, b = (RNG.integers(-128, 128, (3, 70)) for _ in range(2))
    results = {}
    counts = (uprog_execute.launches, to_planes.launches, from_planes.launches)
    for device in ("cpu", dev):
        m = SimdramMachine(banks=3, device=device)
        with m.session():
            sel = bbop_greater(a, b, 8, signed=True)
            results[str(device)] = bbop_if_else(sel, a, b, 8).cpu()
    assert torch.equal(results["cpu"], results[str(dev)])
    np.testing.assert_array_equal(results["cpu"].numpy(),
                                  np.maximum(a, b) & 0xFF)
    after = (uprog_execute.launches, to_planes.launches, from_planes.launches)
    assert all(n > c for n, c in zip(after, counts))


@pytest.mark.gpu
def test_a_warm_bbop_does_not_synchronise():
    """Once its plan is built, a bbop on the card neither copies from the
    host nor waits on the stream: under the sync-debug mode "error" a
    second add, select and divide on (2, 4,096) banked operands raise
    nothing and equal the first."""
    from repro_torch.ops import SimdramMachine, bbop_add, bbop_div, \
        bbop_if_else
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(27)
    a, b = (torch.randint(0, 256, (2, 4096), generator=g, dtype=torch.int32,
                          device=dev) for _ in range(2))
    b = torch.where(b == 0, torch.ones_like(b), b)
    sel = torch.randint(0, 2, (2, 4096), generator=g, dtype=torch.int32,
                        device=dev)
    calls = {"add": lambda: bbop_add(a, b, 8),
             "if_else": lambda: bbop_if_else(sel, a, b, 8),
             "div": lambda: bbop_div(a, b, 8)}
    m = SimdramMachine(banks=2, device=dev)
    with m.session():
        cold = {name: call() for name, call in calls.items()}
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm = {name: call() for name, call in calls.items()}
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    for name in calls:
        assert torch.equal(cold[name], warm[name]), name
