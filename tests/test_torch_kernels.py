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
from repro_torch.kernels.bitplane_transpose import (from_planes,
                                                    from_planes_plain,
                                                    to_planes, to_planes_plain)
from repro_torch.kernels.ops import run_trace_kernel
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
def test_transpose_kernels_match_plain_on_gpu():
    dev = cuda_or_skip()
    v = torch.from_numpy(random_words(32 * 1000).view(np.int32)).to(dev)
    for n_bits in (1, 7, 8, 32):
        planes = to_planes(v, n_bits)
        assert torch.equal(planes, to_planes_plain(v, n_bits))
        for signed in (False, True):
            assert torch.equal(from_planes(planes, signed),
                               from_planes_plain(planes, signed))


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
