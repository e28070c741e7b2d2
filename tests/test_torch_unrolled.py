"""The port's ``unrolled`` backend (``repro_torch.core.unrolled``) against
the reference package.

* Every builtin op at 8 bits, and addition/multiplication/division at 32
  bits, unbanked and banked: the port's ``run_trace_unrolled`` gives the
  same planes as ``repro.core.unrolled.run_trace_unrolled`` (run once per
  bank for banked operands) and as the port's ``reference`` and ``kernel``
  backends.
* ``run_unrolled`` on the source μProgram gives the same planes as the
  reference's ``run_unrolled``.
* The registered backend takes the bank axis in one pass and gives the
  planes of one run per bank.

All comparisons are exact.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.trace import compile_trace as ref_compile_trace
from repro.core.unrolled import (run_trace_unrolled as ref_run_trace_unrolled,
                                 run_unrolled as ref_run_unrolled)
from repro_torch.core import backends as TB
from repro_torch.core.circuits import list_operations
from repro_torch.core.trace import compile_trace
from repro_torch.core.unrolled import run_trace_unrolled, run_unrolled

OPS = sorted(list_operations())
CASES = [(op, 8) for op in OPS] + [(op, 32) for op in
                                   ("addition", "multiplication", "division")]
BANKS = 3


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _planes(prog, n_bits: int, banked: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lead = (BANKS,) if banked else ()
    return {name: rng.integers(0, 1 << 32, (*lead, n_bits, 5),
                               dtype=np.uint64).astype(np.uint32)
            for name in dict.fromkeys(prog.inputs)}


def _per_bank(fn, planes: dict, banked: bool) -> dict:
    """The reference function on unbanked planes, once per bank."""
    if not banked:
        return {k: np.asarray(v) for k, v in
                fn({n: jnp.asarray(p) for n, p in planes.items()}).items()}
    per = [fn({n: jnp.asarray(p[i]) for n, p in planes.items()})
           for i in range(BANKS)]
    return {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}


def _port(planes: dict) -> dict:
    return {k: torch.from_numpy(v.view(np.int32)) for k, v in planes.items()}


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("op,n_bits", CASES)
def test_run_trace_unrolled_matches_reference(op, n_bits, banked):
    ref_prog, ref_trace = ref_compile_trace(op, n_bits)
    prog, trace = compile_trace(op, n_bits)
    assert trace.fingerprint == ref_trace.fingerprint
    planes = _planes(prog, n_bits, banked,
                     seed=zlib.crc32(f"unrolled/{op}/{n_bits}".encode()))
    want = _per_bank(lambda ops: ref_run_trace_unrolled(ref_trace, ops),
                     planes, banked)
    got = run_trace_unrolled(trace, _port(planes))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(u32(got[name]), want[name],
                                      err_msg=f"{op}/{n_bits}b")
    for backend in ("unrolled", "reference", "kernel"):
        other = TB.execute_lowered(prog, trace, _port(planes), backend=backend)
        for name in want:
            np.testing.assert_array_equal(u32(other[name]), want[name],
                                          err_msg=f"{op}/{n_bits}b {backend}")


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_run_unrolled_matches_reference(op, banked):
    ref_prog = ref_compile_trace(op, 8)[0]
    prog = compile_trace(op, 8)[0]
    planes = _planes(prog, 8, banked, seed=zlib.crc32(f"uprog/{op}".encode()))
    want = _per_bank(lambda ops: ref_run_unrolled(ref_prog, ops), planes,
                     banked)
    got = run_unrolled(prog, _port(planes))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(u32(got[name]), want[name], err_msg=op)


def test_out_bits_and_missing_planes_match_reference():
    """Truncated outputs and operands with fewer planes than the op reads
    (the missing rows read as zero) agree with the reference too."""
    ref_trace = ref_compile_trace("addition", 8)[1]
    trace = compile_trace("addition", 8)[1]
    planes = _planes(compile_trace("addition", 8)[0], 8, False, seed=11)
    planes["b"] = planes["b"][:5]
    ops = {k: jnp.asarray(v) for k, v in planes.items()}
    for ob in ({"out": 3}, {"out": 8}):
        want = ref_run_trace_unrolled(ref_trace, ops, out_bits=ob)
        got = run_trace_unrolled(trace, _port(planes), out_bits=ob)
        for name in want:
            np.testing.assert_array_equal(u32(got[name]),
                                          np.asarray(want[name]))


def test_registered_backend_takes_the_bank_axis():
    fn = TB.get_backend("unrolled")
    assert fn.banked
    prog, trace = compile_trace("multiplication", 8)
    planes = _port(_planes(prog, 8, True, seed=5))
    banked = TB.execute_lowered(prog, trace, planes, backend="unrolled")
    for i in range(BANKS):
        one = TB.execute_lowered(prog, trace, {k: v[i] for k, v in
                                               planes.items()},
                                 backend="unrolled")
        for name in one:
            assert torch.equal(banked[name][i], one[name])
