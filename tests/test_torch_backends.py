"""The port's Step-3 seam (``repro_torch.core.backends``) against the
reference package.

* Every builtin op at 4/8/16 bits (and a 32-bit subset), banked and
  unbanked: the port's ``kernel`` backend (its plain FSM on the CPU), its
  ``unrolled`` backend and its ``reference`` backend give the same planes
  as ``repro``'s ``reference`` (numpy ``Subarray``) and ``unrolled``
  backends.
* The compile path gives the same ``LoweredTrace.fingerprint`` for every
  op, width and ``optimize`` setting.
* ``PerfStats.snapshot()`` of one timed chain is equal in analytic and
  replay mode.

All comparisons are exact.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as RB
from repro.core.circuits import list_operations as ref_list_operations
from repro.core.trace import compile_trace as ref_compile_trace
from repro.ops import (SimdramMachine as RefMachine, bbop_add as ref_add,
                       bbop_mul as ref_mul, bbop_relu as ref_relu)
from repro.simdram.layout import BitplaneArray as RefBitplaneArray
from repro_torch.core import backends as TB
from repro_torch.core.circuits import list_operations
from repro_torch.core.trace import compile_trace
from repro_torch.ops import (SimdramMachine, bbop_add, bbop_mul, bbop_relu)
from repro_torch.simdram.layout import BitplaneArray

OPS = sorted(list_operations())
WIDE_OPS = ("addition", "greater", "if_else", "relu")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _planes(prog, n_bits: int, banked: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lead = (2,) if banked else ()
    return {name: rng.integers(0, 1 << 32, (*lead, n_bits, 3),
                               dtype=np.uint64).astype(np.uint32)
            for name in dict.fromkeys(prog.inputs)}


def _check_parity(op: str, n_bits: int, banked: bool) -> None:
    ref_prog = ref_compile_trace(op, n_bits)[0]
    prog = compile_trace(op, n_bits)[0]
    planes = _planes(prog, n_bits, banked, seed=zlib.crc32(f"{op}/{n_bits}".encode()))
    ref_ops = {k: jnp.asarray(v) for k, v in planes.items()}
    port_ops = {k: torch.from_numpy(v.view(np.int32)) for k, v in planes.items()}
    want = RB.execute_program(ref_prog, ref_ops, backend="reference")
    unrolled = RB.execute_program(ref_prog, ref_ops, backend="unrolled")
    for name in want:
        np.testing.assert_array_equal(np.asarray(unrolled[name]),
                                      np.asarray(want[name]))
    for backend in ("kernel", "unrolled", "reference"):
        got = TB.execute_program(prog, port_ops, backend=backend)
        assert set(got) == set(want)
        for name in want:
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(u32(got[name]),
                                          np.asarray(want[name]),
                                          err_msg=f"{op}/{n_bits}b {backend}")


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("n_bits", [4, 8, 16])
@pytest.mark.parametrize("op", OPS)
def test_backends_match_reference(op, n_bits, banked):
    _check_parity(op, n_bits, banked)


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("op", WIDE_OPS)
def test_backends_match_reference_32_bits(op, banked):
    _check_parity(op, 32, banked)


def test_registry_surface():
    assert set(TB.list_backends()) == {"kernel", "reference", "unrolled"}
    assert TB.default_backend() == "kernel"
    assert TB.get_backend("kernel").banked
    assert TB.get_backend("unrolled").banked
    assert not getattr(TB.get_backend("reference"), "banked", False)
    with TB.use_backend("reference"):
        assert TB.default_backend() == "reference"
    assert TB.default_backend() == "kernel"
    with pytest.raises(KeyError):
        TB.get_backend("pallas")


def test_builtin_ops_are_the_reference_ops():
    assert tuple(OPS) == tuple(sorted(ref_list_operations()))


@pytest.mark.parametrize("op", OPS)
def test_trace_fingerprints_match_reference(op):
    for n_bits in (4, 8, 16, 32):
        for optimize in (True, False):
            ref = ref_compile_trace(op, n_bits, optimize)[1]
            got = compile_trace(op, n_bits, optimize)[1]
            assert got.fingerprint == ref.fingerprint, (n_bits, optimize)
            np.testing.assert_array_equal(got.cmds, ref.cmds)
            assert got.row_index == ref.row_index


def _timed_chain(pkg: str, mode: str):
    """One timed chain on a 4-bank machine: a transposed load, plane-
    resident ops (intra-bank hops), a gather and a scatter (inter-bank
    transfers, replay skew), a fused pipeline and the store."""
    rng = np.random.default_rng(0x57A7)
    a, b = (rng.integers(0, 256, (4, 96)) for _ in range(2))
    if pkg == "ref":
        m = RefMachine(banks=4, mode=mode, backend="reference")
        arr, bpa = jnp.asarray, RefBitplaneArray
        add, mul, relu = ref_add, ref_mul, ref_relu
    else:
        m = SimdramMachine(banks=4, mode=mode, device="cpu")
        arr, bpa = torch.from_numpy, BitplaneArray
        add, mul, relu = bbop_add, bbop_mul, bbop_relu
    with m.timed():
        pa, pb = bpa.from_values(arr(a), 8), bpa.from_values(arr(b), 8)
        s = add(pa, pb, 8)
        p = mul(s, pb, 8)
        q = relu(p.rebank(None).rebank(4), 8)
        out = np.asarray(q.to_values())
    with m.pipeline(timed=True, fused_trace=True) as pipe:
        x, y = pipe.load([a, b], 8)
        fused = np.asarray(pipe.store(relu(add(mul(x, y, 8), y, 8), 8)))
    return m, out, fused


@pytest.mark.parametrize("mode", ["analytic", "replay"])
def test_perfstats_snapshot_matches_reference(mode):
    ref, ref_out, ref_fused = _timed_chain("ref", mode)
    port, out, fused = _timed_chain("port", mode)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(fused, ref_fused)
    snap = port.stats.snapshot()
    assert snap == ref.stats.snapshot()
    assert snap["movement"]["per_kind"]["inter"]["n"] == 2
    assert snap["movement"]["per_kind"]["elided"]["n"] == 2
    if mode == "replay":
        assert snap["replay"]["ns"] >= snap["execute"]["ns"] > 0
    assert port.perf_report() == ref.perf_report()
