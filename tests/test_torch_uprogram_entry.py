"""The μProgram-level kernel entry of the port against the reference's.

``repro_torch.kernels.ops.run_uprogram_kernel`` lowers a μProgram (the
memoized ``lower_program``) and runs the FSM over a row file; on a CPU
tensor that is the FSM's plain version.  It is held bit for bit against
``repro.kernels.ops.run_uprogram_kernel(..., interpret=True)`` (the Pallas
kernel in interpret mode) on seeded plane words that cover every bit
pattern, unbanked and banked (the reference runs each bank alone).
``repro_torch.kernels.uprog_executor.encode_program`` must give the
reference's command stream for the same μProgram and row-index map.
(``tests/test_torch_kernels.py`` holds the entry on the card against its
CPU run.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.trace as ref_trace
import repro.kernels.ops as ref_kops
import repro.kernels.uprog_executor as ref_uprog
import repro_torch.core.trace as port_trace
import repro_torch.kernels.ops as port_kops
import repro_torch.kernels.uprog_executor as port_uprog

# op → (inputs and their plane counts, out_bits)
CASES = {"addition": ({"a": 8, "b": 8}, None),
         "greater": ({"a": 8, "b": 8}, {"out": 1}),
         "if_else": ({"a": 8, "b": 8, "sel": 1}, None)}


def planes(inputs: dict, lead: tuple, words: int, seed: int) -> dict:
    """name → seeded uint32[*lead, n_bits, words] plane words."""
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, 2**32, (*lead, n, words), dtype=np.uint32)
            for name, n in inputs.items()}


def ref_run(op: str, operands: dict, out_bits) -> dict:
    prog = ref_trace.compile_trace(op, 8)[0]
    outs = ref_kops.run_uprogram_kernel(
        prog, {k: jnp.asarray(v) for k, v in operands.items()},
        out_bits=out_bits, interpret=True)
    return {k: np.asarray(v) for k, v in outs.items()}


def port_run(op: str, operands: dict, out_bits) -> dict:
    prog = port_trace.compile_trace(op, 8)[0]
    outs = port_kops.run_uprogram_kernel(
        prog, {k: torch.from_numpy(v.view(np.int32)) for k, v in
               operands.items()}, out_bits=out_bits)
    for v in outs.values():
        assert v.dtype == torch.int32 and v.device.type == "cpu"
    return {k: v.numpy().view(np.uint32) for k, v in outs.items()}


@pytest.mark.parametrize("op", sorted(CASES))
def test_run_uprogram_kernel_matches_reference(op):
    inputs, out_bits = CASES[op]
    operands = planes(inputs, (), 5, seed=len(op))
    want = ref_run(op, operands, out_bits)
    got = port_run(op, operands, out_bits)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if out_bits:
        assert got["out"].shape == (1, 5)


@pytest.mark.parametrize("op", sorted(CASES))
def test_run_uprogram_kernel_banked_matches_reference_per_bank(op):
    inputs, out_bits = CASES[op]
    banks = 3
    operands = planes(inputs, (banks,), 4, seed=100 + len(op))
    got = port_run(op, operands, out_bits)
    for bank in range(banks):
        want = ref_run(op, {k: v[bank] for k, v in operands.items()},
                       out_bits)
        for name in want:
            np.testing.assert_array_equal(got[name][bank], want[name],
                                          err_msg=f"{name} bank {bank}")


def test_run_uprogram_kernel_is_the_lowered_trace_run():
    """The μProgram entry runs the memoized lowering of its program: the
    same planes as ``run_trace_kernel`` on that trace."""
    prog, trace = port_trace.compile_trace("addition", 8)
    assert port_trace.lower_program(prog) is trace
    operands = {k: torch.from_numpy(v.view(np.int32))
                for k, v in planes({"a": 8, "b": 8}, (2,), 3, 7).items()}
    got = port_kops.run_uprogram_kernel(prog, operands)
    want = port_kops.run_trace_kernel(trace, operands)
    assert torch.equal(got["out"], want["out"])


@pytest.mark.parametrize("op,n_bits", [("addition", 8), ("greater", 8),
                                       ("if_else", 8), ("multiplication", 4),
                                       ("relu", 16), ("division", 5)])
def test_encode_program_matches_reference(op, n_bits):
    rprog, rtrace = ref_trace.compile_trace(op, n_bits)
    pprog, ptrace = port_trace.compile_trace(op, n_bits)
    assert ptrace.row_index == rtrace.row_index
    want = np.asarray(ref_uprog.encode_program(rprog, rtrace.row_index))
    got = port_uprog.encode_program(pprog, ptrace.row_index, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.shape == want.shape and got.shape[1] == 4
    np.testing.assert_array_equal(got.numpy(), want)
    # the lowered trace carries the same stream
    np.testing.assert_array_equal(got.numpy(), ptrace.cmds)


