"""Row-file plumbing around the kernels.

``run_trace_kernel`` is the end-to-end kernel path for any lowered command
trace (:class:`~repro_torch.core.trace.LoweredTrace`): build a row file (D
rows + C rows + B cells) straight from the trace's row-index map, run its
int32 command array through the FSM kernel, read the outputs back.  Banked
operands (``[banks, n_bits, W]``) build a banked row file that one kernel
launch covers.  ``run_uprogram_kernel`` keeps the μProgram-level entry
point by lowering first (memoized).  ``transpose_to_planes`` loads element
values through the transposition kernel.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..core.trace import LoweredTrace, lower_program
from ..core.uprogram import UProgram
from .bitplane_transpose import bitplane_transpose, from_planes, to_planes
from .bitserial_matmul import bitserial_matmul, pack_signs
from .uprog_executor import check_cmds, uprog_execute

__all__ = ["bitplane_transpose", "bitserial_matmul", "from_planes",
           "pack_signs", "run_trace_kernel", "run_uprogram_kernel",
           "to_planes", "transpose_to_planes"]

# (trace fingerprint, device) → device copy of the trace's checked commands;
# traces are few (the μProgram Memory holds a handful), FIFO-bounded anyway
_CMDS: dict = {}
_CMDS_CAP = 256


def _device_cmds(trace: LoweredTrace, device: torch.device) -> torch.Tensor:
    key = (trace.fingerprint, str(device))
    cmds = _CMDS.get(key)
    if cmds is None:
        check_cmds(trace.cmds, trace.n_rows)
        cmds = torch.as_tensor(trace.cmds, dtype=torch.int32).contiguous() \
            .to(device)
        _CMDS[key] = cmds
        while len(_CMDS) > _CMDS_CAP:
            del _CMDS[next(iter(_CMDS))]
    return cmds


def run_trace_kernel(trace: LoweredTrace, operands: dict[str, torch.Tensor],
                     out_bits: dict[str, int] | None = None
                     ) -> dict[str, torch.Tensor]:
    """Execute a lowered command trace through the FSM kernel.

    operands: name → int32[n_bits, W] or int32[banks, n_bits, W] planes.
    The trace's commands are checked once per fingerprint and device.
    Each host-built index list the row file is indexed with (an operand's
    rows and bits, an output's rows) counts in ``kernels.index_lists``:
    on a CUDA device each is one pageable host-to-device copy.
    """
    with telemetry.span("kernels.run_trace"):
        first = next(iter(operands.values()))
        with telemetry.span("kernels.row_file"):
            rows, lists = _row_file(trace, operands)
        with telemetry.span("kernels.k1"):
            final = uprog_execute(_device_cmds(trace, first.device), rows,
                                  check=False)
        out_bits = out_bits or {}
        telemetry.count("kernels.index_lists", lists + len(trace.outputs))
        return {name: final[..., trace.out_row_ids(
                    name, out_bits.get(name, trace.n_bits)), :]
                for name in trace.outputs}


def _row_file(trace: LoweredTrace, operands: dict[str, torch.Tensor]
              ) -> tuple[torch.Tensor, int]:
    """A zeroed row file with the operands' planes scattered into their
    rows and the C1 row set, and the number of index lists it took."""
    first = next(iter(operands.values()))
    lead = tuple(first.shape[:-2])
    words = first.shape[-1]
    lists = 0
    rows = torch.zeros((*lead, trace.n_rows, words), dtype=torch.int32,
                       device=first.device)
    for name, planes in operands.items():
        dst, src = [], []
        for bit in range(planes.shape[-2]):
            idx = trace.row_index.get((name, bit))
            if idx is not None:
                dst.append(idx - 1)
                src.append(bit)
        if dst:
            lists += 2
            rows[..., dst, :] = planes[..., src, :]
    rows[..., trace.row_index["C1"] - 1, :] = -1
    return rows, lists


def run_uprogram_kernel(prog: UProgram, operands: dict[str, torch.Tensor],
                        out_bits: dict[str, int] | None = None
                        ) -> dict[str, torch.Tensor]:
    """μProgram-level entry: lower (memoized), then run the trace kernel
    (the operands' device decides, as in :func:`run_trace_kernel`)."""
    return run_trace_kernel(lower_program(prog), operands, out_bits=out_bits)


def transpose_to_planes(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int[E] → int32[n_bits, E/32] via the transposition kernel (E a
    multiple of 32; callers pad)."""
    return to_planes(x.to(torch.int32), n_bits)
