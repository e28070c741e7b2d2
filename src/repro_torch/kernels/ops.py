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

import threading
from typing import NamedTuple

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

# (trace fingerprint, device, operand plane counts, output widths) → the
# row-file plan; traces are few (the μProgram Memory holds a handful),
# FIFO-bounded anyway.  Misses build under the lock, hits read without it.
_PLANS: dict = {}
_PLANS_CAP = 256
_PLANS_LOCK = threading.Lock()


class _RowPlan(NamedTuple):
    """What a call of one trace indexes its row file with, on the device:
    the checked commands, each operand's (name, rows, bits), the C1 row,
    each output's (name, rows), and how many index lists that is."""
    cmds: torch.Tensor
    loads: tuple
    c1: int
    gathers: tuple
    lists: int


def _index(ids: list[int], device: torch.device):
    """A contiguous ascending run as a slice, else a device index tensor."""
    if ids == list(range(ids[0], ids[0] + len(ids))):
        return slice(ids[0], ids[0] + len(ids))
    return torch.tensor(ids, dtype=torch.int64, device=device)


def _build_plan(trace: LoweredTrace, device: torch.device,
                plane_counts: tuple, widths: tuple) -> _RowPlan:
    check_cmds(trace.cmds, trace.n_rows)
    cmds = torch.as_tensor(trace.cmds, dtype=torch.int32).contiguous() \
        .to(device)
    loads = []
    for name, n_planes in plane_counts:
        bits = [b for b in range(n_planes) if (name, b) in trace.row_index]
        if bits:
            rows = [trace.row_index[(name, b)] - 1 for b in bits]
            loads.append((name, _index(rows, device), _index(bits, device)))
    gathers = tuple(
        (name, torch.tensor(trace.out_row_ids(name, width),
                            dtype=torch.int64, device=device))
        for name, width in zip(trace.outputs, widths))
    telemetry.count("kernels.row_plans")
    return _RowPlan(cmds, tuple(loads), trace.row_index["C1"] - 1, gathers,
                    2 * len(loads) + len(gathers))


def _row_plan(trace: LoweredTrace, operands: dict[str, torch.Tensor],
              out_bits: dict[str, int]) -> _RowPlan:
    """The plan of ``trace`` for these operands' device and plane counts
    and these output widths, built on a miss.  The key leaves the row map
    out: :func:`~repro_torch.core.trace.lower_program`, the only maker of
    traces, derives it from the D rows the fingerprint hashes."""
    device = next(iter(operands.values())).device
    plane_counts = tuple((name, planes.shape[-2])
                         for name, planes in operands.items())
    widths = tuple(out_bits.get(name, trace.n_bits)
                   for name in trace.outputs)
    key = (trace.fingerprint, device, plane_counts, widths)
    plan = _PLANS.get(key)
    if plan is None:
        with _PLANS_LOCK:
            plan = _PLANS.get(key)
            if plan is None:
                plan = _PLANS[key] = _build_plan(trace, device, plane_counts,
                                                 widths)
                while len(_PLANS) > _PLANS_CAP:
                    del _PLANS[next(iter(_PLANS))]
    return plan


def run_trace_kernel(trace: LoweredTrace, operands: dict[str, torch.Tensor],
                     out_bits: dict[str, int] | None = None
                     ) -> dict[str, torch.Tensor]:
    """Execute a lowered command trace through the FSM kernel.

    operands: name → int32[n_bits, W] or int32[banks, n_bits, W] planes.
    What the row file is indexed with (the checked commands, an operand's
    rows and bits, an output's rows) is one plan a trace, device, operand
    plane counts and output widths, put on the device when it is built
    (``kernels.row_plans`` counts the builds, the only uploads of index
    lists) and reused: a call copies nothing from the host and does not
    synchronise.  Each index list a call uses counts in
    ``kernels.index_lists``.
    """
    with telemetry.span("kernels.run_trace"):
        plan = _row_plan(trace, operands, out_bits or {})
        with telemetry.span("kernels.row_file"):
            rows = _row_file(trace, operands, plan)
        with telemetry.span("kernels.k1"):
            final = uprog_execute(plan.cmds, rows, check=False)
        telemetry.count("kernels.index_lists", plan.lists)
        return {name: final.index_select(-2, ids)
                for name, ids in plan.gathers}


def _row_file(trace: LoweredTrace, operands: dict[str, torch.Tensor],
              plan: _RowPlan) -> torch.Tensor:
    """A zeroed row file with the operands' planes scattered into their
    rows and the C1 row set, as ``plan`` says."""
    first = next(iter(operands.values()))
    rows = torch.zeros((*first.shape[:-2], trace.n_rows, first.shape[-1]),
                       dtype=torch.int32, device=first.device)
    for name, dst, src in plan.loads:
        rows[..., dst, :] = operands[name][..., src, :]
    rows[..., plan.c1, :] = -1
    return rows


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
