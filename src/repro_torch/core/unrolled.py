"""Unrolled μProgram execution: eager bitwise torch over plane words.

The faithful executor (``repro_torch.core.executor``) models every AAP/AP
against a stateful subarray, and the ``kernel`` backend runs the encoded
command stream through the FSM kernel.  Here the same μProgram is unrolled
in Python into plain bitwise torch ops over int32 plane words, on whatever
device the planes live on:

* an AAP (RowClone copy) aliases the value — no copy;
* an AP (TRA majority) becomes ``(a&b)|(a&c)|(b&c)``;
* dual-contact-cell reads and writes become ``~x``; C1 is ``-1``.

Operands are ``int32[n_bits, W]`` or banked ``int32[banks, n_bits, W]``: a
row is ``[W]`` or ``[banks, W]``, so the bank axis rides along in every op
and one pass covers every bank.
"""
from __future__ import annotations

import torch

from .uprogram import AAP, AP, CRow, DRow, Port, UProgram


def _maj(a, b, c):
    return (a & b) | (a & c) | (b & c)


def _row_shape(operands: dict[str, torch.Tensor]) -> tuple[tuple, torch.device]:
    """Shape of one row (leading bank axis kept) and the operands' device."""
    first = next(iter(operands.values()))
    return (*first.shape[:-2], first.shape[-1]), first.device


class _Env:
    """Value environment: D rows (by (array,bit)) + B cells.  Values are
    int32 rows; nothing is ever written in place, so aliases are safe."""

    def __init__(self, operands: dict[str, torch.Tensor]) -> None:
        shape, device = _row_shape(operands)
        self.zero = torch.zeros(shape, dtype=torch.int32, device=device)
        self.one = torch.full(shape, -1, dtype=torch.int32, device=device)
        self.d: dict[tuple[str, int], torch.Tensor] = {}
        self.cells: list = [self.zero] * 6
        for name, planes in operands.items():
            for i in range(planes.shape[-2]):
                self.d[(name, i)] = planes[..., i, :]

    def read(self, ref):
        if isinstance(ref, Port):
            v = self.cells[ref.cell]
            return ~v if ref.neg else v
        if isinstance(ref, CRow):
            return self.one if ref.one else self.zero
        if isinstance(ref, DRow):
            return self.d.get((ref.array, ref.bit), self.zero)
        raise TypeError(ref)

    def write(self, ref, val) -> None:
        if isinstance(ref, Port):
            self.cells[ref.cell] = ~val if ref.neg else val
        elif isinstance(ref, DRow):
            self.d[(ref.array, ref.bit)] = val
        else:
            raise TypeError(ref)


def run_trace_unrolled(trace, operands: dict[str, torch.Tensor],
                       out_bits: dict[str, int] | None = None,
                       ) -> dict[str, torch.Tensor]:
    """Execute a :class:`~repro_torch.core.trace.LoweredTrace` by walking
    its command array — the registered ``unrolled`` backend.

    Semantically identical to :func:`run_unrolled` on the source μProgram
    (COPY commands alias values, MAJ commands become bitwise majority,
    negative row operands read/write complements through DCC ports), but
    consumes the same lowered IR as the ``kernel`` FSM and the
    ``reference`` decoder.
    """
    shape, device = _row_shape(operands)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    rows: list = [zero] * trace.n_rows
    for key in trace.d_rows:
        arr, bit = key
        if arr in operands and bit < operands[arr].shape[-2]:
            rows[trace.row_index[key] - 1] = operands[arr][..., bit, :]
    rows[trace.row_index["C1"] - 1] = torch.full(shape, -1, dtype=torch.int32,
                                                 device=device)

    def read(i: int):
        return ~rows[-i - 1] if i < 0 else rows[i - 1]

    def write(i: int, val) -> None:
        if i < 0:
            rows[-i - 1] = ~val
        else:
            rows[i - 1] = val

    for op, a, b, c in trace.cmds.tolist():
        if op == 1:                      # MAJ (AP / fused-AAP first activate)
            res = _maj(read(a), read(b), read(c))
            write(a, res)
            write(b, res)
            write(c, res)
        else:                            # COPY (one AAP destination)
            write(a, read(b))
    out_bits = out_bits or {}
    outs = {}
    for name in trace.outputs:
        nb = out_bits.get(name, trace.n_bits)
        outs[name] = torch.stack([rows[i] for i in trace.out_row_ids(name, nb)],
                                 dim=-2)
    return outs


def run_unrolled(prog: UProgram, operands: dict[str, torch.Tensor],
                 out_bits: dict[str, int] | None = None,
                 ) -> dict[str, torch.Tensor]:
    """Execute a μProgram over int32 bit-plane operands.

    operands: array name → int32[n_bits, W] (or [banks, n_bits, W]).
    Returns: output array name → int32[out_bits, W] (banked likewise).
    """
    env = _Env(operands)
    for u in prog.flatten():
        if isinstance(u, AP):
            vals = [env.read(p) for p in u.ports]
            res = _maj(*vals)
            for p in u.ports:
                env.write(p, res)
        elif isinstance(u, AAP):
            if isinstance(u.src, tuple):
                vals = [env.read(p) for p in u.src]
                bit = _maj(*vals)
                for p in u.src:
                    env.write(p, bit)
            else:
                bit = env.read(u.src)
            for d in u.dsts:
                env.write(d, bit)
        else:
            raise TypeError(u)
    out_bits = out_bits or {}
    outs = {}
    for name in prog.outputs:
        nb = out_bits.get(name, prog.n_bits)
        outs[name] = torch.stack([env.d.get((name, i), env.zero)
                                  for i in range(nb)], dim=-2)
    return outs
