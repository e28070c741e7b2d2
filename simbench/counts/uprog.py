"""Operations and bytes of a bbop, from its μProgram's command stream and
the operand shapes.

K1 runs an encoded command stream ``int32[N, 4]`` (``op, a, b, c``; op 1 is
a MAJ over rows ``|a|, |b|, |c|``, op 0 a COPY of row ``|b|`` into ``|a|``,
a negative row its complement) over a row file of ``n_rows`` rows of plane
words.  One word column needs one 3-input logic operation per MAJ, one NOT
more where a MAJ touches a complement, and one NOT per COPY whose ends
differ in polarity; a plain COPY is a rename and costs nothing.  The row
file is read once and written once.  K2 reads the horizontal int32 values
once and writes their planes once (or the reverse), one operation an
element a plane.  Each count is the least the work needs, whatever runs it.
"""
from __future__ import annotations

import numpy as np

LANE_WORD = 32          # lanes in one int32 plane word
VALUE_BYTES = 4         # a horizontal element is an int32


def fsm_ops_per_word(cmds) -> int:
    """Integer operations one word column needs for a command stream."""
    c = np.asarray(cmds)
    op, a, b, cc = (c[:, i] for i in range(4))
    maj = op == 1
    return int(maj.sum() + (maj & ((a < 0) | (b < 0) | (cc < 0))).sum()
               + (~maj & ((a < 0) != (b < 0))).sum())


def bound_s(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time for ``ops`` integer operations and ``nbytes`` bytes:
    the larger of the two over their peaks."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["int32_ops_per_s"])


def k1_work(cmds, n_rows: int, elements: int) -> tuple[int, int]:
    """(operations, bytes) of one K1 launch over ``elements`` lanes."""
    words = elements // LANE_WORD
    ops = fsm_ops_per_word(cmds) * words
    nbytes = 2 * n_rows * words * 4 + np.asarray(cmds).size * 4
    return ops, nbytes


def k2_work(n_bits: int, elements: int) -> tuple[int, int]:
    """(operations, bytes) of one transposition pass of ``n_bits`` planes."""
    return n_bits * elements, elements * VALUE_BYTES + n_bits * elements // 8


def op_bounds(cmds, n_rows: int, in_bits, out_bits: int, elements: int,
              peaks: dict) -> dict:
    """Least seconds of one bbop over ``elements`` lanes whose horizontal
    operands have ``in_bits`` planes each and whose result has
    ``out_bits``: ``k1`` (its K1 launch), ``k2`` (its transposition passes,
    each bounded alone) and ``op`` (the whole operation: its μProgram's
    operations, its operands read once and its result written once)."""
    k1_ops, k1_bytes = k1_work(cmds, n_rows, elements)
    k2 = sum(bound_s(*k2_work(b, elements), peaks)
             for b in (*in_bits, out_bits))
    op_bytes = (len(in_bits) + 1) * elements * VALUE_BYTES
    return {"k1": bound_s(k1_ops, k1_bytes, peaks), "k2": k2,
            "op": bound_s(k1_ops, op_bytes, peaks)}
