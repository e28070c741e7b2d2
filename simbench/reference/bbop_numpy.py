"""The SIMDRAM operations' values in plain NumPy.

Elements are ``n_bits``-bit unsigned words (arithmetic wraps modulo
``2**n_bits``); ``abs`` and ``relu`` read the top bit as the sign of a
two's-complement value.  Comparisons give one bit, ``bitcount`` gives
``n_bits.bit_length()`` bits, and division is unsigned, its quotient all
ones for a zero divisor (restoring division never borrows then).  The
reductions combine their three sources bitwise.
"""
from __future__ import annotations

import numpy as np


def out_bits(op: str, n_bits: int) -> int:
    if op in ("greater", "greater_equal", "equal"):
        return 1
    if op == "bitcount":
        return n_bits.bit_length()
    return n_bits


_BYTE_COUNTS = np.array([bin(i).count("1") for i in range(256)],
                        dtype=np.uint64)


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64 element, a byte at a time."""
    b = np.ascontiguousarray(x, dtype=np.uint64).view(np.uint8)
    return _BYTE_COUNTS[b].reshape(*x.shape, 8).sum(-1, dtype=np.uint64)


def expected(op: str, args: list[np.ndarray], n_bits: int) -> np.ndarray:
    """The values ``op`` gives on ``args`` (in the op's argument order),
    as uint64 below ``2**out_bits(op, n_bits)``."""
    mask = np.uint64((1 << n_bits) - 1)
    x = [np.asarray(a).astype(np.int64).astype(np.uint64) & mask
         for a in args]
    sign = np.uint64(1 << (n_bits - 1))
    if op == "addition":
        r = x[0] + x[1]
    elif op == "subtraction":
        r = x[0] - x[1]
    elif op == "multiplication":
        r = x[0] * x[1]
    elif op == "division":
        safe = np.where(x[1] == 0, np.uint64(1), x[1])
        r = np.where(x[1] == 0, mask, x[0] // safe)
    elif op == "abs":
        r = np.where(x[0] & sign, (~x[0] + np.uint64(1)), x[0])
    elif op == "relu":
        r = np.where(x[0] & sign, np.uint64(0), x[0])
    elif op == "bitcount":
        r = _popcount(x[0])
    elif op == "greater":
        r = (x[0] > x[1]).astype(np.uint64)
    elif op == "greater_equal":
        r = (x[0] >= x[1]).astype(np.uint64)
    elif op == "equal":
        r = (x[0] == x[1]).astype(np.uint64)
    elif op == "maximum":
        r = np.maximum(x[0], x[1])
    elif op == "minimum":
        r = np.minimum(x[0], x[1])
    elif op == "if_else":
        r = np.where(x[0] & np.uint64(1), x[1], x[2])
    elif op == "and_reduction":
        r = x[0] & x[1] & x[2]
    elif op == "or_reduction":
        r = x[0] | x[1] | x[2]
    elif op == "xor_reduction":
        r = x[0] ^ x[1] ^ x[2]
    else:
        raise ValueError(f"no reference for {op!r}")
    return r & np.uint64((1 << out_bits(op, n_bits)) - 1)


def mismatches(op: str, args: list[np.ndarray], got: np.ndarray,
               n_bits: int) -> int:
    """Elements of ``got`` (the program's values, any integer dtype) that
    differ from :func:`expected` in the result's bits."""
    want = expected(op, args, n_bits)
    keep = np.uint64((1 << out_bits(op, n_bits)) - 1)
    have = np.asarray(got).astype(np.int64).astype(np.uint64) & keep
    return int((have != want).sum())
