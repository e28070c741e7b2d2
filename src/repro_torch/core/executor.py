"""Faithful μProgram executor over a modeled DRAM subarray (paper Step 3).

This is the *reference semantics* implementation: a numpy bit-plane subarray
with exact AAP/AP behavior, including

* destructive triple-row activation: after an AP, **all three** cells hold
  the majority (each through its own wordline polarity — a cell activated
  through its n-wordline both contributes its complement to the bitline and
  stores back the complement of the sensed value);
* dual-contact-cell port semantics for NOT;
* multi-row AAP destinations (coalesced copies);
* Case-2 coalesced AAPs whose *source* activation is itself a TRA.

Rows hold ``W`` SIMD lanes packed as uint64 words (W = row width in bits =
number of bitlines = SIMD lanes), mirroring the paper's 65 536-lane 8 kB row.

The executor also doubles as the command-sequence *counter* feeding the
timing/energy model — each AAP/AP is logged.
"""
from __future__ import annotations

import numpy as np

from .uprogram import AAP, AP, CRow, DRow, N_B_CELLS, Port, UProgram

WORD = 64


class Subarray:
    """A modeled SIMDRAM subarray: D-group operand arrays + C-group constants
    + the six B-group compute cells, all ``lanes`` bits wide."""

    def __init__(self, lanes: int, seed_garbage: int | None = 0xD1) -> None:
        if lanes % WORD:
            raise ValueError(f"lanes must be a multiple of {WORD}")
        self.lanes = lanes
        self.words = lanes // WORD
        self.d_rows: dict[tuple[str, int], np.ndarray] = {}
        # B-group cells power up with garbage (nothing may rely on it)
        rng = np.random.default_rng(seed_garbage)
        self.b_cells = [
            rng.integers(0, 1 << 63, size=self.words, dtype=np.uint64) << np.uint64(1)
            if seed_garbage is not None else np.zeros(self.words, np.uint64)
            for _ in range(N_B_CELLS)
        ]
        self.stats = {"AAP": 0, "AP": 0, "TRA": 0, "rows_activated": 0}

    # -- D-group access ------------------------------------------------------
    def write_operand(self, name: str, planes: np.ndarray) -> None:
        """planes: uint64[n_bits, words] — vertical layout (bit i in row i)."""
        planes = np.asarray(planes, dtype=np.uint64)
        for i in range(planes.shape[0]):
            self.d_rows[(name, i)] = planes[i].copy()

    def read_operand(self, name: str, n_bits: int) -> np.ndarray:
        return np.stack([self.d_rows[(name, i)] for i in range(n_bits)])

    def alloc_operand(self, name: str, n_bits: int) -> None:
        for i in range(n_bits):
            self.d_rows[(name, i)] = np.zeros(self.words, np.uint64)

    # -- row read/write through ports ---------------------------------------
    def _read(self, ref) -> np.ndarray:
        if isinstance(ref, Port):
            v = self.b_cells[ref.cell]
            return ~v if ref.neg else v
        if isinstance(ref, CRow):
            return (np.full(self.words, ~np.uint64(0)) if ref.one
                    else np.zeros(self.words, np.uint64))
        if isinstance(ref, DRow):
            row = self.d_rows.get((ref.array, ref.bit))
            if row is None:
                raise KeyError(f"read of unallocated D-row {ref}")
            return row
        raise TypeError(ref)

    def _write(self, ref, bitline: np.ndarray) -> None:
        if isinstance(ref, Port):
            self.b_cells[ref.cell] = ~bitline if ref.neg else bitline.copy()
        elif isinstance(ref, DRow):
            self.d_rows[(ref.array, ref.bit)] = bitline.copy()
        elif isinstance(ref, CRow):
            raise ValueError("C-group rows are read-only")
        else:
            raise TypeError(ref)

    # -- command sequences ----------------------------------------------------
    @staticmethod
    def _maj(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
        return (a & b) | (a & c) | (b & c)

    def _tra(self, ports) -> np.ndarray:
        """Perform the charge-sharing majority across three ports; write the
        sensed value back through every port (destructive)."""
        cells = {p.cell for p in ports}
        if len(cells) != 3:
            raise ValueError(f"TRA needs 3 distinct cells, got {ports}")
        vals = [self._read(p) for p in ports]
        bitline = self._maj(*vals)
        for p in ports:
            self._write(p, bitline)
        self.stats["TRA"] += 1
        self.stats["rows_activated"] += 3
        return bitline

    def execute(self, uop) -> None:
        if isinstance(uop, AP):
            self._tra(uop.ports)
            self.stats["AP"] += 1
        elif isinstance(uop, AAP):
            if isinstance(uop.src, tuple):       # Case-2 coalesced: ACT#1 is a TRA
                bitline = self._tra(uop.src)
            else:
                bitline = self._read(uop.src)
                self.stats["rows_activated"] += 1
            for d in uop.dsts:
                self._write(d, bitline)
            self.stats["AAP"] += 1
            self.stats["rows_activated"] += len(uop.dsts)
        else:
            raise TypeError(f"not a command-sequence μOp: {uop}")

    def run(self, prog: UProgram) -> None:
        for name in prog.scratch:
            self.alloc_operand(name, prog.n_bits + 1)
        for u in prog.flatten():
            self.execute(u)


def run_program(prog: UProgram, operands: dict[str, np.ndarray],
                lanes: int | None = None, out_bits: dict[str, int] | None = None,
                ) -> tuple[dict[str, np.ndarray], Subarray]:
    """Execute a compiled μProgram on the reference subarray.

    ``operands``: array name → 1-D numpy integer array (horizontal values).
    Returns (output planes per output array, subarray) — callers decode with
    :func:`from_planes`.
    """
    n = prog.n_bits
    first = next(iter(operands.values()))
    n_elems = len(first)
    lanes = lanes or ((n_elems + WORD - 1) // WORD) * WORD
    sa = Subarray(lanes)
    for name, vals in operands.items():
        sa.write_operand(name, to_planes(vals, n, lanes))
    # scratch + outputs: allocate zeroed D rows (a real system would μProgram
    # the zeroing; our compiled programs zero what they rely on explicitly)
    out_bits = out_bits or {}
    for name in prog.outputs:
        sa.alloc_operand(name, out_bits.get(name, n))
    for name in prog.scratch:
        sa.alloc_operand(name, out_bits.get(name, 2 * n + 2))
    for u in prog.flatten():
        # lazily allocate any referenced scratch rows (spills)
        for r in _uop_drows(u):
            if (r.array, r.bit) not in sa.d_rows:
                sa.d_rows[(r.array, r.bit)] = np.zeros(sa.words, np.uint64)
        sa.execute(u)
    outs = {name: sa.read_operand(name, out_bits.get(name, n))
            for name in prog.outputs}
    return outs, sa


def _uop_drows(u) -> list:
    rows = []
    if isinstance(u, AAP):
        if isinstance(u.src, DRow):
            rows.append(u.src)
        rows.extend(d for d in u.dsts if isinstance(d, DRow))
    return rows


# ---------------------------------------------------------------------------
# Vertical-layout helpers (numpy oracle side; the torch/CUDA versions live in
# repro_torch.simdram.layout / repro_torch.kernels)
# ---------------------------------------------------------------------------

def to_planes(values: np.ndarray, n_bits: int, lanes: int | None = None) -> np.ndarray:
    """Horizontal ints → vertical bit-planes uint64[n_bits, lanes/64].

    Element j's bit i lands in plane i, lane j (paper Fig. 4b)."""
    values = np.asarray(values)
    n = values.shape[0]
    lanes = lanes or ((n + WORD - 1) // WORD) * WORD
    assert lanes % WORD == 0 and lanes >= n
    u = values.astype(np.int64).astype(np.uint64)
    planes = np.zeros((n_bits, lanes // WORD), dtype=np.uint64)
    lane = np.arange(n)
    word, off = lane // WORD, np.uint64(1) << (lane % WORD).astype(np.uint64)
    for i in range(n_bits):
        bits = (u >> np.uint64(i)) & np.uint64(1)
        np.add.at(planes[i], word[bits == 1], off[bits == 1])
    return planes


def from_planes(planes: np.ndarray, n: int, signed: bool = False) -> np.ndarray:
    """Vertical bit-planes → horizontal ints (first ``n`` lanes)."""
    n_bits = planes.shape[0]
    lane = np.arange(n)
    word, sh = lane // WORD, (lane % WORD).astype(np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for i in range(n_bits):
        bits = (planes[i][word] >> sh) & np.uint64(1)
        out |= bits << np.uint64(i)
    if signed:
        sign = (out >> np.uint64(n_bits - 1)) & np.uint64(1)
        out = out.astype(np.int64) - (sign.astype(np.int64) << n_bits)
        return out
    return out.astype(np.int64)
