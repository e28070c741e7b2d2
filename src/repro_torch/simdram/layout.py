"""Vertical ⇄ horizontal data layout (paper §3.3, §5.1) — torch side.

The transposition unit of the paper converts between the CPU's horizontal
layout and SIMDRAM's vertical (bit-plane) layout: a horizontally-laid-out
integer tensor becomes ``int32[n_bits, lanes/32]`` where plane *i*, lane
*j* holds bit *i* of element *j*.  Plane words are ``torch.int32``,
bit-identical to the reference's uint32 words.

On a CUDA tensor both directions run the hand-written transposition kernel
(:mod:`repro_torch.kernels.bitplane_transpose`); on a CPU tensor they run
its plain PyTorch version.

Plane-resident values.  :class:`BitplaneArray` wraps planes together with
their element width / logical length / signedness so chained ``bbop_*``
operations can stay vertical end-to-end (paper Steps 1–3 keep operands in
the subarray; the transposition unit is only paid at the memory boundary).
Every trace-level layout conversion is counted in the telemetry
registry's ``layout.to_planes``/``layout.from_planes`` counters, read
through :data:`TRANSPOSE_STATS`, so tests and benchmarks can assert how
often the transposition unit ran.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .. import telemetry
from ..kernels.bitplane_transpose import from_planes, to_planes

LANE_WORD = 32  # lanes packed per int32 plane word

# trace-level transposition-unit accounting: one count per to/from pass
# (a vectorized pass over stacked operands counts once, like the hardware
# streaming a block through the transposition unit), kept in the telemetry
# registry; TRANSPOSE_STATS reads it under the reference's keys
_PASS_COUNTERS = {"to_bitplanes": "layout.to_planes",
                  "from_bitplanes": "layout.from_planes"}


class _TransposeStats(Mapping):
    """The registry's two ``layout.*`` counters as a read-only mapping."""

    def __getitem__(self, key: str) -> int:
        return telemetry.counter(_PASS_COUNTERS[key])

    def __iter__(self):
        return iter(_PASS_COUNTERS)

    def __len__(self) -> int:
        return len(_PASS_COUNTERS)

    def __repr__(self) -> str:
        return repr(dict(self))


TRANSPOSE_STATS = _TransposeStats()

# perf-instrumentation hooks, called as hook(kind, n_bits, lanes) on every
# transposition-unit pass; the timed execution layer in repro_torch.core.backends
# registers here so passes charge their TranspositionModel cost to the
# active PerfStats (empty unless that module has been imported)
_PERF_HOOKS: list = []


def register_transpose_hook(hook) -> None:
    """Register ``hook(kind: str, n_bits: int, lanes: int)`` to observe every
    transposition-unit pass (``kind`` is "to" or "from").

    These module-level hooks are process-wide plumbing: the timed execution
    layer and the machine layer each register exactly one forwarder here.
    For observation scoped to a single session, prefer
    ``SimdramMachine.register_transpose_hook`` — those fire only for
    passes inside that machine's scope.
    """
    if hook not in _PERF_HOOKS:
        _PERF_HOOKS.append(hook)


def unregister_transpose_hook(hook) -> None:
    """Remove a previously-registered transposition hook (no-op if absent)."""
    if hook in _PERF_HOOKS:
        _PERF_HOOKS.remove(hook)


# in-DRAM data-movement hooks, called as hook(kind, n_rows, banks) whenever
# rows physically relocate ("intra" = LISA inter-subarray hop inside one
# bank, "inter" = RowClone PSM transfer over the internal bus between
# banks); ``banks`` names the destination bank count of a scatter (None for
# gathers and intra-bank hops).  The timed execution layer registers here
# so relocations charge the active PerfStats through its MovementModel and
# — because a scatter's rows ride the shared internal bus serially — so a
# replay-mode accumulator can derive the per-bank data-arrival skew that
# desynchronizes the next op's command streams.
_MOVE_HOOKS: list = []


def register_movement_hook(hook) -> None:
    """Register ``hook(kind: str, n_rows: int, banks: int | None, planes)``
    to observe in-DRAM row relocations (``kind`` is "intra" or "inter";
    ``banks`` is the destination bank count of an inter-bank scatter and
    ``planes`` the scattered plane array — both None for gathers and
    intra-bank hops).  Scoped per-session observation goes through
    ``SimdramMachine.register_movement_hook`` instead."""
    if hook not in _MOVE_HOOKS:
        _MOVE_HOOKS.append(hook)


def unregister_movement_hook(hook) -> None:
    """Remove a previously-registered movement hook (no-op if absent)."""
    if hook in _MOVE_HOOKS:
        _MOVE_HOOKS.remove(hook)


def _fire_movement(kind: str, n_rows: int, banks: int | None = None,
                   planes=None) -> None:
    for hook in _MOVE_HOOKS:
        hook(kind, n_rows, banks, planes)


def note_elided_movement(n_rows: int, banks: int | None = None) -> None:
    """Report an inter-op row relocation that cross-op trace fusion made
    unnecessary: the fused chain's allocator placed a producer's output
    rows where the consumer wants its input, so the LISA hop the unfused
    pipeline would pay never happens.  Fires the movement hooks with
    ``kind="elided"`` — observers count it (so fused-vs-unfused hop deltas
    are provable from one snapshot) but charge nothing."""
    _fire_movement("elided", n_rows, banks)


def reset_transpose_stats() -> None:
    telemetry.reset(*_PASS_COUNTERS.values())


def transpose_counts() -> tuple[int, int]:
    """(to_bitplanes passes, from_bitplanes passes) since the last reset."""
    return (TRANSPOSE_STATS["to_bitplanes"], TRANSPOSE_STATS["from_bitplanes"])


def as_tensor(x, device) -> torch.Tensor:
    """Horizontal operand (tensor, numpy array, sequence) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def to_bitplanes(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int tensor (E,) → int32[n_bits, E/32] vertical bit-planes.

    E must be a multiple of 32.  Element j's bit i lands in plane i, word
    j//32, bit j%32.  Values wrap to their low 32 bits first.
    """
    (e,) = values.shape
    if e % LANE_WORD:
        raise ValueError("lane count must be a multiple of 32")
    with telemetry.span("layout.to_planes"):
        telemetry.count("layout.to_planes")
        for hook in _PERF_HOOKS:
            hook("to", n_bits, e)
        return to_planes(values.to(torch.int32), n_bits)


def from_bitplanes(planes: torch.Tensor, signed: bool = False,
                   dtype=torch.int32) -> torch.Tensor:
    """int32[n_bits, W] → int tensor (32·W,).

    ``signed`` sign-extends from bit n_bits−1 (n_bits < 32).  A wider
    ``dtype`` sees the unsigned value otherwise, as the reference's uint32
    accumulator gives it."""
    with telemetry.span("layout.from_planes"):
        telemetry.count("layout.from_planes")
        n_bits, w = planes.shape
        for hook in _PERF_HOOKS:
            hook("from", n_bits, w * LANE_WORD)
        val = from_planes(planes, signed=signed)
        if dtype == torch.int32:
            return val
        wide = val.to(torch.int64)
        if not (signed and n_bits < 32):
            wide = wide & 0xFFFFFFFF
        return wide.to(dtype)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool (E,) → int32[E/32] single packed plane."""
    return to_bitplanes(mask.to(torch.int32), 1)[0]


def unpack_mask(plane: torch.Tensor) -> torch.Tensor:
    (w,) = plane.shape
    shifts = torch.arange(LANE_WORD, dtype=torch.int32, device=plane.device)
    return (((plane[:, None] >> shifts) & 1) != 0).reshape(w * LANE_WORD)


def _logical_shr(p: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words (torch's ``>>`` is arithmetic)."""
    return (p >> k) & ((1 << (32 - k)) - 1)


# -- plane-resident arrays ---------------------------------------------------


@dataclasses.dataclass
class BitplaneArray:
    """A value living in SIMDRAM's vertical layout.

    ``planes`` is ``int32[n_bits, W]`` (single subarray) or
    ``int32[banks, n_bits, W]`` (one subarray per bank — the paper's
    16-bank scaling; the FSM kernel folds the bank axis into its word
    axis).  ``length`` is the logical element count per bank (lanes beyond
    it are padding).
    """

    planes: torch.Tensor
    n_bits: int
    length: int
    signed: bool = False

    @property
    def banked(self) -> bool:
        return self.planes.dim() == 3

    @property
    def n_banks(self) -> int:
        return self.planes.shape[0] if self.banked else 1

    @property
    def words(self) -> int:
        return self.planes.shape[-1]

    # -- memory-boundary conversions (each is ONE transposition-unit pass) --
    @classmethod
    def from_values(cls, values: torch.Tensor, n_bits: int,
                    signed: bool = False) -> "BitplaneArray":
        """Horizontal ints (E,) or (banks, E) → plane-resident array.

        Banked inputs are transposed in a single vectorized pass: banks are
        concatenated along the lane axis (lane padding keeps each bank
        word-aligned), exactly one streaming pass through the transposition
        unit.
        """
        banked = values.dim() == 2
        e = values.shape[-1]
        pad = (-e) % LANE_WORD
        if pad:
            values = torch.nn.functional.pad(values, (0, pad))
        if banked:
            banks = values.shape[0]
            planes = to_bitplanes(values.reshape(-1), n_bits)
            w = planes.shape[1] // banks
            planes = planes.reshape(n_bits, banks, w).transpose(0, 1) \
                .contiguous()
        else:
            planes = to_bitplanes(values, n_bits)
        return cls(planes, n_bits, e, signed)

    def to_values(self, dtype=torch.int32) -> torch.Tensor:
        """Plane-resident → horizontal ints (E,) or (banks, E) — one pass."""
        if self.banked:
            banks, n_bits, w = self.planes.shape
            flat = self.planes.transpose(0, 1).reshape(n_bits, banks * w)
            vals = from_bitplanes(flat, signed=self.signed, dtype=dtype)
            return vals.reshape(banks, w * LANE_WORD)[:, :self.length]
        return from_bitplanes(self.planes, signed=self.signed,
                              dtype=dtype)[:self.length]

    # -- cheap plane-level rewrites (no transposition-unit traffic) ---------
    def flip_msb(self) -> "BitplaneArray":
        """Invert the sign plane (unsigned-compare bias trick) — a single
        row operation, no layout conversion."""
        planes = self.planes.clone()
        planes[..., self.n_bits - 1, :] = ~planes[..., self.n_bits - 1, :]
        return dataclasses.replace(self, planes=planes)

    def split_lanes(self) -> tuple["BitplaneArray", "BitplaneArray"]:
        """Split the lane axis in half (word-aligned): (lo, hi) halves.

        Lane re-indexing only — no transposition-unit traffic.  Requires an
        even word count and a fully-padded array (length == lanes), which
        tournament-style reductions maintain by construction.
        """
        w = self.words
        if w % 2:
            raise ValueError("lane split needs an even word count")
        half_lanes = (w // 2) * LANE_WORD
        lo = dataclasses.replace(self, planes=self.planes[..., :w // 2],
                                 length=min(self.length, half_lanes))
        hi = dataclasses.replace(self, planes=self.planes[..., w // 2:],
                                 length=min(self.length, half_lanes))
        return lo, hi

    def shift_lanes(self, k: int) -> "BitplaneArray":
        """Shift the lane axis down by ``k`` (lane ``j`` ← lane ``j + k``),
        zero-filling the vacated top lanes — free plane-level word shifts,
        no transposition-unit traffic.

        Lane ``j`` of a plane is bit ``j % 32`` of word ``j // 32``, so a
        sub-word shift is one logical right-shift per word plus an OR of
        the carry bits from the next word.  This is the SWAR step of
        tournament reductions: compare an array against its ``k``-shifted
        self and the low ``k`` lanes accumulate pairwise winners, all the
        way down to lane 0 — no host epilogue.  ``length`` is unchanged
        (the shifted-in lanes are genuine zero values), matching the
        fully-padded layout tournament pipelines maintain.
        """
        if not 0 < k < LANE_WORD:
            raise ValueError(f"lane shift must be in [1, {LANE_WORD - 1}], "
                             f"got {k}")
        p = self.planes
        carry = torch.cat([p[..., 1:], torch.zeros_like(p[..., :1])], dim=-1)
        planes = _logical_shr(p, k) | (carry << (LANE_WORD - k))
        return dataclasses.replace(self, planes=planes)

    def rebank(self, banks: int | None) -> "BitplaneArray":
        """Redistribute the lane axis across DRAM banks (or gather it back).

        ``rebank(k)`` scatters an unbanked array's lanes over ``k`` banks;
        ``rebank(None)``/``rebank(1)`` gathers a banked array back into one
        subarray.  Unlike the free plane-level rewrites above, this is real
        in-DRAM traffic: every plane of every redistributed bank crosses the
        internal bus as a RowClone PSM row transfer, so the movement hooks
        fire with ``kind="inter"`` (× ``n_bits × banks`` rows) and a timed
        scope charges ``MovementModel.inter_bank_ns``.  Requires a fully
        padded array (``length == lanes``), which pipelines maintain at
        word-aligned bank boundaries.
        """
        if banks in (None, 0, 1):
            if not self.banked:
                return self
            # gather: each bank's plane stack rides the bus once
            nb, n_bits, w = self.planes.shape
            flat = self.planes.transpose(0, 1).reshape(n_bits, nb * w)
            _fire_movement("inter", n_bits * nb)
            return BitplaneArray(flat, self.n_bits, nb * w * LANE_WORD,
                                 self.signed)
        if self.banked:
            if banks == self.n_banks:
                return self
            return self.rebank(None).rebank(banks)
        if self.length != self.words * LANE_WORD:
            raise ValueError(
                f"rebank needs a fully padded array (length {self.length} "
                f"!= {self.words * LANE_WORD} lanes)")
        if self.words % banks:
            raise ValueError(f"{self.words} words do not split over "
                             f"{banks} banks")
        w = self.words // banks
        planes = self.planes.reshape(self.n_bits, banks, w).transpose(0, 1) \
            .contiguous()
        # a scatter serializes each destination bank's plane stack over the
        # shared internal bus, so later banks receive their data later —
        # passing the scattered ``planes`` lets a replay-mode PerfStats
        # record that per-bank arrival skew keyed to this array, so the op
        # that actually consumes it replays at those issue offsets
        _fire_movement("inter", self.n_bits * banks, banks, planes)
        return BitplaneArray(planes, self.n_bits, w * LANE_WORD, self.signed)

    def astype_bits(self, n_bits: int) -> "BitplaneArray":
        """Zero-extend or truncate the plane stack (free row re-indexing)."""
        if n_bits == self.n_bits:
            return self
        axis = 1 if self.banked else 0
        cur = self.planes.shape[axis]
        if n_bits < cur:
            planes = (self.planes[:, :n_bits] if self.banked
                      else self.planes[:n_bits])
        else:
            shape = list(self.planes.shape)
            shape[axis] = n_bits - cur
            planes = torch.cat([self.planes, self.planes.new_zeros(shape)],
                               dim=axis)
        return dataclasses.replace(self, planes=planes, n_bits=n_bits)


# -- numpy twin used by the reference executor ------------------------------

def np_to_bitplanes(values: np.ndarray, n_bits: int) -> np.ndarray:
    e = values.shape[0]
    assert e % LANE_WORD == 0
    u = values.astype(np.uint32)
    bits = (u[None, :] >> np.arange(n_bits, dtype=np.uint32)[:, None]) & 1
    bits = bits.reshape(n_bits, e // LANE_WORD, LANE_WORD)
    return (bits << np.arange(LANE_WORD, dtype=np.uint32)).sum(-1).astype(np.uint32)


def np_from_bitplanes(planes: np.ndarray) -> np.ndarray:
    n_bits, w = planes.shape
    shifts = np.arange(LANE_WORD, dtype=np.uint32)
    bits = ((planes[:, :, None] >> shifts) & 1).reshape(n_bits, w * LANE_WORD)
    return (bits.astype(np.uint64) << np.arange(n_bits, dtype=np.uint64)[:, None]).sum(0)
