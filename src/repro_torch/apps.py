"""The paper's application kernels (Fig. 11) on a port ``SimdramMachine``:
brightness (predication), BitWeaving scan (relational), an XNOR-NET binary
layer through the XNOR-popcount kernel, and masked darken through a
**user-defined operation** (``define_op``), the paper's Step-1-to-3 path
for ops the framework never shipped.

    python -m repro_torch.apps                  # on the card
    python -m repro_torch.apps --device cpu     # plain versions, on the CPU

Nothing is built at import: :func:`make_apps` builds the machine (its
μProgram Memory caches each compiled op across calls) and registers
``gated_sub`` on it.  Inputs and results are host arrays, as in the
reference's example; the work runs on the machine's device.  A machine
with ``banks > 1`` takes each input as ``[banks, lanes]`` passes, one bank
axis per op, with the lanes per pass capped at ``lanes`` when given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .core.graph import lit_not
from .core.uprogram import DRow
from .kernels.bitserial_matmul import bitserial_matmul, pack_signs
from .ops import (SimdramMachine, bbop_add, bbop_greater, bbop_greater_equal,
                  bbop_if_else)
from .simdram.layout import as_tensor


def _build_gated_sub(g):
    """Step 1 of ``gated_sub``: a − b where gate, a untouched elsewhere — the
    AOIG of one bit slice with a borrow carried between slices."""
    a, b, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
    bg = g.gate_and(b, gate)
    axb = g.gate_xor(a, bg)
    g.add_output("out", g.gate_xor(axb, w))
    g.add_output("borrow", g.gate_or_node(
        g.gate_and(lit_not(a), bg), g.gate_and(w, lit_not(axb))))


class SimdramApps:
    """The four application kernels on one machine (see :func:`make_apps`)."""

    def __init__(self, machine: SimdramMachine, lanes: int | None = None):
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.machine = machine
        self.lanes = lanes
        # masked darken: pixel − delta wherever mask, untouched elsewhere —
        # one in-DRAM pass of an op the framework never shipped (Steps 2–3
        # happen inside define_op / the machine's backend)
        self.gated_sub = machine.define_op(
            "gated_sub", _build_gated_sub,
            invariants={"gate": DRow("gate", 0, fixed=True)},
            states={"borrow": 0})

    # -- passes over the machine's banks -------------------------------------
    def _passes(self, x) -> list[torch.Tensor]:
        """Flattened int32 input on the machine's device, cut into passes:
        1-D on one bank, ``[banks, lanes]`` on several (zero-padded)."""
        flat = as_tensor(np.asarray(x).reshape(-1), self.machine.device) \
            .to(torch.int32)
        banks = self.machine.banks
        if banks == 1 and self.lanes is None:
            return [flat]
        e = flat.numel()
        lanes = self.lanes or max(1, -(-e // banks))
        per = banks * lanes
        padded = torch.nn.functional.pad(flat, (0, (-e) % per))
        return [p.reshape(banks, lanes) if banks > 1 else p
                for p in padded.split(per)]

    @staticmethod
    def _join(outs: list[torch.Tensor], n: int) -> torch.Tensor:
        return torch.cat([o.reshape(-1) for o in outs])[:n]

    # -- the kernels ---------------------------------------------------------
    def brightness(self, image, delta: int) -> np.ndarray:
        """image + delta, clamped to 255 (paper §D brightness kernel)."""
        outs = []
        with self.machine.session():
            for x in self._passes(image):
                raw = bbop_add(x, torch.full_like(x, delta), 8)
                ovf = bbop_greater(x, raw, 8)           # wraparound ⇒ clamp
                outs.append(bbop_if_else(ovf, torch.full_like(x, 255), raw,
                                         8))
        out = self._join(outs, np.size(image))
        return out.cpu().numpy().reshape(np.shape(image))

    def bitweaving_scan(self, values, lo: int, hi: int) -> int:
        """SELECT COUNT(*) WHERE lo <= v <= hi (paper's BitWeaving kernel)."""
        hits = []
        with self.machine.session():
            for v in self._passes(values):
                ge = bbop_greater_equal(v, torch.full_like(v, lo), 8)
                le = bbop_greater_equal(torch.full_like(v, hi), v, 8)
                hits.append(ge & le)
        return int(self._join(hits, np.size(values)).sum())

    def xnor_layer(self, x, w) -> np.ndarray:
        """Binary fully-connected layer: sign inputs × sign weights through
        the packed XNOR-popcount kernel (VGG/LeNet building block)."""
        device = self.machine.device
        xp = pack_signs(as_tensor(x, device))
        wp = pack_signs(as_tensor(w, device))
        return bitserial_matmul(xp, wp, x.shape[1]).cpu().numpy()

    def masked_darken(self, image, mask, delta: int) -> np.ndarray:
        """image − delta where mask (single fused user-op pass)."""
        outs = []
        for x, m in zip(self._passes(image), self._passes(mask)):
            outs.append(self.gated_sub(x, torch.full_like(x, delta), m,
                                       n_bits=8))
        out = self._join(outs, np.size(image))
        return out.cpu().numpy().reshape(np.shape(image))


def make_apps(device: str | torch.device = "cuda", banks: int = 1,
              lanes: int | None = None,
              backend: str | None = "unrolled") -> SimdramApps:
    """The applications on a new machine: ``backend="unrolled"`` with a
    32-entry μProgram Memory, as the reference's example builds it;
    ``backend=None`` follows the process default (``"kernel"``)."""
    machine = SimdramMachine(backend=backend, cache_capacity=32, banks=banks,
                             device=device)
    return SimdramApps(machine, lanes=lanes)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    apps = make_apps(args.device)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 16))
    bright = apps.brightness(img, 64)
    _check(np.array_equal(bright, np.minimum(img + 64, 255)), "brightness")
    print(f"brightness: {img[0, :6]} -> {bright[0, :6]}  OK")

    vals = rng.integers(0, 256, 4096)
    cnt = apps.bitweaving_scan(vals, 50, 180)
    _check(cnt == int(((vals >= 50) & (vals <= 180)).sum()), "bitweaving scan")
    print(f"bitweaving scan: {cnt}/4096 rows matched  OK")

    x = rng.choice([-1.0, 1.0], (128, 256)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], (128, 256)).astype(np.float32)
    y = apps.xnor_layer(x, w)
    _check(np.array_equal(y, (x @ w.T).astype(np.int32)), "xnor layer")
    print(f"xnor layer 128x256·256x128: max activation {y.max()}  OK")

    dark = apps.masked_darken(img, img > 128, 40)
    exp = np.where(img > 128, (img - 40) & 255, img)
    _check(np.array_equal(dark, exp), "masked darken")
    print(f"masked darken via user-defined gated_sub: "
          f"{img[0, :6]} -> {dark[0, :6]}  OK")
    st = apps.machine.cache_stats()
    print(f"machine μProgram Memory after all kernels: {st['entries']} "
          f"entries, hit rate {st['hit_rate']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
