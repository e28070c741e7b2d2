"""Sweep every registered operation × bit width through TraceLint.

    PYTHONPATH=src python -m repro_torch.tools.tracelint [--bits 4,8,16,32]
                                                   [--ops add,mul,...]
                                                   [--optimize on|off|both]
                                                   [--chains]

Compiles each (operation, n_bits, optimize) key, runs the static verifier
(:mod:`repro_torch.core.tracelint`) on the lowered trace and prints one line per
key; any lint *error* (or a compile failure) fails the sweep with a
non-zero exit.  This is the CI lint gate over the op registry — the same
checks ``compile_trace(..., verify=True)`` applies inline, but exhaustively
and with the full report rendered.

``--chains`` additionally sweeps a set of representative fused chain
traces (:func:`repro_torch.core.compiler.fuse_chain`) through the same verifier
— including the fused-only cross-op seam checks (``seam-clobber``).
"""
from __future__ import annotations

import argparse
import sys
import time

DEFAULT_BITS = (4, 8, 16, 32)


def sweep(ops: tuple[str, ...], bits: tuple[int, ...],
          optimizes: tuple[bool, ...], verbose: bool = False) -> int:
    """Lint every (op, n_bits, optimize) key; returns the number of keys
    with lint errors or compile failures."""
    from ..core.trace import compile_trace

    failed = 0
    n_warn = 0
    t0 = time.perf_counter()
    for name in ops:
        for n_bits in bits:
            for optimize in optimizes:
                key = f"{name}/{n_bits}b" + ("" if optimize else "/ambit")
                try:
                    # verify=False: collect the full report ourselves
                    # instead of stopping at the first TraceLintError
                    _, trace = compile_trace(name, n_bits, optimize,
                                             verify=False)
                except Exception as e:  # noqa: BLE001 — report and continue
                    print(f"FAIL  {key}: compile error: {e}")
                    failed += 1
                    continue
                report = trace.lint()
                n_warn += len(report.warnings)
                if not report.ok:
                    failed += 1
                    print(f"FAIL  {key}")
                    print("      " + report.render().replace("\n", "\n      "))
                elif report.warnings and verbose:
                    print(f"warn  {key}")
                    print("      " + report.render().replace("\n", "\n      "))
                elif verbose:
                    print(f"ok    {key}  ({trace.cmds.shape[0]} cmds, "
                          f"{trace.n_rows} rows)")
    dt = time.perf_counter() - t0
    n_keys = len(ops) * len(bits) * len(optimizes)
    print(f"tracelint: {n_keys} trace(s) checked in {dt:.1f}s — "
          f"{failed} failing, {n_warn} warning(s)")
    return failed


# representative fused pipelines: linear chains, a diamond (one producer
# feeding two consumers), reductions into arithmetic, and a long 8-op mix
CHAIN_CASES: dict[str, tuple] = {
    "fma": (("addition", ("a", "b"), "t0"),
            ("multiplication", ("t0", "a"), "t1")),
    "fma_relu": (("addition", ("a", "b"), "t0"),
                 ("multiplication", ("t0", "a"), "t1"),
                 ("relu", ("t1",), "t2")),
    "diamond": (("addition", ("a", "b"), "t0"),
                ("relu", ("t0",), "t1"),
                ("abs", ("t0",), "t2"),
                ("subtraction", ("t1", "t2"), "t3")),
    "minmax": (("maximum", ("a", "b"), "hi"),
               ("minimum", ("a", "b"), "lo"),
               ("subtraction", ("hi", "lo"), "range")),
    "xor_acc": (("xor_reduction", ("a", "b", "c"), "t0"),
                ("addition", ("t0", "a"), "t1")),
    "chain8": (("addition", ("a", "b"), "t0"),
               ("multiplication", ("t0", "a"), "t1"),
               ("subtraction", ("t1", "b"), "t2"),
               ("relu", ("t2",), "t3"),
               ("addition", ("t3", "a"), "t4"),
               ("abs", ("t4",), "t5"),
               ("subtraction", ("t5", "b"), "t6"),
               ("relu", ("t6",), "t7")),
}


def sweep_chains(bits: tuple[int, ...], optimizes: tuple[bool, ...],
                 verbose: bool = False) -> int:
    """Lint every representative fused chain × bit width; returns the
    number of keys with lint errors or compile failures."""
    from ..core.compiler import fuse_chain

    failed = 0
    n_warn = 0
    t0 = time.perf_counter()
    for cname, stages in CHAIN_CASES.items():
        for n_bits in bits:
            for optimize in optimizes:
                key = (f"chain:{cname}/{n_bits}b"
                       + ("" if optimize else "/ambit"))
                try:
                    trace = fuse_chain(stages, n_bits, optimize)
                except Exception as e:  # noqa: BLE001 — report and continue
                    print(f"FAIL  {key}: compile error: {e}")
                    failed += 1
                    continue
                report = trace.lint()
                n_warn += len(report.warnings)
                if not report.ok:
                    failed += 1
                    print(f"FAIL  {key}")
                    print("      " + report.render().replace("\n", "\n      "))
                elif verbose:
                    ch = trace.chain
                    print(f"ok    {key}  ({trace.cmds.shape[0]} cmds, "
                          f"{ch.n_stages} stages, "
                          f"{ch.elided_rows} rows elided)")
    dt = time.perf_counter() - t0
    n_keys = len(CHAIN_CASES) * len(bits) * len(optimizes)
    print(f"tracelint --chains: {n_keys} fused trace(s) checked in "
          f"{dt:.1f}s — {failed} failing, {n_warn} warning(s)")
    return failed


def main(argv: list[str] | None = None) -> int:
    from ..core.circuits import list_operations

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.tracelint",
        description="statically verify registered ops' lowered traces")
    ap.add_argument("--ops", default=None,
                    help="comma-separated op names (default: every "
                         "registered operation)")
    ap.add_argument("--bits", default=",".join(map(str, DEFAULT_BITS)),
                    help="comma-separated element widths (default: "
                         "%(default)s)")
    ap.add_argument("--optimize", choices=("on", "off", "both"),
                    default="on",
                    help="MIG optimization: on (default), off (the Ambit "
                         "baseline lowering) or both")
    ap.add_argument("--chains", action="store_true",
                    help="also lint representative fused chain traces "
                         "(cross-op seam checks)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-key ok lines and warning reports")
    args = ap.parse_args(argv)

    ops = (tuple(s for s in args.ops.split(",") if s) if args.ops
           else list_operations())
    unknown = set(ops) - set(list_operations())
    if unknown:
        ap.error(f"unknown op(s) {sorted(unknown)}; registered: "
                 f"{list_operations()}")
    bits = tuple(int(b) for b in args.bits.split(",") if b)
    optimizes = {"on": (True,), "off": (False,),
                 "both": (True, False)}[args.optimize]
    failed = sweep(ops, bits, optimizes, verbose=args.verbose)
    if args.chains:
        failed += sweep_chains(bits, optimizes, verbose=args.verbose)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
