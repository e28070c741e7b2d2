"""SIMDRAM serving CLI: continuous-batching decode over a pool of
bank-sharded machines (:class:`~repro_torch.serve.server.SimdramServer`).

    PYTHONPATH=src python -m repro_torch.launch.serve --users 8 --steps 16 \
        --config qwen1_5_0_5b,mamba2_130m --machines 2 --banks 8 \
        --refresh-policy aware [--device cpu]

Each user is one decode session: its model-zoo config sets the per-token
μProgram profile (request-mix diversity), arrivals are staggered on the
modeled clock, and the server continuously batches compatible sessions
into the bank axis at every step boundary.  All reported latencies are
modeled nanoseconds (deterministic), not wall clock.  The machines run
on ``--device`` (``cuda`` by default; without a card that raises).
"""
from __future__ import annotations

import argparse

from ..serve.server import SimdramServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="continuous-batching decode over SIMDRAM machines")
    ap.add_argument("--users", type=int, default=8,
                    help="concurrent decode sessions")
    ap.add_argument("--steps", type=int, default=8,
                    help="tokens generated per session")
    ap.add_argument("--config", default="qwen1_5_0_5b,mamba2_130m",
                    help="comma-separated model-zoo configs, assigned "
                         "round-robin across users")
    ap.add_argument("--machines", type=int, default=2,
                    help="SimdramMachine pool size")
    ap.add_argument("--banks", type=int, default=8,
                    help="modeled controller banks per machine (the "
                         "continuous batch width)")
    ap.add_argument("--refresh-policy", default="aware",
                    choices=("aware", "stall", "defer"))
    ap.add_argument("--backend", default=None,
                    help="execution backend for every pooled machine")
    ap.add_argument("--mode", default="analytic",
                    choices=("analytic", "replay"),
                    help="PerfStats metering mode per machine")
    ap.add_argument("--arrival-gap-ns", type=float, default=500.0,
                    help="modeled arrival stagger between users")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="serving-loop step cap (default: run to drain)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every pooled machine")
    args = ap.parse_args(argv)

    configs = [c.strip() for c in args.config.split(",") if c.strip()]
    if not configs:
        ap.error("--config needs at least one model-zoo name")
    server = SimdramServer(n_machines=args.machines, n_banks=args.banks,
                           refresh_policy=args.refresh_policy,
                           backend=args.backend, mode=args.mode,
                           device=args.device)
    print(f"serving {args.users} users x {args.steps} tokens over "
          f"{args.machines} machines ({args.banks} banks, "
          f"refresh={args.refresh_policy}, mix={configs}, "
          f"device={args.device})")
    handles = []
    for u in range(args.users):
        handles.append(server.submit_session(
            configs[u % len(configs)], n_tokens=args.steps,
            arrival_ns=u * args.arrival_gap_ns))
    stats = server.run(max_steps=args.max_steps)
    print(stats.report())
    n_done = sum(h.done() for h in handles)
    print(f"{n_done}/{len(handles)} sessions retired")
    return 0 if n_done == len(handles) else 1


if __name__ == "__main__":
    raise SystemExit(main())
