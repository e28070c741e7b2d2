"""Serving traffic end to end: a ``SimdramServer`` admits concurrent decode
sessions (thread-safe, asyncio-friendly), shards them over a pool of
isolated ``SimdramMachine`` instances, and continuously batches compatible
sessions into the bank axis at every decode-step boundary — retiring
finished sequences, joining new arrivals, and reporting modeled SLO
metrics (p50/p99 ns-per-token, TTFT, tokens/s at N users).

    PYTHONPATH=src python -m repro_torch.examples.serve_traffic [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise; on a CUDA device every
decode step runs the FSM and transposition kernels.
"""
import argparse
import asyncio
import sys

from repro_torch.serve import ServingStats, SimdramServer, profile_for

# the model zoo supplies request-mix diversity: each config maps to a
# per-token μProgram profile (op family, bit width, SIMD lanes)
MIX = ["qwen1_5_0_5b", "mamba2_130m", "whisper_large_v3", "olmoe_1b_7b"]


def serve(device) -> ServingStats:
    """8 users on 2 machines × 8 banks through ``run_async``; returns the
    server's stats after every session retired."""
    server = SimdramServer(n_machines=2, n_banks=8, refresh_policy="aware",
                           device=device)
    # 8 concurrent users, staggered arrivals on the MODELED clock, varied
    # sequence lengths so sessions retire mid-flight and new arrivals join
    # at step boundaries (continuous batching, not static batching)
    handles = [server.submit_session(MIX[u % len(MIX)], n_tokens=3 + u % 3,
                                     arrival_ns=u * 400.0)
               for u in range(8)]

    async def run() -> ServingStats:
        stats = await server.run_async()    # serving loop off the event loop
        await handles[0].wait_async()       # handles are awaitable too
        return stats

    stats = asyncio.run(run())
    assert all(h.done() for h in handles)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_traffic",
        description="8 users on a pool of 2 machines, continuous batching")
    ap.add_argument("--device", default="cuda",
                    help="where the machines run (default: %(default)s)")
    args = ap.parse_args(argv)
    for cfg in MIX:
        p = profile_for(cfg)
        print(f"  {cfg:18s} -> {p.op}/{p.n_bits}b x {p.lanes} lanes "
              f"[{p.family}]")
    stats = serve(args.device)
    print(stats.report())
    assert stats.n_sessions == 8 and stats.users == 8
    assert stats.p99_token_ns >= stats.p50_token_ns > 0.0
    # the pool actually sharded: every machine served tokens
    assert all(m["tokens"] > 0 for m in stats.machines)
    print("ok: served", stats.total_tokens, "tokens over",
          len(stats.machines), "machines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
