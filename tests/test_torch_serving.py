"""The serving slice: ``repro_torch.serve`` and ``repro_torch.launch.serve``
held against ``repro.serve`` and ``repro.launch.serve``.

The same users, configs, seeds and arrivals go through the reference's
``SimdramServer`` and the port's (``device="cpu"``: plain versions of the
kernels), and every observation must be equal, with tolerance 0: the
decoded values are integers and every latency is modeled ns from
identical code.  The scenarios port ``tests/test_serving.py``: single
session, batched vs solo, churn with staggered arrivals, admission at step
boundaries, pool sharding and PerfStats isolation, ``ServingStats``
snapshots (the machines' perf and cache sections included), the two-thread
submission stress, the asyncio surface and the schedule memo.  The
bank-batched argmax sampler is held against ``repro.serve.decode`` on
indices, quantized logits and ``PerfStats`` (``tests/test_perf_model.py``'s
accounting), and the CLI must exit 0 on the CPU and refuse a missing card.
"""
import asyncio
import dataclasses
import functools
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.serve as ref_launch
import repro.ops as ref_ops
import repro.serve as ref_serve
import repro.serve.decode as ref_decode
import repro_torch.configs as port_configs
import repro_torch.core.circuits as port_circuits
import repro_torch.launch.serve as port_launch
import repro_torch.ops as port_ops
import repro_torch.serve as port_serve
import repro_torch.serve.decode as port_decode
from repro_torch.simdram.timing import SimdramPerfModel

SRC = Path(port_serve.__file__).resolve().parents[2]

PKGS = {
    "ref": types.SimpleNamespace(
        serve=ref_serve, ops=ref_ops, server_kw={}, machine_kw={},
        host=np.asarray),
    "port": types.SimpleNamespace(
        serve=port_serve, ops=port_ops, server_kw={"device": "cpu"},
        machine_kw={"device": "cpu"},
        host=lambda t: t.cpu().numpy()),
}

MIX = ["qwen1_5_0_5b", "mamba2_130m", "whisper_large_v3", "olmoe_1b_7b"]
OPS = {"addition": np.add, "multiplication": np.multiply,
       "subtraction": np.subtract, "maximum": np.maximum,
       "minimum": np.minimum}


def oracle_decode(profile, n_tokens: int, sid: int = 0, seed=None):
    """The session's value recurrence replayed in numpy from its seeded
    operand state (the reference's ``DecodeSession`` draws it)."""
    s = ref_serve.DecodeSession(sid, profile, n_tokens, seed=seed)
    a, b = s.a.copy(), s.b.copy()
    for _ in range(n_tokens):
        a = OPS[profile.op](a, b) & ((1 << profile.n_bits) - 1)
    return a


def observe(P, server, handles) -> dict:
    """Everything a serving run shows, as plain Python values."""
    return {
        "values": [P.host(h.result()).astype(np.int64).tolist()
                   for h in handles],
        "sessions": [(h.session.tenant, h.session.machine_index,
                      h.session.tokens_done, h.session.first_token_ns,
                      h.finish_ns, h.ttft_ns, h.token_ns,
                      h.session.queue_ns) for h in handles],
        "snapshot": server.stats().snapshot(),
        "report": server.stats().report(),
    }


# -- the scenarios of tests/test_serving.py, run on either package ----------

def scenario_single(P):
    server = P.serve.SimdramServer(n_machines=1, n_banks=4, **P.server_kw)
    h = server.submit_session("qwen1_5_0_5b", n_tokens=5)
    server.run()
    return server, [h]


def scenario_batched(P):
    batched = P.serve.SimdramServer(n_machines=1, n_banks=8, **P.server_kw)
    hs = [batched.submit_session("mamba2_130m", n_tokens=4)
          for _ in range(4)]
    batched.run()
    solos = []
    for i in range(4):
        solo = P.serve.SimdramServer(n_machines=1, n_banks=8, **P.server_kw)
        solos.append(solo.submit_session("mamba2_130m", n_tokens=4, seed=i))
        solo.run()
    return batched, hs + solos


def scenario_churn(P):
    server = P.serve.SimdramServer(n_machines=2, n_banks=8, **P.server_kw)
    hs = [server.submit_session(MIX[i % len(MIX)], n_tokens=2 + i % 4,
                                arrival_ns=i * 700.0)
          for i in range(8)]
    first = server.run().snapshot()
    # a second run on the same server serves new sessions cleanly
    hs.append(server.submit_session("qwen1_5_0_5b", n_tokens=2))
    server.run()
    server.first_snapshot = first
    return server, hs


def scenario_admission(P):
    server = P.serve.SimdramServer(n_machines=1, n_banks=8, **P.server_kw)
    early = server.submit_session("qwen1_5_0_5b", n_tokens=6, arrival_ns=0.0)
    late = server.submit_session("qwen1_5_0_5b", n_tokens=2, arrival_ns=1.0)
    server.run()
    return server, [early, late]


def scenario_pool(P):
    server = P.serve.SimdramServer(n_machines=2, n_banks=8, **P.server_kw)
    hs = [server.submit_session("qwen1_5_0_5b", n_tokens=3)
          for _ in range(8)]
    server.run()
    return server, hs


def scenario_snapshot(P):
    server = P.serve.SimdramServer(n_machines=2, n_banks=8, **P.server_kw)
    hs = [server.submit_session(MIX[i % len(MIX)], n_tokens=3,
                                arrival_ns=i * 100.0)
          for i in range(8)]
    server.run()
    return server, hs


def scenario_snapshot_replay(P):
    # replay metering, the stall refresh policy and 16 banks: the perf and
    # cache sections then hold replayed ns and the replay memo's counters
    server = P.serve.SimdramServer(n_machines=2, n_banks=16, mode="replay",
                                   refresh_policy="stall", **P.server_kw)
    hs = [server.submit_session(MIX[i % len(MIX)], n_tokens=2 + i % 3,
                                arrival_ns=i * 200.0, priority=i % 2,
                                seed=i)
          for i in range(12)]
    server.run()
    return server, hs


def scenario_threads(P):
    server = P.serve.SimdramServer(n_machines=2, n_banks=8, **P.server_kw)
    handles: dict[int, list] = {0: [], 1: []}

    def submit(tid):
        for i in range(4):
            handles[tid].append(server.submit_session(
                MIX[(tid * 4 + i) % len(MIX)], n_tokens=2 + i % 2,
                seed=tid * 4 + i))

    threads = [threading.Thread(target=submit, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    server.run()
    # the order the threads interleave in is not deterministic, so the
    # comparison is by seed (each seed fixes one session's whole work)
    return server, handles[0] + handles[1]


def scenario_async(P):
    server = P.serve.SimdramServer(n_machines=2, n_banks=4, **P.server_kw)
    hs = [server.submit_session("qwen1_5_0_5b", n_tokens=2)
          for _ in range(4)]

    async def go():
        stats = await server.run_async()
        waited = await hs[0].wait_async()
        return stats, waited

    stats, waited = asyncio.run(go())
    assert waited is hs[0]
    server.async_stats = stats
    return server, hs


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_single, scenario_batched, scenario_churn, scenario_admission,
    scenario_pool, scenario_snapshot, scenario_snapshot_replay,
    scenario_threads, scenario_async)}


@functools.lru_cache(maxsize=None)
def run(pkg: str, name: str):
    """One scenario on one package (cached: every test of a scenario reads
    the same run)."""
    P = PKGS[pkg]
    server, handles = SCENARIOS[name](P)
    return server, handles, observe(P, server, handles)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serving_matches_reference(name):
    _, ref_h, ref = run("ref", name)
    _, port_h, port = run("port", name)
    if name == "threads":
        # sids (so tenants, placement and timing) follow the interleaving;
        # the values are fixed by each session's seed and op
        def final(handles, obs):
            return sorted((h.session.profile.config, h.session.n_tokens,
                           v) for h, v in zip(handles, obs["values"]))
        assert final(port_h, port) == final(ref_h, ref)
        assert port["snapshot"]["total_tokens"] \
            == ref["snapshot"]["total_tokens"]
        return
    assert port["values"] == ref["values"]
    assert port["sessions"] == ref["sessions"]
    assert port["snapshot"] == ref["snapshot"]
    assert port["report"] == ref["report"]


# -- the invariants of tests/test_serving.py, on the port's runs ------------

def test_single_session_matches_oracle():
    server, (h,), obs = run("port", "single")
    assert h.done()
    want = oracle_decode(port_serve.profile_for("qwen1_5_0_5b"), 5)
    np.testing.assert_array_equal(h.result().numpy(), want)
    s = h.session
    assert s.a.dtype == torch.int64 and s.a.device == torch.device("cpu")
    assert s.tokens_done == 5 and len(s.token_ns) == 5
    assert s.ttft_ns is not None and s.ttft_ns > 0
    assert s.finish_ns >= s.first_token_ns
    assert all(t > 0 for t in s.token_ns)
    assert obs["snapshot"]["total_tokens"] == 5
    assert obs["snapshot"]["n_sessions"] == 1


def test_batched_sessions_match_solo_values():
    # 4 compatible sessions continuously batched on one machine produce
    # exactly the values each would produce served alone
    _, hs, obs = run("port", "batched")
    assert obs["values"][:4] == obs["values"][4:]
    for i in range(4):
        want = oracle_decode(port_serve.profile_for("mamba2_130m"), 4,
                             seed=i)
        np.testing.assert_array_equal(obs["values"][i], want)


def test_churn_mixed_lengths_and_staggered_arrivals():
    server, hs, _ = run("port", "churn")
    assert all(h.done() for h in hs)
    first = server.first_snapshot
    assert first["n_sessions"] == 8
    assert first["total_tokens"] == sum(2 + i % 4 for i in range(8))
    for h in hs:
        s = h.session
        # no token can complete before the session existed
        assert s.first_token_ns >= s.arrival_ns
        assert s.finish_ns is not None and s.finish_ns >= s.first_token_ns
    assert server.stats().n_sessions == 9


def test_admission_only_at_step_boundaries():
    # a session arriving mid-flight joins a busy machine only once the
    # modeled clock reaches its arrival
    _, (_, late), _ = run("port", "admission")
    assert late.done()
    assert late.session.first_token_ns >= late.session.arrival_ns


def test_pool_shards_and_isolates_perfstats():
    server, hs, obs = run("port", "pool")
    assert all(h.done() for h in hs)
    assert obs["snapshot"]["users"] == 8
    per_machine = [{s.tenant for s in server.completed
                    if s.machine_index == i} for i in range(2)]
    assert sorted(len(g) for g in per_machine) == [4, 4]
    for i, b in enumerate(server.batchers):
        assert set(b.machine.stats.tenants) == per_machine[i]
        assert b.machine.stats.total_ns > 0
    assert per_machine[0].isdisjoint(per_machine[1])


@pytest.mark.parametrize("name", ["snapshot", "snapshot_replay"])
def test_serving_stats_snapshot_structure(name):
    import json
    _, hs, obs = run("port", name)
    snap = obs["snapshot"]
    json.dumps(snap)                               # JSON-safe throughout
    assert snap["n_sessions"] == len(hs)
    assert snap["total_tokens"] == sum(h.session.n_tokens for h in hs)
    assert 0 < snap["p50_token_ns"] <= snap["p99_token_ns"]
    assert 0 < snap["p50_ttft_ns"] <= snap["p99_ttft_ns"]
    assert snap["tokens_per_s"] > 0 and snap["span_ns"] > 0
    assert len(snap["machines"]) == 2
    for m in snap["machines"]:
        assert m["perf"]["execute"]["n_programs"] > 0
        assert "schedule_hits" in m["cache"]
    assert "ns/token" in obs["report"] and "tokens/s" in obs["report"]
    for h, v in zip(hs, obs["values"]):
        p = h.session.profile
        # "snapshot" seeds by sid, "snapshot_replay" with seed=sid
        np.testing.assert_array_equal(
            v, oracle_decode(p, h.session.n_tokens, sid=h.session.sid))


def test_two_thread_submission_stress():
    _, hs, obs = run("port", "threads")
    assert len(hs) == 8 and all(h.done() for h in hs)
    assert obs["snapshot"]["n_sessions"] == 8
    assert obs["snapshot"]["total_tokens"] == 2 * sum(2 + i % 2
                                                      for i in range(4))
    for k, (h, v) in enumerate(zip(hs, obs["values"])):
        s = h.session
        np.testing.assert_array_equal(
            v, oracle_decode(s.profile, s.n_tokens, seed=k))


def test_async_surface():
    server, hs, obs = run("port", "async")
    assert all(h.done() for h in hs)
    assert server.async_stats.n_sessions == 4
    assert server.async_stats.snapshot() == obs["snapshot"]


# -- the schedule memo and the batcher clock, on the machines directly -----

def memo_repeated_steps(P):
    a = [np.random.default_rng(i).integers(0, 100, 64) for i in range(4)]
    m = P.ops.SimdramMachine(**P.machine_kw)
    seen = []
    for _ in range(3):
        futs = [m.submit("addition", a[i], a[i], tenant=f"s{i}")
                for i in range(4)]
        res = m.drain(n_banks=8, batch=True)
        seen.append((res.ns, res.cycles, res.n_acts,
                     [dataclasses.astuple(f.timing) for f in futs],
                     [P.host(f.result()).tolist() for f in futs]))
    cs = m.memory.stats()
    assert cs["schedule_misses"] == 1 and cs["schedule_hits"] == 2
    assert seen[2][:4] == seen[0][:4]
    return seen, cs


def memo_stepped_loop_exact(P):
    a = np.random.default_rng(7).integers(0, 100, 64)
    m = P.ops.SimdramMachine(**P.machine_kw)
    shapes = []
    for _ in range(2):
        futs = [m.submit("addition", a, a, tenant=f"s{i}") for i in range(3)]
        m.drain(n_banks=4, batch=True)
        shapes.append([f.timing for f in futs])
    _, trace = m.memory.get("addition", 8, True)
    fresh = P.ops.BankScheduler(timing=m.timing, n_banks=4)
    fresh.enqueue(trace, banks=3, tenant="s0", name="addition/8b")
    want = fresh.run()
    hit = shapes[1][0]
    assert hit.finish_ns == want.requests[0].finish_ns
    assert hit.n_acts == want.requests[0].n_acts
    return dataclasses.astuple(hit), m.memory.stats()


def memo_relabels(P):
    a = np.random.default_rng(8).integers(0, 100, 64)
    m = P.ops.SimdramMachine(**P.machine_kw)
    f1 = m.submit("addition", a, a, tenant="alice")
    m.drain(n_banks=2)
    f2 = m.submit("addition", a, a, tenant="bob")
    m.drain(n_banks=2)
    assert m.memory.stats()["schedule_hits"] == 1
    assert f2.timing.tenant == "bob" and f1.timing.tenant == "alice"
    assert f2.timing.finish_ns == f1.timing.finish_ns
    return (dataclasses.astuple(f1.timing), dataclasses.astuple(f2.timing),
            m.memory.stats())


def batcher_clock(P):
    m = P.ops.SimdramMachine(**P.machine_kw)
    batcher = P.serve.ContinuousBatcher(m, n_banks=4)
    s = P.serve.DecodeSession(0, P.serve.profile_for("qwen1_5_0_5b"), 2)
    batcher.admit(s)
    assert batcher.clock_ns == 0.0
    batcher.step()
    t1 = batcher.clock_ns
    assert t1 > 0 and not s.done
    finished = batcher.step()
    assert finished == [s] and s.done and batcher.active == []
    assert batcher.clock_ns > t1 and s.finish_ns == batcher.clock_ns
    return t1, batcher.clock_ns, s.token_ns, P.host(s.a).tolist()


@pytest.mark.parametrize("case", [memo_repeated_steps,
                                  memo_stepped_loop_exact, memo_relabels,
                                  batcher_clock],
                         ids=lambda f: f.__name__)
def test_machine_level_serving_matches_reference(case):
    assert case(PKGS["port"]) == case(PKGS["ref"])


# -- request profiles, percentiles, seeded session state --------------------

PERCENTILES = [(list(range(1, 101)), 50, 50.5), (list(range(1, 101)), 0, 1.0),
               (list(range(1, 101)), 100, 100.0), ([7.0], 50, 7.0),
               ([1, 2, 3, 4], 25, 1.75), ([4, 3, 2, 1], 25, 1.75)]


@pytest.mark.parametrize("xs,q,want", PERCENTILES)
def test_percentile_golden_values(xs, q, want):
    assert port_serve.percentile(xs, q) == want
    assert port_serve.percentile(xs, q) == ref_serve.percentile(xs, q)


def test_percentile_matches_reference_and_rejects_bad_input():
    xs = list(range(1, 101))
    assert port_serve.percentile(xs, 99) == pytest.approx(99.01)
    rng = np.random.default_rng(3)
    for _ in range(20):
        vals = rng.normal(size=rng.integers(1, 40)).tolist()
        q = float(rng.uniform(0, 100))
        assert port_serve.percentile(vals, q) == ref_serve.percentile(vals, q)
    for vals, q in (([], 50), ([1.0], 101), ([1.0], -1)):
        with pytest.raises(ValueError):
            port_serve.percentile(vals, q)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_profile_for_matches_reference(arch):
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.get_reduced(arch) == port_configs.get_reduced(
        arch.replace("_", "-"))
    assert dataclasses.asdict(port_configs.get_config(arch)) \
        == dataclasses.asdict(ref_configs.get_config(arch))
    p = port_serve.profile_for(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(
        ref_serve.profile_for(arch))
    assert p.op in port_circuits.list_operations()
    assert p.batch_key == (p.op, p.n_bits, p.lanes)
    assert p == port_serve.profile_for(arch)


def test_session_state_is_seeded_as_the_reference_and_moves_once():
    prof = port_serve.profile_for("olmoe_1b_7b")
    for sid, seed in ((0, None), (5, None), (3, 11)):
        port = port_serve.DecodeSession(sid, prof, 3, seed=seed)
        ref = ref_serve.DecodeSession(sid, ref_serve.profile_for(
            "olmoe_1b_7b"), 3, seed=seed)
        np.testing.assert_array_equal(port.a, ref.a)
        np.testing.assert_array_equal(port.b, ref.b)
    port.place(torch.device("cpu"))
    assert port.a.dtype == port.b.dtype == torch.int64
    np.testing.assert_array_equal(port.b.numpy(), ref.b)


# -- the in-DRAM sampler ------------------------------------------------------

def argmax_inputs(b: int, v: int, tied: bool):
    rng = np.random.default_rng(1000 * b + v)
    if tied:
        # many maxima a row, in both halves and inside the last word:
        # the tournament's tie rule decides which index wins
        vals = rng.integers(0, 4, (b, v))
        return vals, 2
    vals = np.stack([rng.permutation(4 * v)[:v] for _ in range(b)])
    return vals, int(vals.max()).bit_length()


def port_cpu_machine():
    return port_ops.SimdramMachine(device="cpu")


@pytest.mark.parametrize("b,v,tied", [(4, 100, False), (2, 257, False),
                                      (1, 33, False), (3, 70, True)])
def test_simdram_argmax_matches_reference(b, v, tied):
    vals, n_bits = argmax_inputs(b, v, tied)
    ref_st, port_st = ref_ops.PerfStats(), port_ops.PerfStats()
    want = np.asarray(ref_decode.simdram_argmax(
        jnp.asarray(vals), n_bits=n_bits, perf_stats=ref_st))
    with port_cpu_machine().session():
        got = port_decode.simdram_argmax(torch.as_tensor(vals),
                                         n_bits=n_bits, perf_stats=port_st)
    assert got.dtype == torch.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(vals[np.arange(b), got.numpy()],
                                  vals.max(-1))
    if not tied:
        np.testing.assert_array_equal(got.numpy(), vals.argmax(-1))
    assert port_st.snapshot() == ref_st.snapshot()


def test_simdram_argmax_on_a_machine_charges_its_accumulator():
    vals, n_bits = argmax_inputs(2, 64, False)
    ref_m = ref_ops.SimdramMachine()
    port_m = port_cpu_machine()
    want = np.asarray(ref_decode.simdram_argmax(
        jnp.asarray(vals), n_bits=n_bits, machine=ref_m))
    got = port_decode.simdram_argmax(torch.as_tensor(vals), n_bits=n_bits,
                                     machine=port_m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_m.stats.n_programs == ref_m.stats.n_programs > 0
    assert port_m.stats.snapshot() == ref_m.stats.snapshot()
    assert port_m.cache_stats() == ref_m.cache_stats()


def sampler_logits(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "separated":
        # well-separated maxima survive 8-bit quantization exactly
        x = rng.normal(size=(3, 256)).astype(np.float32)
        x[0, 17], x[1, 200], x[2, 3] = 9.0, 9.0, 9.0
    elif case == "masked":
        # -inf masked logits map to bin 0, not poison the row scale
        x = rng.normal(size=(2, 128)).astype(np.float32)
        x[0, 64:] = -np.inf
        x[1, :32] = -np.inf
        x[0, 11], x[1, 77] = 9.0, 9.0
    elif case == "half_bins":
        # (x - lo) * scale lands exactly on .5 for every odd x: rounding
        # half to even decides the bin
        x = np.tile(np.arange(0, 511, dtype=np.float32), (2, 1))
        x[1] = x[1][::-1]
    elif case == "all_masked_row":
        x = rng.normal(size=(2, 40)).astype(np.float32)
        x[1] = -np.inf
        x[0, :3] = np.nan
    else:                                          # near ties, wide range
        x = (rng.normal(size=(4, 300)) * 1e3).astype(np.float32)
    return x


def ref_quantize(logits: np.ndarray, n_bits: int = 8) -> np.ndarray:
    """``repro.serve.decode.simdram_greedy_token``'s quantizer, statement
    for statement (the reference inlines it)."""
    logits = jnp.asarray(logits)
    finite = jnp.isfinite(logits)
    lo = jnp.min(jnp.where(finite, logits, jnp.inf), -1, keepdims=True)
    hi = jnp.max(jnp.where(finite, logits, -jnp.inf), -1, keepdims=True)
    scale = (2 ** n_bits - 1) / jnp.maximum(hi - lo, 1e-9)
    q = jnp.round((logits - lo) * scale)
    q = jnp.clip(jnp.where(finite, q, 0), 0, 2 ** n_bits - 1)
    return np.asarray(q.astype(jnp.int32))


SAMPLER_CASES = ["separated", "masked", "half_bins", "all_masked_row",
                 "near_ties"]


@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_quantize_logits_matches_reference(case):
    x = sampler_logits(case)
    q = port_decode.quantize_logits(torch.as_tensor(x))
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), ref_quantize(x))


@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_simdram_greedy_token_matches_reference(case):
    x = sampler_logits(case)
    want = np.asarray(ref_decode.simdram_greedy_token(jnp.asarray(x)))
    with port_cpu_machine().session():
        got = port_decode.simdram_greedy_token(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    q = ref_quantize(x)
    np.testing.assert_array_equal(q[np.arange(len(q)), got.numpy()],
                                  q.max(-1))
    if case == "separated":
        np.testing.assert_array_equal(got.numpy(), [17, 200, 3])
    elif case == "masked":
        np.testing.assert_array_equal(got.numpy(), [11, 77])


def test_simdram_argmax_charges_perf_stats():
    # tests/test_perf_model.py's accounting: V=100 → 128 lanes → 2 halving
    # rounds + 5 SWAR strides, each a (greater + 2 if_else) triple
    rng = np.random.default_rng(321)
    vals = np.stack([rng.permutation(256)[:100] for _ in range(2)])
    ref_st, st = ref_ops.PerfStats(), port_ops.PerfStats()
    ref_decode.simdram_argmax(jnp.asarray(vals), n_bits=8, perf_stats=ref_st)
    with port_cpu_machine().session():
        got = port_decode.simdram_argmax(torch.as_tensor(vals), n_bits=8,
                                         perf_stats=st)
    np.testing.assert_array_equal(got.numpy(), vals.argmax(-1))
    assert st.n_programs == 21
    assert st.n_transposes == 3          # 2 loads + 1 store (indices only)
    assert st.max_banks == 2
    m = SimdramPerfModel()
    exp_exec = 7 * (m.latency_ns(port_ops.compile_bbop("greater", 8))
                    + m.latency_ns(port_ops.compile_bbop("if_else", 8))
                    + m.latency_ns(port_ops.compile_bbop("if_else", 7)))
    assert st.exec_ns == pytest.approx(exp_exec, rel=1e-6)
    assert st.exec_ns == ref_st.exec_ns
    assert st.snapshot() == ref_st.snapshot()


def test_greedy_token_accumulates_across_calls():
    rng = np.random.default_rng(341)
    x = rng.normal(size=(2, 64)).astype(np.float32)
    x[0, 7], x[1, 42] = 9.0, 9.0
    ref_st, st = ref_ops.PerfStats(), port_ops.PerfStats()
    with port_cpu_machine().session():
        for _ in range(3):
            tok = port_decode.simdram_greedy_token(torch.as_tensor(x),
                                                   perf_stats=st)
            ref_decode.simdram_greedy_token(jnp.asarray(x),
                                            perf_stats=ref_st)
    np.testing.assert_array_equal(tok.numpy(), [7, 42])
    assert st.n_programs % 3 == 0 and st.n_programs > 0
    assert st.snapshot() == ref_st.snapshot()


# -- the CLI and the device rule ----------------------------------------------

def test_launch_serve_on_cpu_exits_zero_with_the_reference_report(capsys):
    argv = ["--users", "6", "--steps", "3", "--config",
            "qwen1_5_0_5b,whisper_large_v3,olmoe_1b_7b", "--mode", "replay"]
    assert ref_launch.main(argv) == 0
    ref_out = capsys.readouterr().out.splitlines()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "device=cpu" in lines[0]
    assert lines[1:] == ref_out[1:]
    assert lines[-1] == "6/6 sessions retired"


def test_launch_serve_exits_one_unless_every_session_retires(capsys):
    argv = ["--users", "4", "--steps", "3", "--max-steps", "1",
            "--device", "cpu"]
    assert port_launch.main(argv) == 1
    assert "0/4 sessions retired" in capsys.readouterr().out


def test_cuda_server_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.SimdramServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.SimdramServer(n_machines=1, device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.main(["--users", "1", "--steps", "1"])
    server = port_serve.SimdramServer(n_machines=1, device="cpu")
    assert all(m.device == torch.device("cpu") for m in server.machines)
