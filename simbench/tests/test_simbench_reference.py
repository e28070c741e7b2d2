"""The plain references against the port's CPU path at small sizes.

Only these tests bring the two together: the benchmark's reference never
calls the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

from simbench.drivers import bbop_stream
from simbench.harness import lm_weights
from simbench.reference import bbop_numpy, dram_meters, moe_lm

W32 = "ops16-w32"
OPS = bbop_stream.BBOPS


def _traffic_ops():
    from simbench.harness import spec
    return spec.load_json(spec.traffic_path(W32))["ops"]


@pytest.fixture(scope="module")
def machine():
    from repro_torch.ops import SimdramMachine
    return SimdramMachine(banks=2, device="cpu", backend="kernel")


@pytest.mark.parametrize("n_bits", [8, 16])
@pytest.mark.parametrize("op,roles", _traffic_ops())
def test_bbop_reference_matches_the_port(machine, op, roles, n_bits):
    pool = bbop_stream.make_pool(1, 2, 256, n_bits, 7 + n_bits, "cpu")[0]
    got = bbop_stream._caller(machine, op, roles, n_bits, [pool])(0).numpy()
    args = [pool[r].numpy() for r in roles]
    assert bbop_numpy.mismatches(op, args, got, n_bits) == 0


@pytest.mark.parametrize("op", [op for op, _ in _traffic_ops()])
def test_dram_cost_table_matches_the_ports_programs(machine, op):
    """The table (made by the JAX reference package) against the port's
    μProgram Memory and cost model at the cell's width."""
    from repro_torch.simdram.timing import SimdramPerfModel
    prog, _ = machine.memory.get(op, 32, True)
    want = dram_meters.table("simdram16", 32)[op]
    model = SimdramPerfModel()
    assert prog.command_mix() == {k: want[k] for k in ("AAP", "AP", "TRA")}
    assert model.latency_ns(prog) == want["latency_ns"]
    assert model.energy_nj(prog) == want["energy_nj"]


def test_dram_meters_hand_sum():
    costs = {"x": {"AAP": 3, "AP": 1, "TRA": 1, "latency_ns": 2.5,
                   "energy_nj": 0.5},
             "y": {"AAP": 1, "AP": 0, "TRA": 0, "latency_ns": 1.0,
                   "energy_nj": 0.25}}
    assert dram_meters.meters(costs, ["x", "y", "x"], banks=4, lanes=8) == {
        "exec_ns": 6.0, "exec_nj": 5.0, "elem_ops": 96, "n_commands": 9}


def test_bbop_reference_hand_values():
    a = np.array([5, 250, 128, 0])
    b = np.array([3, 7, 128, 0])
    assert list(bbop_numpy.expected("division", [a, b], 8)) == [1, 35, 1, 255]
    assert list(bbop_numpy.expected("abs", [a], 8)) == [5, 6, 128, 0]
    assert list(bbop_numpy.expected("relu", [a], 8)) == [5, 0, 0, 0]
    assert list(bbop_numpy.expected("bitcount", [a], 8)) == [2, 6, 1, 0]
    assert list(bbop_numpy.expected("greater_equal", [a, b], 8)) == [1, 1, 1, 1]
    assert list(bbop_numpy.expected("subtraction", [b, a], 8)) == [254, 13, 0, 0]


TINY = {"n_layers": 2, "d_model": 32, "n_heads": 4, "n_kv_heads": 4,
        "head_dim": 8, "vocab": 64, "n_experts": 8, "experts_per_tok": 2,
        "d_expert": 16, "d_ff": 16}


def _small(capacity_factor=1.25):
    from simbench.harness import spec
    cfg = spec.load_json(spec.config_path("olmoe-1b-7b"))
    return dict(cfg, **TINY, capacity_factor=capacity_factor,
                compute_dtype="float32", kv_cache_dtype="float32")


def _port_model(cfg, seed):
    from repro_torch.models.transformer import Transformer
    from simbench.drivers.lm_decode import model_config
    weights = lm_weights.draw(cfg, seed, "cpu")
    model = Transformer(model_config(cfg), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model, weights


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_reference_matches_the_port_prefill_and_decode(capacity_factor):
    """Prefill of 6 tokens then 4 cached one-token steps through the port in
    float32, against one reference forward routed the same way."""
    from repro_torch.models.transformer import init_caches
    cfg = _small(capacity_factor)
    model, weights = _port_model(cfg, seed=3)
    b, s, steps = 4, 6, 4
    toks = torch.randint(0, cfg["vocab"], (b, s + steps),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        caches = init_caches(model.cfg, b, s + steps, dtype=torch.float32,
                             device="cpu")
        outs = []
        logits, _, caches = model({"tokens": toks[:, :s]}, caches)
        outs.append(logits[:, -1])
        for t in range(s, s + steps - 1):
            logits, _, caches = model({"tokens": toks[:, t:t + 1]}, caches)
            outs.append(logits[:, -1])
    got = torch.stack(outs, 1)
    want = moe_lm.logits(weights, cfg, toks[:, :s + steps - 1], s,
                         range(s - 1, s + steps - 1))
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_routing_groups_cover_every_token_once():
    groups = moe_lm.routing_groups(4, 10, 6, 8, "cpu")
    flat = torch.cat([g.reshape(-1) for g in groups])
    assert sorted(flat.tolist()) == list(range(40))
    assert groups[0].shape == (3, 8)            # 24 prompt tokens, groups of 8
    assert groups[1].shape == (4, 4)            # 4 later positions × batch 4


def test_fp8_matmul_is_coarser_than_float32():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 128, generator=g), torch.randn(128, 32, generator=g)
    exact = a @ b
    rel = float((moe_lm.fp8_matmul(a, b) - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1


def test_model_config_applies_the_file(monkeypatch):
    from repro_torch.configs import get_config
    from simbench.drivers.lm_decode import model_config
    from simbench.harness import spec
    cfg = spec.load_json(spec.config_path("olmoe-1b-7b"))
    mc = model_config(cfg)
    base = get_config("olmoe-1b-7b")
    assert dataclasses.replace(mc, head_dim=0) == base
    assert mc.hd == cfg["head_dim"]
