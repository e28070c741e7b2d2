"""The DeepSeek-V2-Lite cell (``deepseek-v2-lite.decode-agent``): its work
counts by hand, its weights against the port's parameters, its reference's
imports, and its check, which the sound program passes and its control
(the reference's weight products in float8 e4m3) and each planted fault
fail.  The runs are at a small size on the CPU through ``run_cell`` and
``tools/readings.py``; the small model is held to limits set, as the
cell's are, from its own readings."""
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from readings import readings  # noqa: E402

from simbench.counts.mla_moe_flops import (active_params, head_flops,  # noqa: E402
                                           request_flops, token_flops)
from simbench.drivers import mla_moe_decode  # noqa: E402
from simbench.harness import faults, mla_moe_weights, spec  # noqa: E402
from simbench.harness.guard import forbidden_modules  # noqa: E402
from simbench.harness.main import run_cell  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark()
CELL = "deepseek-v2-lite.decode-agent"
CONFIG, TRAFFIC = spec.find_cell(BENCH, CELL)[1:]
SEEDS = (101, 102, 103)
# the published keys at a small size: 1 dense + 2 MoE layers, 8 experts
# top-3 and 1 shared, latent 32, rope 8; every mechanism kept
SMALL = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "qk_nope_head_dim": 16, "v_head_dim": 16,
         "qk_rope_head_dim": 8, "kv_lora_rank": 32, "intermediate_size": 96,
         "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 3, "n_shared_experts": 1, "vocab_size": 256}
SMALL_REQUESTS = [[16, 6], [32, 4], [48, 8], [16, 3]]
# the small model's readings (seeds 101-110, bf16 compute): sound mean
# ≤ 0.00044 σ, widest ≤ 0.018 σ; control mean ≥ 0.0046 σ; one altered
# token widest ≥ 1.46 σ
SMALL_LIMITS = {"mean_gap_sigma": 0.002, "widest_gap_sigma": 1.0}


def small_traffic():
    return dict(TRAFFIC, requests=SMALL_REQUESTS, trace_steps=2,
                checks=SMALL_LIMITS)


def small_run(seed: int = 9) -> dict:
    return run_cell(BENCH, CELL, seed, 0.1, False, "cpu",
                    time.perf_counter(), dict(CONFIG, **SMALL),
                    small_traffic())


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------

TINY = dict(CONFIG, num_hidden_layers=3, first_k_dense_replace=1,
            hidden_size=4, num_attention_heads=2, kv_lora_rank=3,
            qk_nope_head_dim=2, qk_rope_head_dim=1, v_head_dim=2,
            intermediate_size=5, moe_intermediate_size=3,
            n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
            vocab_size=10)


def test_token_flops_by_hand():
    # projections 2·(4·2·3 + 4·4 + 3·2·4 + 2·2·4) = 2·80 = 160 a layer;
    # attention over 5 keys 2·2·(3 + 2)·5 = 100 a layer; dense 3·2·4·5
    # = 120; MoE router 2·4·4 = 32 and 3 experts 3·3·2·4·3 = 216
    assert token_flops(TINY, 5) == 3 * (160 + 100) + 120 + 2 * (32 + 216)
    assert head_flops(TINY) == 80


def test_request_flops_by_hand():
    want = 3 * (token_flops(TINY, 1) + token_flops(TINY, 2)
                + token_flops(TINY, 3) + 2 * head_flops(TINY))
    assert request_flops(TINY, batch=3, prompt=2, new_tokens=2) == want


def test_counts_match_the_published_sizes():
    # 27 layers of attention: w_q 2048·16·192, w_dkv 2048·576, w_uk and
    # w_uv 512·16·128 each, wo 16·128·2048; the dense layer 3·2048·10944;
    # 26 MoE layers of 64 experts and 2 shared of 1,408 and a router;
    # embedding and head 102400·2048 each; the norms 27·(2048·2 + 512)
    # + 2048
    attn = 2048 * 16 * 192 + 2048 * 576 + 2 * 512 * 16 * 128 + 16 * 128 * 2048
    moe = 66 * 3 * 2048 * 1408 + 2048 * 64
    want = (27 * attn + 3 * 2048 * 10944 + 26 * moe + 2 * 102400 * 2048
            + 27 * (2 * 2048 + 512) + 2048)
    assert mla_moe_weights.n_params(CONFIG) == want == 15_706_484_224
    assert round(want / 1e9, 2) == 15.71
    # active: the mean token passes 6 + 2 experts a MoE layer (the
    # published 2.4 B, embedding left out, head included)
    assert active_params(CONFIG) == pytest.approx(2.45e9, rel=0.01)
    # 2·N_active a token plus attention: within 1 % at a short context
    assert token_flops(CONFIG, 1) + head_flops(CONFIG) == pytest.approx(
        2 * active_params(CONFIG), rel=0.01)


def test_the_configuration_holds_the_catalog_sizes_and_the_ports():
    assert CONFIG["reduced"] == [] and CONFIG["param_dtype"] == "bfloat16"
    cfg = mla_moe_decode.port_config(CONFIG)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.vocab) == (27, 2048, 16, 128, 10944, 102400)
    assert (cfg.n_experts, cfg.experts_per_tok, cfg.d_expert,
            cfg.n_shared_experts, cfg.first_k_dense) == (64, 6, 1408, 2, 1)
    assert (cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim) == (
        512, 0, 64)
    assert cfg.dropless and cfg.kv_norm and not cfg.norm_topk_prob
    assert (cfg.yarn_factor, cfg.yarn_mscale) == (40, 0.707)
    assert cfg.norm_eps == 1e-6 and cfg.param_dtype == "bfloat16"


def test_the_port_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        mla_moe_decode.port_config(dict(CONFIG, routed_scaling_factor=2.5))
    for key, value in (("beta_fast", 16), ("type", "linear"),
                       ("original_max_position_embeddings", 8192),
                       ("mscale_all_dim", 1.0)):
        rs = dict(CONFIG["rope_scaling"], **{key: value})
        with pytest.raises(ValueError, match="beta_fast|type|original|mscale"):
            mla_moe_decode.port_config(dict(CONFIG, rope_scaling=rs))
    with pytest.raises(ModuleNotFoundError):
        mla_moe_decode.port_config(dict(CONFIG, port_config="no-such-model"))


# ---------------------------------------------------------------------------
# Weights and reference
# ---------------------------------------------------------------------------

def test_the_weights_are_the_ports_parameters():
    from repro_torch.models.transformer import Transformer
    config = dict(CONFIG, **SMALL)
    model = Transformer(mla_moe_decode.port_config(config), device="meta")
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    got = {n: s for n, s, _ in mla_moe_weights.layout(config)}
    assert got == want
    w = mla_moe_weights.draw(config, 2**40 + 3, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in w.values())
    first = w["blocks.0.attn.w_q"].data_ptr()        # the buffer's start
    assert all((t.data_ptr() - first) % 128 == 0 for t in w.values())
    assert float(w["blocks.0.attn.kv_norm.scale"].min()) == 1.0
    full = mla_moe_weights.layout(CONFIG)
    assert {n for n, _, _ in full} == {
        n for n in Transformer(mla_moe_decode.port_config(CONFIG),
                               device="meta").state_dict()}


def test_the_reference_loads_nothing_of_the_port_or_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nimport simbench.reference.mla_moe_lm\n"
         "import simbench.counts.mla_moe_flops, "
         "simbench.harness.mla_moe_weights\nprint(*sys.modules)"],
        check=True, capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    names = out.stdout.split()
    assert "simbench.reference.mla_moe_lm" in names
    assert not [n for n in names if n.partition(".")[0] == "repro_torch"]
    assert forbidden_modules(names) == []


def test_the_references_yarn_by_hand():
    from simbench.reference import mla_moe_lm as ref
    inv = ref.yarn_inv_freq(CONFIG)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # correction range: floor(64·ln(4096/(32·2π)) / (2·ln 1e4)) = 10,
    # ceil(64·ln(4096/(2π)) / (2·ln 1e4)) = 23
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    assert torch.allclose(inv.double(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ref.softmax_scale(CONFIG) == pytest.approx(192 ** -0.5 * m * m)
    assert m * m == pytest.approx(1.5896, abs=1e-4)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def test_a_sound_small_run_is_correct():
    r = small_run()
    assert r["correct"], r["checks"]
    assert r["notes"]["checked_tokens"] > 0


def _small_readings(control: bool, fault=None):
    return readings(CELL, SEEDS, "cpu", 0.1, control, fault,
                    config=dict(CONFIG, **SMALL), traffic=small_traffic())


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_control_fails_and_the_program_passes(control):
    for row in _small_readings(control):
        assert row["correct"] is not control, row
        if control:
            assert row["checks"]["mean_gap_sigma"]["value"] > \
                SMALL_LIMITS["mean_gap_sigma"], row


def test_one_altered_token_fails_the_widest_gap():
    with faults.one_token(max(n for _, n in SMALL_REQUESTS)):
        r = small_run()
    assert not r["correct"]
    assert r["checks"]["widest_gap_sigma"]["value"] > \
        SMALL_LIMITS["widest_gap_sigma"]


def _boost(logits):
    logits = logits.clone()
    logits[0, -1, 3] += 1e3
    return logits


def _half(logits):
    logits = logits.clone()
    logits[logits.shape[0] // 2:] = 0
    return logits


@pytest.mark.parametrize("fn", [_boost, _half],
                         ids=["token_altered", "half_the_batch"])
def test_altered_outputs_fail(monkeypatch, fn):
    from repro_torch.models.transformer import Transformer
    inner = Transformer.forward

    def forward(self, batch, caches=None, **kw):
        out, aux, new = inner(self, batch, caches, **kw)
        return fn(out), aux, new
    monkeypatch.setattr(Transformer, "forward", forward)
    assert not small_run()["correct"]


def test_a_latent_cache_left_unchanged_fails(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_write", lambda cache, update, pos: cache)
    assert not small_run()["correct"]
