"""The Kimi-Linear-48B-A3B cell (``kimi-linear-48b-a3b.decode-agent-kda``):
its configuration against the published ``config.json``, its work counts
by hand, its weights against the port's parameters, its reference (whose
chunked delta rule is held against the token recurrence, and which loads
nothing of the port or JAX), its reader ``kda_state_gb``, and its check,
which the sound program passes and its control (the reference's weight
products in float8 e4m3) and each planted fault fail.  The runs are at a
small size on the CPU through ``run_cell`` and ``tools/readings.py``; the
small model is held to limits set, as the cell's are, from its own
readings."""
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from readings import readings  # noqa: E402

from simbench.counts.kimi_linear_flops import (head_flops,  # noqa: E402
                                               request_flops, token_flops)
from simbench.drivers import kimi_linear_decode  # noqa: E402
from simbench.harness import kimi_linear_weights, spec  # noqa: E402
from simbench.harness.guard import forbidden_modules  # noqa: E402
from simbench.harness.main import run_cell  # noqa: E402
from simbench.reference import kimi_linear_lm as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark()
CELL = "kimi-linear-48b-a3b.decode-agent-kda"
CONFIG, TRAFFIC = spec.find_cell(BENCH, CELL)[1:]
SEEDS = (101, 102, 103)
# the published keys at a small size: layers KDA+dense, KDA+MoE, MLA+MoE,
# KDA+MoE; KDA 4 heads of 8; MLA 4 heads (nope 8 + 8, latent 16); 4 of 8
# experts held (top-3)
SMALL = {"num_hidden_layers": 4, "hidden_size": 64,
         "linear_attn_config": dict(CONFIG["linear_attn_config"],
                                    full_attn_layers=[3], kda_layers=[1, 2, 4],
                                    num_heads=4, head_dim=8),
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
         "v_head_dim": 8, "intermediate_size": 96, "moe_intermediate_size": 32,
         "num_experts": 4, "num_experts_per_token": 3, "vocab_size": 256,
         "expert_share": dict(CONFIG["expert_share"],
                              published_num_experts=8)}
SMALL_REQUESTS = [[16, 6], [13, 5], [40, 8], [8, 5]]
# the small model's readings (seeds 101-103, bf16 compute): sound mean
# ≤ 0.0015 σ, widest ≤ 0.050 σ, route shortfall ≤ 0.0020; control mean
# ≥ 0.044 σ, shortfall ≥ 0.033; a KDA state zeroed after the prefill, the
# decay or β dropped, mean ≥ 1.34 σ; one altered token widest ≥ 1.97 σ
SMALL_LIMITS = {"mean_gap_sigma": 0.005, "widest_gap_sigma": 1.0,
                "widest_route_shortfall": 0.01}
# the catalog's copy of the published config.json (every key but
# num_experts, which the cell cuts to the chip's share)
PUBLISHED = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu",
    "hidden_size": 2304, "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576,
    "model_type": "kimi_linear", "moe_intermediate_size": 1024,
    "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
    "num_expert_group": 1, "num_experts_per_token": 8,
    "num_hidden_layers": 27, "num_key_value_heads": 32,
    "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
    "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
    "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840}


def small_traffic():
    return dict(TRAFFIC, requests=SMALL_REQUESTS, trace_steps=2,
                checks=SMALL_LIMITS)


def small_run(seed: int = 9, trace: bool = False) -> dict:
    return run_cell(BENCH, CELL, seed, 0.1, trace, "cpu",
                    time.perf_counter(), dict(CONFIG, **SMALL),
                    small_traffic())


# ---------------------------------------------------------------------------
# The configuration and its counts
# ---------------------------------------------------------------------------

def test_the_configuration_holds_the_published_keys_and_the_share():
    assert {k: CONFIG[k] for k in PUBLISHED} == PUBLISHED
    assert CONFIG["reduced"] == ["num_experts"]
    assert CONFIG["num_experts"] == 64
    share = CONFIG["expert_share"]
    assert (share["published_num_experts"], share["first_expert"],
            share["chips"]) == (256, 0, 4)
    assert "experts 0-63" in share["deployment"]
    assert CONFIG["reference"] == "kimi_linear_lm"
    assert CONFIG["control"] == "fp8_matmul"
    cfg = kimi_linear_decode.port_config(CONFIG)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.norm_eps) == (
        54, 2304, 163840, 1e-5)
    assert cfg.block_pattern[0::2].count("K") == 20
    assert [i + 1 for i, c in enumerate(cfg.block_pattern[0::2])
            if c == "L"] == [4, 8, 12, 16, 20, 24, 27]
    assert cfg.block_pattern[1::2] == "D" + "E" * 26
    assert (cfg.kda_heads, cfg.kda_head_dim) == (32, 128)
    assert (cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora_rank,
            cfg.q_lora_rank, cfg.rope, cfg.kv_norm) == (
        32, 128, 64, 512, 0, "none", True)
    assert (cfg.n_experts, cfg.held, cfg.first_expert, cfg.experts_per_tok,
            cfg.d_expert, cfg.shared_expert_width, cfg.d_ff) == (
        256, 64, 0, 8, 1024, 1024, 9216)
    assert cfg.routed_scaling == 2.446 and cfg.ffn_act == "swiglu"
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"


def test_counts_by_hand():
    # KDA: w_in 2304·(3·4096 + 2·128 + 32), conv 4·12288, f_b and g_b
    # 128·4096 each, A_log 32, dt_bias 4096, the norm 128, w_out 4096·2304;
    # MLA: w_q 2304·32·192, w_dkv 2304·576, kv_norm 512, w_uk and w_uv
    # 512·32·128 each, wo 32·128·2304; the dense SwiGLU 3·2304·9216;
    # MoE: router 2304·256 and its bias 256, experts 3·2304·1024 each, the
    # shared expert 3·2304·1024; each block's norm 2304; embedding and
    # head 163840·2304 each, the final norm
    kda = (2304 * 12576 + 4 * 12288 + 2 * 128 * 4096 + 32 + 4096 + 128
           + 4096 * 2304 + 2304)
    mla = (2304 * 32 * 192 + 2304 * 576 + 512 + 2 * 512 * 32 * 128
           + 32 * 128 * 2304 + 2304)
    dense = 3 * 2304 * 9216 + 2304
    expert = 3 * 2304 * 1024
    moe = 2304 * 256 + 256 + expert + 2304
    rest = 2 * 163840 * 2304 + 2304
    held = 20 * kda + 7 * mla + dense + 26 * (moe + 64 * expert) + rest
    whole = held + 26 * 192 * expert
    assert held == 13_789_864_832 and whole == 49_122_681_728
    assert kimi_linear_weights.n_params(CONFIG) == held
    assert round(2 * held / 1e9, 2) == 27.58          # GB in bf16
    share = dict(CONFIG["expert_share"], published_num_experts=256)
    assert kimi_linear_weights.n_params(dict(
        CONFIG, num_experts=256, expert_share=share)) == whole


TINY = dict(CONFIG, num_hidden_layers=2, hidden_size=4,
            linear_attn_config={"kda_layers": [1], "full_attn_layers": [2],
                                "num_heads": 2, "head_dim": 2,
                                "short_conv_kernel_size": 4},
            num_attention_heads=2, kv_lora_rank=3, qk_nope_head_dim=2,
            qk_rope_head_dim=1, v_head_dim=2, intermediate_size=5,
            moe_intermediate_size=3, num_experts=2, num_experts_per_token=2,
            num_shared_experts=1, vocab_size=10,
            expert_share={"published_num_experts": 4, "first_expert": 0})


def test_token_flops_by_hand():
    # KDA: w_in 2·4·(12 + 4 + 2) = 144, f_b and g_b 2·2·2·4 = 32, w_out
    # 2·4·4 = 32, the convs 2·4·12 = 96; the rule chunked 2·(64·10 + 24)
    # = 1328, a step 2·7·4 = 56; MLA: q 2·4·2·3 = 48, w_dkv 2·4·4 = 32,
    # w_uk/w_uv 2·3·2·4 = 48, wo 2·2·2·4 = 32, a key 2·2·(3 + 2) = 20;
    # dense 3·2·4·5 = 120; MoE: router 2·4·4 = 32, 2 pairs × 2/4 held of
    # 3·2·4·3 = 72 → 72, the shared expert 72: layer 1 KDA and the dense
    # FFN, layer 2 MLA and the MoE
    assert token_flops(TINY, 5) == 304 + 1328 + 160 + 20 * 5 + 120 + 176
    assert token_flops(TINY, 5, step=True) == (304 + 56 + 160 + 100 + 120
                                               + 176)
    two = dict(TINY, first_k_dense_replace=0)
    assert token_flops(two, 0) == 304 + 1328 + 160 + 2 * (32 + 72 + 72)
    assert head_flops(TINY) == 80
    # a prompt of 2 and 2 new: 2 prefill tokens, 1 step; keys 1 + 2 + 3
    want = 3 * (2 * token_flops(TINY, 0) + token_flops(TINY, 0, step=True)
                + 20 * 6 + 2 * head_flops(TINY))
    assert request_flops(TINY, batch=3, prompt=2, new_tokens=2) == want


@pytest.mark.parametrize("key,value", [
    ("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
    ("moe_renormalize", False), ("num_expert_group", 2), ("topk_group", 2),
    ("hidden_act", "gelu"), ("q_lora_rank", 1536), ("moe_layer_freq", 2),
    ("rope_scaling", {"type": "yarn", "factor": 32}),
    ("num_nextn_predict_layers", 1), ("tie_word_embeddings", True),
    ("model_type", "kimi_k2")])
def test_the_port_refuses_what_it_does_not_compute(key, value):
    with pytest.raises(ValueError, match=key):
        kimi_linear_decode.port_config(dict(CONFIG, **{key: value}))


@pytest.mark.parametrize("change,match", [
    ({"linear_attn_config": dict(CONFIG["linear_attn_config"],
                                 short_conv_kernel_size=3)},
     "short_conv_kernel_size"),
    ({"v_head_dim": 64}, "v_head_dim"),
    ({"linear_attn_config": dict(CONFIG["linear_attn_config"],
                                 full_attn_layers=[4, 8])}, "do not split")])
def test_the_port_refuses_layers_it_cannot_build(change, match):
    with pytest.raises(ValueError, match=match):
        kimi_linear_decode.port_config(dict(CONFIG, **change))


def test_the_choice_bias_changes_choices_at_the_published_widths():
    """Router logits of normed tokens at the published width and scale;
    the correction bias at the configuration's scale changes a share of
    the chosen experts, and no gate (the gates are the chosen scores)."""
    g = torch.Generator().manual_seed(34)
    d, e = CONFIG["hidden_size"], 256
    h = torch.randn(2048, d, generator=g)
    router = torch.randn(d, e, generator=g) * CONFIG["init_std"]
    bias = torch.randn(e, generator=g) * CONFIG["choice_bias_std"]
    rcfg = {"num_experts_per_tok": 8, "routed_scaling_factor": 2.446}
    plain, _ = ref.route(h, router, torch.zeros(e), rcfg)
    chosen, gate = ref.route(h, router, bias, rcfg)
    kept = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(plain, chosen)) / plain.numel()
    assert 0.55 <= kept <= 0.8
    scores = torch.sigmoid(h @ router).gather(1, chosen)
    assert torch.allclose(gate, scores / scores.sum(-1, keepdim=True)
                          * 2.446)


# ---------------------------------------------------------------------------
# Weights and reference
# ---------------------------------------------------------------------------

def test_the_weights_are_the_ports_parameters():
    from repro_torch.models.transformer import Transformer
    config = dict(CONFIG, **SMALL)
    model = Transformer(kimi_linear_decode.port_config(config),
                        device="meta")
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    got = {n: s for n, s, _ in kimi_linear_weights.layout(config)}
    assert got == want
    w = kimi_linear_weights.draw(config, 2**40 + 3, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in w.values())
    first = min(t.data_ptr() for t in w.values())     # the buffer's start
    assert all((t.data_ptr() - first) % 128 == 0 for t in w.values())
    m = "kda_blocks.0.mixer."
    a = -torch.exp(w[m + "a_log"].float())
    assert float(a.max()) <= -1 and float(a.min()) >= -16.1
    dt = torch.nn.functional.softplus(w[m + "dt_bias"].float())
    assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 0.101
    assert float(w[m + "conv_w"].abs().max()) <= 0.5
    assert float(w[m + "norm.scale"].min()) == 1
    assert float(w["mla_blocks.0.mixer.kv_norm.scale"].max()) == 1
    assert float(w["moe_blocks.0.mixer.choice_bias"].abs().max()) > 0
    full = kimi_linear_weights.layout(CONFIG)
    assert {n for n, _, _ in full} == set(Transformer(
        kimi_linear_decode.port_config(CONFIG), device="meta").state_dict())


def test_the_reference_loads_nothing_of_the_port_or_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nimport simbench.reference.kimi_linear_lm\n"
         "import simbench.counts.kimi_linear_flops, "
         "simbench.harness.kimi_linear_weights\nprint(*sys.modules)"],
        check=True, capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    names = out.stdout.split()
    assert "simbench.reference.kimi_linear_lm" in names
    assert not [n for n in names if n.partition(".")[0] == "repro_torch"]
    assert forbidden_modules(names) == []


@pytest.mark.parametrize("a,beta_lo", [(4.0, 0.0), (16.0, 0.0),
                                       (0.05, 0.999)],
                         ids=["plain", "strong_decay", "beta_near_1"])
@pytest.mark.parametrize("length", [5, ref.KDA_CHUNK, 2 * ref.KDA_CHUNK + 9])
def test_the_references_chunked_rule_equals_its_token_recurrence(
        length, a, beta_lo):
    """The chunked form (chunks of KDA_CHUNK, the last one ragged) from a
    state, against the token recurrence, within 1e-5 of the largest
    magnitude: float32 sums of a chunk's terms in another order."""
    g = torch.Generator().manual_seed(length)
    nh, dk, dv = 3, 6, 5
    q = ref._l2norm(torch.randn(length, nh, dk, generator=g)) * dk ** -0.5
    k = ref._l2norm(torch.randn(length, nh, dk, generator=g))
    v = torch.randn(length, nh, dv, generator=g)
    decay = -torch.rand(length, nh, dk, generator=g) * a
    beta = beta_lo + (1 - beta_lo) * torch.rand(length, nh, generator=g)
    s0 = torch.randn(nh, dk, dv, generator=g)
    want_o, want_s = ref.kda_recurrence(q, k, v, decay, beta, s0)
    o, s = ref.kda(q, k, v, decay, beta, s0)
    for got, want in ((o, want_o), (s, want_s)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_the_reference_rule_by_hand():
    """Two tokens of one head, K = V = 1: S = e^g S + β (v − e^g S k) k."""
    q = torch.ones(2, 1, 1)
    k = torch.ones(2, 1, 1)
    v = torch.tensor([2.0, 4.0]).reshape(2, 1, 1)
    g = torch.full((2, 1, 1), math.log(0.5))
    beta = torch.full((2, 1), 0.5)
    # S1 = 0.5·0 + 0.5·(2 − 0) = 1; S2 = 0.5 + 0.5·(4 − 0.5) = 2.25
    for fn in (ref.kda_recurrence, ref.kda):
        o, s = fn(q, k, v, g, beta)
        assert torch.allclose(o.flatten(), torch.tensor([1.0, 2.25]))
        assert torch.allclose(s.flatten(), torch.tensor([2.25]))


# ---------------------------------------------------------------------------
# The reader and the check
# ---------------------------------------------------------------------------

def test_kda_state_gb_reads_nothing_without_the_registry(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    reader = spec.load_module(spec.metric_path("kda_state_gb"),
                              "_reader_kda_state_gb")
    assert reader.read({}) is None


def test_a_sound_small_run_is_correct_and_reads_its_layers():
    r = small_run()
    assert r["correct"], r["checks"]
    assert r["notes"]["checked_tokens"] > 0
    # the expert choices recomputed for the check serve the same tokens
    assert r["notes"]["served_not_argmax"] == 0
    traced = small_run(trace=True)
    for name in ("kda_state_gb", "latent_read_gb"):
        assert traced["metrics"][name]["value"] > 0, name


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


def _plant(monkeypatch, fault: str):
    """The state left at zero after each cached prefill, or the decay (g
    = 0) or β (= 1) dropped from the delta rule."""
    from repro_torch.models import layers
    if fault == "state_zero":
        inner = layers.KDAMixer.forward

        def forward(self, x, cache=None):
            out = inner(self, x, cache)
            if cache is not None and x.shape[1] > 1:
                cache["state"].zero_()
            return out
        monkeypatch.setattr(layers.KDAMixer, "forward", forward)
        return
    for name in ("_kda_step", "_kda_chunked"):
        inner = getattr(layers, name)

        def rule(q, k, v, g, beta, *a, inner=inner, **kw):
            if fault == "no_decay":
                g = torch.zeros_like(g)
            else:
                beta = torch.ones_like(beta)
            return inner(q, k, v, g, beta, *a, **kw)
        monkeypatch.setattr(layers, name, rule)


@pytest.mark.parametrize("fault", ["state_zero", "no_decay", "no_beta"])
def test_a_planted_kda_fault_fails_the_mean_gap(fault, monkeypatch):
    _plant(monkeypatch, fault)
    r = small_run()
    assert not r["correct"]
    assert r["checks"]["mean_gap_sigma"]["value"] > \
        SMALL_LIMITS["mean_gap_sigma"]
