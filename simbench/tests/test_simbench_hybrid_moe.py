"""The Nemotron 3 Nano cell (``nemotron-3-nano-30b-a3b.decode-agent-hybrid``):
its configuration against the published sizes, its work counts by hand,
its weights against the port's parameters, its reference's imports, and
its check, which the sound program passes and its control (the
reference's weight products in float8 e4m3) and each planted fault fail.
The runs are at a small size on the CPU through ``run_cell`` and
``tools/readings.py``; the small model is held to limits set, as the
cell's are, from its own readings."""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from readings import readings  # noqa: E402

from simbench.counts.hybrid_moe_flops import (head_flops,  # noqa: E402
                                              request_flops, token_flops)
from simbench.drivers import hybrid_moe_decode  # noqa: E402
from simbench.harness import faults, hybrid_moe_weights, spec  # noqa: E402
from simbench.harness.guard import forbidden_modules  # noqa: E402
from simbench.harness.main import run_cell  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark()
CELL = "nemotron-3-nano-30b-a3b.decode-agent-hybrid"
CONFIG, TRAFFIC = spec.find_cell(BENCH, CELL)[1:]
SEEDS = (101, 102, 103)
# the published keys at a small size: MEM*EME, 4 Mamba-2 heads of 8 in 2
# groups of state 8, chunk 8; 4 of 8 experts held (top-3); GQA 4/2
SMALL = {"num_hidden_layers": 7, "hybrid_override_pattern": "MEM*EME",
         "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "mamba_num_heads": 4,
         "mamba_head_dim": 8, "n_groups": 2, "ssm_state_size": 8,
         "chunk_size": 8, "moe_intermediate_size": 32,
         "moe_shared_expert_intermediate_size": 48, "n_routed_experts": 4,
         "num_experts_per_tok": 3, "vocab_size": 256,
         "expert_share": dict(CONFIG["expert_share"],
                              published_n_routed_experts=8)}
SMALL_REQUESTS = [[16, 6], [13, 5], [40, 8], [8, 5]]
# the small model's readings (seeds 101-103, bf16 compute): sound mean
# ≤ 0.00024 σ, widest ≤ 0.013 σ, route shortfall ≤ 0.00071; control mean
# ≥ 0.011 σ, shortfall ≥ 0.0089; one altered token widest ≥ 1.43 σ
SMALL_LIMITS = {"mean_gap_sigma": 0.002, "widest_gap_sigma": 1.0,
                "widest_route_shortfall": 0.003}
# the published config.json's sizes (the model's Hugging Face card)
PUBLISHED = {
    "hidden_size": 2688, "num_hidden_layers": 52, "vocab_size": 131072,
    "hybrid_override_pattern":
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    "mamba_num_heads": 64, "mamba_head_dim": 64, "n_groups": 8,
    "ssm_state_size": 128, "conv_kernel": 4, "chunk_size": 128,
    "expand": 2, "use_conv_bias": True, "num_attention_heads": 32,
    "num_key_value_heads": 2, "head_dim": 128, "moe_intermediate_size": 1856,
    "moe_shared_expert_intermediate_size": 3712, "n_shared_experts": 1,
    "num_experts_per_tok": 6, "routed_scaling_factor": 2.5,
    "norm_topk_prob": True, "n_group": 1, "topk_group": 1,
    "mlp_hidden_act": "relu2", "layer_norm_epsilon": 1e-5,
    "tie_word_embeddings": False, "time_step_min": 0.001,
    "time_step_max": 0.1, "time_step_floor": 0.0001}


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

def test_the_configuration_holds_the_published_sizes_and_the_share():
    assert {k: CONFIG[k] for k in PUBLISHED} == PUBLISHED
    assert CONFIG["reduced"] == ["n_routed_experts"]
    assert CONFIG["n_routed_experts"] == 64
    share = CONFIG["expert_share"]
    assert (share["published_n_routed_experts"], share["first_expert"],
            share["chips"]) == (128, 0, 2)
    assert "experts 0-63" in share["deployment"]
    cfg = hybrid_moe_decode.port_config(CONFIG)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.vocab) == (52, 2688, 32, 2, 128, 131072)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state,
            cfg.ssm_chunk, cfg.d_inner) == (64, 64, 8, 128, 128, 4096)
    assert (cfg.n_experts, cfg.held, cfg.first_expert, cfg.experts_per_tok,
            cfg.d_expert, cfg.shared_expert_width) == (128, 64, 0, 6, 1856,
                                                       3712)
    assert cfg.routed_scaling == 2.5 and cfg.conv_bias and cfg.rope == "none"
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"


def test_counts_by_hand():
    # Mamba-2: w_in 2688·(4096 + 6144 + 64), conv 4·6144 and its bias,
    # A_log, D, dt_bias 64 each, the norm 4096, w_out 4096·2688;
    # MoE: router 2688·128 and its bias 128, experts 2·2688·1856 each,
    # the shared expert 2·2688·3712; attention: 2688·128·(32 + 2 + 2 + 32);
    # each block's norm 2688; embedding and head 131072·2688 each
    mamba = (2688 * 10304 + 4 * 6144 + 6144 + 3 * 64 + 4096 + 4096 * 2688
             + 2688)
    expert = 2 * 2688 * 1856
    moe = 2688 * 128 + 128 + 2 * 2688 * 3712 + 2688
    attn = 2688 * 128 * 68 + 2688
    rest = 2 * 131072 * 2688 + 2688
    whole = 23 * mamba + 23 * (moe + 128 * expert) + 6 * attn + rest
    held = 23 * mamba + 23 * (moe + 64 * expert) + 6 * attn + rest
    assert whole == 31_577_940_288 and held == 16_890_536_256
    assert hybrid_moe_weights.n_params(CONFIG) == held
    share = dict(CONFIG["expert_share"], published_n_routed_experts=128)
    assert hybrid_moe_weights.n_params(dict(
        CONFIG, n_routed_experts=128, expert_share=share)) == whole
    assert round(2 * held / 1e9, 2) == 33.78          # GB in bf16


TINY = dict(CONFIG, hybrid_override_pattern="ME*", num_hidden_layers=3,
            hidden_size=4, mamba_num_heads=2, mamba_head_dim=3, n_groups=1,
            ssm_state_size=2, num_attention_heads=2, num_key_value_heads=1,
            head_dim=2, moe_intermediate_size=3,
            moe_shared_expert_intermediate_size=5, n_routed_experts=2,
            num_experts_per_tok=2, vocab_size=10,
            expert_share={"published_n_routed_experts": 4,
                          "first_expert": 0})


def test_token_flops_by_hand():
    # M: w_in 2·4·(6 + 10 + 2) = 144, w_out 2·6·4 = 48, conv 2·4·10 = 80,
    # the recurrence 5·6·2 = 60; E: router 2·4·4 = 32, 2 pairs × 2/4 held
    # of up and down 2·2·4·3 = 48 → 48, shared 2·2·4·5 = 80; *: q/k/v/o
    # 2·4·2·(4 + 2) = 96, 5 keys 2·2·2·2·5 = 80
    assert token_flops(TINY, 5) == 332 + 160 + 96 + 80
    assert head_flops(TINY) == 80
    want = 3 * (token_flops(TINY, 1) + token_flops(TINY, 2)
                + token_flops(TINY, 3) + 2 * head_flops(TINY))
    assert request_flops(TINY, batch=3, prompt=2, new_tokens=2) == want


@pytest.mark.parametrize("key,value", [
    ("n_group", 2), ("topk_group", 2), ("mlp_hidden_act", "silu"),
    ("mamba_hidden_act", "gelu"), ("norm_topk_prob", False),
    ("conv_kernel", 3), ("n_shared_experts", 2), ("use_bias", True),
    ("residual_in_fp32", True)])
def test_the_port_refuses_what_it_does_not_compute(key, value):
    with pytest.raises(ValueError, match=key):
        hybrid_moe_decode.port_config(dict(CONFIG, **{key: value}))


def test_the_port_refuses_a_pattern_of_another_length():
    with pytest.raises(ValueError, match="one letter a layer"):
        hybrid_moe_decode.port_config(dict(CONFIG, num_hidden_layers=51))


def test_the_choice_bias_changes_choices_at_the_published_widths():
    """Router logits of normed tokens at the published width and scale;
    the correction bias at the configuration's scale changes a large share
    of the chosen experts, and no gate (the gates are the chosen scores)."""
    from simbench.reference.hybrid_moe_lm import route
    g = torch.Generator().manual_seed(32)
    h = torch.randn(2048, CONFIG["hidden_size"], generator=g)
    router = torch.randn(CONFIG["hidden_size"], 128,
                         generator=g) * CONFIG["init_std"]
    bias = torch.randn(128, generator=g) * CONFIG["choice_bias_std"]
    plain, _ = route(h, router, torch.zeros(128), CONFIG)
    chosen, gate = route(h, router, bias, CONFIG)
    kept = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(plain, chosen)) / plain.numel()
    assert 0.55 <= kept <= 0.8
    scores = torch.sigmoid(h @ router).gather(1, chosen)
    assert torch.allclose(gate, scores / scores.sum(-1, keepdim=True) * 2.5)


# ---------------------------------------------------------------------------
# Weights and reference
# ---------------------------------------------------------------------------

def test_the_weights_are_the_ports_parameters():
    from repro_torch.models.transformer import Transformer
    config = dict(CONFIG, **SMALL)
    model = Transformer(hybrid_moe_decode.port_config(config), device="meta")
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    got = {n: s for n, s, _ in hybrid_moe_weights.layout(config)}
    assert got == want
    w = hybrid_moe_weights.draw(config, 2**40 + 3, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in w.values())
    first = min(t.data_ptr() for t in w.values())     # the buffer's start
    assert all((t.data_ptr() - first) % 128 == 0 for t in w.values())
    m = "ssm_blocks.0.mixer."
    a = -torch.exp(w[m + "a_log"].float())
    assert float(a.max()) <= -1 and float(a.min()) >= -16.1
    dt = torch.nn.functional.softplus(w[m + "dt_bias"].float())
    assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 0.101
    assert float(w[m + "d_skip"].min()) == float(w[m + "d_skip"].max()) == 1
    assert float(w[m + "conv_w"].abs().max()) <= 0.5
    assert float(w["moe_blocks.0.mixer.choice_bias"].abs().max()) > 0
    full = hybrid_moe_weights.layout(CONFIG)
    assert {n for n, _, _ in full} == set(Transformer(
        hybrid_moe_decode.port_config(CONFIG), device="meta").state_dict())


def test_the_reference_loads_nothing_of_the_port_or_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nimport simbench.reference.hybrid_moe_lm\n"
         "import simbench.counts.hybrid_moe_flops, "
         "simbench.harness.hybrid_moe_weights\nprint(*sys.modules)"],
        check=True, capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    names = out.stdout.split()
    assert "simbench.reference.hybrid_moe_lm" in names
    assert not [n for n in names if n.partition(".")[0] == "repro_torch"]
    assert forbidden_modules(names) == []


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def test_a_sound_small_run_is_correct_and_reads_its_state_bytes():
    r = small_run()
    assert r["correct"], r["checks"]
    assert r["notes"]["checked_tokens"] > 0
    # the expert choices recomputed for the check serve the same tokens
    assert r["notes"]["served_not_argmax"] == 0
    traced = small_run(trace=True)
    assert traced["metrics"]["ssm_state_gb"]["value"] > 0


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


def test_the_reference_follows_given_expert_choices():
    """Following its own choices changes nothing and falls short by 0;
    following other choices falls short of them by their scores."""
    from simbench.reference import hybrid_moe_lm as ref
    config = dict(CONFIG, **SMALL)
    w = hybrid_moe_weights.draw(config, 5, "cpu")
    tok = torch.randint(0, 256, (2, 12), generator=torch.Generator()
                        .manual_seed(5))
    own = ref.Routing()
    want = ref.logits(w, config, tok, range(12), routing=own)
    assert torch.equal(want, ref.logits(w, config, tok, range(12)))
    assert len(own.chosen) == config["hybrid_override_pattern"].count("E")
    same = ref.Routing(given=own.chosen)
    assert torch.equal(ref.logits(w, config, tok, range(12), routing=same),
                       want)
    assert same.shortfall == [0.0] * len(own.chosen)
    other = ref.Routing(given=[(c + 1) % 8 for c in own.chosen])
    got = ref.logits(w, config, tok, range(12), routing=other)
    assert min(other.shortfall) > 0 and not torch.equal(got, want)


def test_a_router_without_its_choice_bias_fails_the_route_shortfall(
        monkeypatch):
    from repro_torch.models import layers
    inner = layers.SigmoidMoE.route

    def route(self, tokens):
        bias = self.choice_bias
        self.choice_bias = torch.nn.Parameter(torch.zeros_like(bias),
                                              requires_grad=False)
        try:
            return inner(self, tokens)
        finally:
            self.choice_bias = bias
    monkeypatch.setattr(layers.SigmoidMoE, "route", route)
    r = small_run()
    assert not r["correct"]
    assert r["checks"]["widest_route_shortfall"]["value"] > \
        SMALL_LIMITS["widest_route_shortfall"]


def test_one_altered_token_fails_the_widest_gap():
    with faults.one_token(max(n for _, n in SMALL_REQUESTS)):
        r = small_run()
    assert not r["correct"]
    assert r["checks"]["widest_gap_sigma"]["value"] > \
        SMALL_LIMITS["widest_gap_sigma"]

