"""Kimi-Linear-48B-A3B (``kimi_linear``) in the port
(``configs/kimi_linear_48b_a3b.py``), held against the plain float32
reference ``simbench/reference/kimi_linear_lm.py`` on seeded weights at
the reduced size: layers KDA+dense, KDA+MoE, MLA+MoE, KDA+MoE at d_model
64, KDA 4 heads of 8, NoPE MLA 4 heads (nope 8 + 8, latent 16), 4 of 8
sigmoid-routed SwiGLU experts held (top-3) and a shared expert, vocab 256.
The reference package has no such model, so the oracle is the published
model's math in plain PyTorch, which imports nothing of the port; its KDA
is the chunked form of its own (chunks of 64, a sequence at a time), held
here against the token recurrence, and the port's chunked rule (chunks of
16, its WY form over groups of chunks) against the port's own one-token
step.

Tolerances: float32 compute agrees with the float32 reference up to
rounding (other summation orders): 1e-4 × max|logit|, the port's float32
rule, which the reference with its weight products rounded to bf16
misses.  The cell's bf16 compute is held to 1e-1 × max|logit|, twice the
port's bf16 rule: at these toy widths every block's bf16 activations
leave 0.029–0.068 on seeds 34–45 (0.03–0.07 with the reference following
the program's expert choices, so not a route's flip; 0.018–0.056 with the
KDA in float32), where the cell's check, at the published widths, holds
the served tokens to the limits in ``decode-agent-kda.json``.  The
chunked rule and the cached states are float32 sums of a few dozen terms
against the recurrence: 1e-5 of their largest magnitude.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import KimiLinearConfig, NemotronHConfig
from repro_torch.models import layers, transformer
from repro_torch.models.layers import (KDA_CHUNK, MLAttention, SigmoidMoE,
                                       _kda_chunked, _kda_step, _l2norm)
from repro_torch.models.transformer import (DecodeGraph, Transformer,
                                            init_caches, leaf_names,
                                            model_defs)
from repro_torch.serve.decode import greedy_decode
from simbench.reference import kimi_linear_lm as ref

ARCH = "kimi-linear-48b-a3b"
F32 = 1e-4                  # × max|logit|: float32 against float32
BF16 = 1e-1                 # × max|logit|: bf16 compute against float32
STATE = 1e-5                # × max|state|: float32 chunks against recurrence


def reduced(dtype: str = "float32", **fields) -> KimiLinearConfig:
    return dataclasses.replace(get_reduced(ARCH), param_dtype=dtype,
                               compute_dtype=dtype, **fields)


def ref_config(cfg) -> dict:
    """The published keys of the port's config, for the reference."""
    letters = cfg.block_pattern[0::2]
    return {
        "num_hidden_layers": len(letters), "hidden_size": cfg.d_model,
        "vocab_size": cfg.vocab, "rms_norm_eps": cfg.norm_eps,
        "linear_attn_config": {
            "kda_layers": [i + 1 for i, c in enumerate(letters) if c == "K"],
            "full_attn_layers": [i + 1 for i, c in enumerate(letters)
                                 if c == "L"],
            "num_heads": cfg.kda_heads, "head_dim": cfg.kda_head_dim,
            "short_conv_kernel_size": 4},
        "num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.hd, "qk_rope_head_dim": cfg.rope_head_dim,
        "v_head_dim": cfg.hd, "rope_scaling": None,
        "first_k_dense_replace": cfg.block_pattern[1::2].count("D"),
        "intermediate_size": cfg.d_ff, "moe_intermediate_size": cfg.d_expert,
        "num_experts": cfg.held, "num_shared_experts": 1,
        "expert_share": {"published_num_experts": cfg.n_experts,
                         "first_expert": cfg.first_expert},
        "num_experts_per_token": cfg.experts_per_tok,
        "routed_scaling_factor": cfg.routed_scaling}


def model_and_weights(cfg, seed: int = 34, device="cpu"):
    """The model drawn from ``seed``, its KDA decay parameters drawn as
    the cell's are (``A_log = log U[1, 16]``, dt_bias the softplus⁻¹ of dt
    log-uniform in [1e-3, 0.1]), and the norm scales and the router's
    choice bias not at their init, so every mechanism is exercised."""
    model = Transformer(cfg, device).draw_params(
        torch.Generator(device).manual_seed(seed))
    gen = torch.Generator(device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.uniform_(0.5, 1.5, generator=gen)
            elif leaf == "a_log":
                p.uniform_(1.0, 16.0, generator=gen).log_()
            elif leaf == "dt_bias":
                dt = torch.empty_like(p, dtype=torch.float32).uniform_(
                    math.log(1e-3), math.log(0.1), generator=gen).exp()
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf == "choice_bias":
                p.normal_(generator=gen).mul_(0.02)
            elif leaf in ("f_b", "g_b"):
                p.normal_(generator=gen).mul_(0.3)
    return model, {n: p.detach() for n, p in model.named_parameters()}


def tokens(b: int = 2, t: int = 24, seed: int = 5, device="cpu"):
    return torch.randint(0, 256, (b, t), device=device,
                         generator=torch.Generator(device).manual_seed(seed))


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def bf16_matmul(a, b):
    return (a.bfloat16() @ b.bfloat16()).float()


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------

def test_found_by_name_and_not_among_the_reference_archs():
    cfg = get_config(ARCH)
    assert isinstance(cfg, KimiLinearConfig) and "kimi_linear_48b_a3b" \
        not in ARCHS and len(ARCHS) == 10
    assert cfg.param_count() == 13_789_864_832
    assert dataclasses.replace(cfg, experts_held=0).param_count() \
        == 49_122_681_728
    kinds = cfg.pattern()
    assert (kinds.count("kda"), kinds.count("attn"), kinds.count("dense"),
            kinds.count("moe")) == (20, 7, 1, 26)
    mixers = cfg.block_pattern[0::2]
    assert [i + 1 for i, c in enumerate(mixers) if c == "L"] == [
        4, 8, 12, 16, 20, 24, 27]
    assert (cfg.d_model, cfg.kda_heads, cfg.kda_head_dim, cfg.n_heads,
            cfg.hd, cfg.rope_head_dim, cfg.kv_lora_rank) == (
        2304, 32, 128, 32, 128, 64, 512)
    assert (cfg.n_experts, cfg.held, cfg.experts_per_tok, cfg.d_expert,
            cfg.shared_expert_width, cfg.d_ff) == (256, 64, 8, 1024, 1024,
                                                   9216)
    assert cfg.routed_scaling == 2.446 and cfg.rope == "none" and cfg.kv_norm
    for arch in ARCHS:           # the ten keep their own class
        assert not isinstance(get_config(arch), NemotronHConfig)


def test_the_defs_are_the_modules_parameters():
    cfg = get_reduced(ARCH)
    m = Transformer(cfg, "meta")
    names = [n for leaf in leaf_names(cfg) for n in leaf]
    assert sorted(names) == sorted(n for n, _ in m.named_parameters())
    assert sum(p.numel() for p in m.parameters()) == cfg.param_count()
    defs = model_defs(cfg)
    assert set(defs) == {"embed", "kda_blocks", "mla_blocks", "mlp_blocks",
                         "moe_blocks", "final_norm", "lm_head"}
    assert defs["kda_blocks"]["mixer"]["w_in"].shape == (
        3, 64, 3 * 32 + 2 * 8 + 4)
    assert defs["moe_blocks"]["mixer"]["w_gate"].shape == (3, 4, 64, 32)
    assert defs["mla_blocks"]["mixer"]["w_q"].shape == (1, 64, 4, 16)
    assert defs["mlp_blocks"]["mixer"]["w_gate"].shape == (1, 64, 96)


@pytest.mark.parametrize("fields,match", [
    ({"ffn_act": "silu"}, "ffn_act"), ({"router": "softmax"}, "router"),
    ({"block_pattern": "MDKELEKE"}, "letters"),
    ({"mla": False}, "MLA without positions"),
    ({"rope": "rope"}, "MLA without positions"),
    ({"q_lora_rank": 8}, "q compression"),
    ({"experts_held": 4, "first_expert": 6}, "not among")])
def test_settings_the_port_does_not_compute_are_refused(fields, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(get_reduced(ARCH), **fields)


def test_the_nemotron_config_takes_neither_the_new_letters_nor_an_act():
    nemo = get_reduced("nemotron-3-nano-30b-a3b")
    with pytest.raises(ValueError, match="letters"):
        dataclasses.replace(nemo, block_pattern="MEM*EMK")
    assert dataclasses.replace(nemo, ffn_act="swiglu").ffn_act == "swiglu"


# ---------------------------------------------------------------------------
# The whole model against the reference
# ---------------------------------------------------------------------------

def test_full_forward_matches_the_reference():
    cfg = reduced()
    model, w = model_and_weights(cfg)
    tok = tokens(t=40)
    with torch.no_grad():
        got = model({"tokens": tok})[0]
    want = ref.logits(w, ref_config(cfg), tok, range(tok.shape[1]))
    assert rel_err(got, want) <= F32
    # the tolerance is tight enough that bf16 products fail it
    low = ref.logits(w, ref_config(cfg), tok, range(tok.shape[1]),
                     matmul=bf16_matmul)
    assert rel_err(low, want) > F32


def test_the_cells_dtypes_match_the_reference():
    cfg = reduced("bfloat16")
    model, w = model_and_weights(cfg)
    tok = tokens(t=40)
    with torch.no_grad():
        got = model({"tokens": tok})[0]
    want = ref.logits(w, ref_config(cfg), tok, range(tok.shape[1]))
    assert rel_err(got, want) <= BF16


def _prefill_and_decode(model, cfg, tok, prompt: int):
    """Logits of positions prompt − 1 .. T − 1 (a prefill of ``prompt``
    tokens through caches of the compute dtype, then one-token steps fed
    ``tok``) and the caches left."""
    caches = init_caches(cfg, tok.shape[0], tok.shape[1],
                         dtype=layers._dt(cfg), device="cpu")
    with torch.no_grad():
        logits, _, caches = model({"tokens": tok[:, :prompt]}, caches)
        out = [logits[:, -1]]
        for t in range(prompt, tok.shape[1]):
            logits, _, caches = model({"tokens": tok[:, t:t + 1]}, caches)
            out.append(logits[:, -1])
    return torch.stack(out, 1), caches


# below one chunk, exactly one chunk, a ragged last chunk, two chunks
PROMPTS = [5, KDA_CHUNK, KDA_CHUNK + 5, 2 * KDA_CHUNK]


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_prefill_then_cached_decode_matches_the_full_forward(prompt, dtype,
                                                             tol):
    cfg = reduced(dtype)
    model, w = model_and_weights(cfg)
    t = 2 * KDA_CHUNK + 6
    tok = tokens(t=t)
    got, caches = _prefill_and_decode(model, cfg, tok, prompt)
    want = ref.logits(w, ref_config(cfg), tok, range(prompt - 1, t))
    assert rel_err(got, want) <= tol
    assert caches["pos"] == caches["ssm"]["pos"][0] == \
        caches["layers"]["pos"][0] == t


@pytest.mark.parametrize("lengths", [
    (5,), (KDA_CHUNK,), (KDA_CHUNK + 5,), (2 * KDA_CHUNK + 3,),
    (7, KDA_CHUNK + 2), (KDA_CHUNK, KDA_CHUNK - 3, 4)],
    ids=lambda x: "+".join(map(str, x)))
def test_a_prefill_leaves_the_caches_token_by_token_decoding_leaves(lengths):
    """The KDA state and conv window of every layer, and the latent
    cache, after cached prefills of ``lengths`` tokens (the chunked rule
    from the cached state, a ragged last chunk padded, a second prefill
    starting inside a chunk) against one-token steps over the same
    tokens."""
    cfg = reduced()
    model, _ = model_and_weights(cfg)
    tok = tokens(t=sum(lengths))

    def caches_after(*parts):
        caches = init_caches(cfg, 2, tok.shape[1], dtype=torch.float32,
                             device="cpu")
        p = 0
        with torch.no_grad():
            for n in parts:
                caches = model({"tokens": tok[:, p:p + n]}, caches)[2]
                p += n
        return caches

    got, want = caches_after(*lengths), caches_after(*[1] * sum(lengths))
    for group in ("ssm", "layers"):
        for k, t in got[group].items():
            if k == "pos":
                assert torch.equal(t, want[group][k])
            else:
                assert rel_err(t, want[group][k]) <= STATE, (group, k)


# ---------------------------------------------------------------------------
# The chunked delta rule
# ---------------------------------------------------------------------------

def _rule_inputs(length: int, a: float = 4.0, beta_lo: float = 0.0,
                 bs: int = 2, nh: int = 3, dk: int = 5, dv: int = 4,
                 seed: int = 0):
    """Inputs of the rule as the mixer makes them: L2-normed keys, scaled
    queries, log decays −A · softplus(·) of up to ``a`` a channel, β in
    [beta_lo, 1)."""
    g = torch.Generator().manual_seed(seed + length)
    q = _l2norm(torch.randn(bs, length, nh, dk, generator=g)) * dk ** -0.5
    k = _l2norm(torch.randn(bs, length, nh, dk, generator=g))
    v = torch.randn(bs, length, nh, dv, generator=g)
    decay = -torch.rand(bs, length, nh, dk, generator=g) * a
    beta = beta_lo + (1 - beta_lo) * torch.rand(bs, length, nh, generator=g)
    s0 = torch.randn(bs, nh, dk, dv, generator=g)
    return q, k, v, decay, beta, s0


def _steps(q, k, v, decay, beta, s0):
    state, out = s0.clone(), []
    for t in range(q.shape[1]):
        out.append(_kda_step(state, q[:, t], k[:, t], v[:, t], decay[:, t],
                             beta[:, t]))
    return torch.stack(out, 1), state


@pytest.mark.parametrize("a,beta_lo", [(4.0, 0.0), (16.0, 0.0),
                                       (0.05, 0.999)],
                         ids=["plain", "strong_decay", "beta_near_1"])
@pytest.mark.parametrize("length", [3, KDA_CHUNK, KDA_CHUNK + 7,
                                    3 * KDA_CHUNK + 1])
@pytest.mark.parametrize("from_state", [False, True], ids=["zero", "state"])
def test_the_chunked_rule_equals_the_token_steps(length, a, beta_lo,
                                                 from_state):
    """Also in groups of one chunk and of two, so the state passes across
    groups as across chunks."""
    q, k, v, decay, beta, s0 = _rule_inputs(length, a, beta_lo)
    if not from_state:
        s0 = torch.zeros_like(s0)
    want_o, want_s = _steps(q, k, v, decay, beta, s0)
    for group in (layers.KDA_GROUP, 2 * KDA_CHUNK, 1):
        o, s = _kda_chunked(q, k, v, decay, beta, s0 if from_state else None,
                            group=group)
        assert o.shape == want_o.shape and s.shape == want_s.shape
        assert rel_err(o, want_o) <= STATE
        assert rel_err(s, want_s) <= STATE


@pytest.mark.parametrize("a,beta_lo", [(4.0, 0.0), (16.0, 0.0),
                                       (0.05, 0.999)],
                         ids=["plain", "strong_decay", "beta_near_1"])
def test_the_references_chunked_rule_equals_its_recurrence(a, beta_lo):
    """Across chunks of 64 and a ragged last chunk, from a state."""
    q, k, v, decay, beta, s0 = _rule_inputs(2 * ref.KDA_CHUNK + 9, a,
                                            beta_lo, bs=1)
    args = (q[0], k[0], v[0], decay[0], beta[0], s0[0])
    want_o, want_s = ref.kda_recurrence(*args)
    o, s = ref.kda(*args)
    assert rel_err(o, want_o) <= STATE and rel_err(s, want_s) <= STATE


def test_the_rule_by_hand():
    """One head of K = V = 1: S ← e^g S; u = β (v − S k); S ← S + k u."""
    state = torch.full((1, 1, 1, 1), 2.0)
    q, k, v, g, beta = (torch.tensor(x).reshape(1, 1, 1) for x in
                        (0.5, 1.0, 3.0, math.log(0.5), 0.25))
    o = _kda_step(state, q, k, v, g, beta.reshape(1, 1))
    # S' = 1; u = 0.25 (3 − 1) = 0.5; S = 1.5; o = 0.75
    assert torch.allclose(state, torch.tensor(1.5).reshape(1, 1, 1, 1))
    assert torch.allclose(o, torch.tensor(0.75).reshape(1, 1, 1))


# ---------------------------------------------------------------------------
# NoPE MLA and the MoE's expert share
# ---------------------------------------------------------------------------

def test_nope_mla_matches_the_reference_and_ignores_positions():
    cfg = reduced()
    model, _ = model_and_weights(cfg)
    mla = model.mla_blocks[0].mixer
    assert isinstance(mla, MLAttention)
    x = torch.randn(2, 21, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    pos = torch.arange(21)[None]
    with torch.no_grad():
        got = mla(x, pos)[0]
        shifted = mla(x, pos + 1000)[0]
    assert torch.equal(got, shifted)
    w = ref.block_weights({n: p.detach() for n, p in mla.named_parameters()},
                          "")
    want = ref.mla_layer(x, w, ref_config(cfg), torch.matmul)
    assert rel_err(got, want) <= 1e-5


def _moe(cfg, full: SigmoidMoE, first: int, held: int) -> SigmoidMoE:
    """A layer holding experts first .. first + held − 1 of ``full``'s."""
    cfg = dataclasses.replace(cfg, experts_held=held, first_expert=first)
    m = SigmoidMoE(cfg, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            q = full.get_parameter(name)
            p.copy_(q[first:first + held]
                    if name in ("w_gate", "w_up", "w_down") else q)
    return m


def test_four_expert_shares_sum_to_the_uncut_layer():
    """Experts 0–1, 2–3, 4–5, 6–7 of 8, as four chips hold them: the
    shares' outputs, with the shared expert (which every chip computes)
    counted once, are the uncut layer's, and each share is the
    reference's for that share."""
    cfg = reduced(experts_held=0)
    model, _ = model_and_weights(cfg)
    full = model.moe_blocks[0].mixer
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        uncut = full(x)[0]
        parts = [_moe(cfg, full, first, 2)(x)[0] for first in (0, 2, 4, 6)]
        shared = full.shared(x)
    assert rel_err(sum(parts) - 3 * shared, uncut) <= 1e-5
    assert not torch.allclose(parts[0], uncut)
    flat = x.reshape(-1, cfg.d_model)
    for first, got in zip((0, 2, 4, 6), parts):
        share = _moe(cfg, full, first, 2)
        w = {n: p.detach() for n, p in share.named_parameters()}
        want = ref.moe(flat, w, ref_config(share.cfg), torch.matmul)
        assert rel_err(got.reshape(flat.shape), want) <= 1e-5


def test_the_experts_are_swiglu():
    cfg = reduced(experts_held=0, experts_per_tok=1)
    m, _ = model_and_weights(cfg)
    moe = m.moe_blocks[0].mixer
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        _, gate, idx = moe.route(x.reshape(1, 5, -1))
        got = moe(x)[0] - moe.shared(x)
        want = torch.stack([
            gate[0, t, 0] * (torch.nn.functional.silu(x[0, t] @ moe.w_gate[e])
                             * (x[0, t] @ moe.w_up[e])) @ moe.w_down[e]
            for t, e in enumerate(idx[0, :, 0].tolist())])
    assert rel_err(got[0], want) <= 1e-5


# ---------------------------------------------------------------------------
# The decode graph and the telemetry
# ---------------------------------------------------------------------------

class Taken(Exception):
    """Raised by the stand-in capture: the forward took the graph's path."""


def _prefilled(m, b: int = 2, t: int = 24, prompt: int = 6):
    caches = init_caches(m.cfg, b, t, device="cpu")
    with torch.no_grad():
        return m({"tokens": tokens(b, prompt)}, caches)[2]


def test_the_graph_rule_admits_this_family(monkeypatch):
    m, _ = model_and_weights(reduced("bfloat16"))
    caches = _prefilled(m)
    monkeypatch.setattr(transformer, "_cuda", lambda t: True)

    def capture(*a, **kw):
        raise Taken
    monkeypatch.setattr(DecodeGraph, "capture", capture)
    assert m.in_graph({"tokens": tokens(2, 1)}, caches)
    with pytest.raises(Taken), torch.no_grad():
        m({"tokens": tokens(2, 1)}, caches)
    assert not m.in_graph({"tokens": tokens(2, 2)}, caches)
    assert transformer._cache_size(m.cfg, caches) == (2, 24)


def test_a_graph_serves_only_the_kda_caches_it_writes():
    """The KDA layers' states and conv windows are the hybrid's recurrent
    cache group, ``ssm``."""
    m, _ = model_and_weights(reduced("bfloat16"))
    held = _prefilled(m)
    graph = DecodeGraph()
    graph.layers, graph.ssm = ({k: t for k, t in held[g].items()
                                if k != "pos"} for g in DecodeGraph.GROUPS)
    assert graph.serves(held)
    other = _prefilled(m)
    assert set(held) == {"pos", "layers", "ssm"}
    assert held["ssm"]["state"].shape == (3, 2, 4, 8, 8)
    assert not graph.serves(dict(held, ssm=other["ssm"]))
    assert not graph.serves(dict(held, layers=other["layers"]))
    m._graph = graph
    with torch.no_grad():
        m({"tokens": tokens(2, 1)}, dict(held, ssm=other["ssm"]))
    assert m._graph is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_step_at_a_device_position_equals_the_eager_step(dtype):
    """The forward a graph records (the caches' position a device tensor)
    against the eager step, every position to the cache's last slot: the
    same logits, latent caches, states and conv windows, bit for bit,
    since both MLA steps sum their attention over the whole latent cache,
    the positions past the step's masked."""
    cfg = reduced(dtype)
    m, _ = model_and_weights(cfg)
    t, prompt = 14, 9
    tok = tokens(2, t)
    same = torch.equal
    eager, graphed = (init_caches(cfg, 2, t, dtype=layers._dt(cfg),
                                  device="cpu") for _ in range(2))
    with torch.no_grad():
        _, _, eager = m({"tokens": tok[:, :prompt]}, eager)
        _, _, graphed = m({"tokens": tok[:, :prompt]}, graphed)
        for p in range(prompt, t):
            want, _, eager = m({"tokens": tok[:, p:p + 1]}, eager)
            got, _, _ = m._forward({"tokens": tok[:, p:p + 1]},
                                   dict(graphed, pos=torch.tensor([p])),
                                   False)
            assert same(got, want), p
            graphed = dict(eager, layers=graphed["layers"],
                           ssm=graphed["ssm"])
    for group in ("layers", "ssm"):
        for k, c in eager[group].items():
            if k != "pos":
                assert same(graphed[group][k], c), (group, k)


def test_a_recorded_step_counts_the_state_bytes_and_the_latent_read():
    m, _ = model_and_weights(reduced("bfloat16"))
    cfg = m.cfg
    caches = _prefilled(m, b=2, t=12)
    with torch.no_grad():
        _, counts = transformer._uncounted(
            lambda: m._forward({"tokens": tokens(2, 1)},
                               dict(caches, pos=torch.tensor([6])), False))
    h, k = cfg.kda_heads, cfg.kda_head_dim
    state = 2 * h * k * k * 4
    conv = 2 * 3 * 3 * h * k * 2
    assert counts["models.kda.state_bytes"] == 3 * 2 * (state + conv)
    # the graph's step reads the whole latent cache of 12
    assert counts["models.mla.latent_bytes"] == 2 * 12 * (16 + 8) * 2
    assert counts["models.moe.pairs"] == 3 * 2 * cfg.experts_per_tok


def test_the_kda_spans_name_the_prefill_and_the_step():
    m, _ = model_and_weights(reduced("bfloat16"))
    telemetry.reset("models.kda.state_bytes")
    with torch.profiler.profile() as prof:
        greedy_decode(m, m.cfg, tokens(2, 6), steps=3)
    names = [e.name for e in prof.events()]
    assert names.count("models.kda.prefill") == 3       # the prefill
    assert names.count("models.kda.step") == 3 * 2      # two steps
    assert telemetry.counter("models.kda.state_bytes") > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _decode(m, prompt, steps: int, max_seq: int | None = None):
    """``greedy_decode``'s tokens and every forward's logits."""
    logits = []
    h = m.register_forward_hook(lambda mod, a, out: logits.append(
        out[0][:, -1].float().clone()))
    try:
        out = greedy_decode(m, m.cfg, prompt, steps=steps, max_seq=max_seq)
    finally:
        h.remove()
    return out, torch.stack(logits[1:])


@pytest.mark.gpu
def test_greedy_decode_through_the_graph_is_bit_equal_to_the_eager_decode(
        monkeypatch):
    dev = cuda_or_skip()
    m, _ = model_and_weights(reduced("bfloat16"), device=dev)
    prompt, steps = tokens(4, 20, device=dev), 12
    telemetry.reset("models.graph.captures", "models.graph.replays")
    got, got_logits = _decode(m, prompt, steps)
    counters = telemetry.snapshot()["counters"]
    assert counters["models.graph.captures"] == 1
    assert counters["models.graph.replays"] == steps - 2
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)
    want, want_logits = _decode(m, prompt, steps)
    assert torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)


@pytest.mark.gpu
def test_the_graph_is_bit_equal_to_eager_at_the_published_mla_widths(
        monkeypatch):
    """Layers KDA+dense and MLA+MoE at the cell's widths (MLA 32 heads,
    latent 512, nope 128 + 64; KDA 32 heads of 128; experts 0–63 of 256),
    2 sequences of 3,000 prompt tokens decoded 6 steps in a cache of
    4,096: the eager one-token MLA step, like the recorded one, attends
    over the whole latent cache, so their logits are bit-equal where
    sums over thousands of positions round differently by length."""
    dev = cuda_or_skip()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=4,
                              block_pattern="KDLE")
    assert (cfg.n_heads, cfg.kv_lora_rank, cfg.hd, cfg.rope_head_dim,
            cfg.held, cfg.n_experts) == (32, 512, 128, 64, 64, 256)
    m, _ = model_and_weights(cfg, device=dev)
    prompt, steps = tokens(2, 3000, device=dev), 6
    telemetry.reset("models.graph.replays")
    got, got_logits = _decode(m, prompt, steps, max_seq=4096)
    assert telemetry.counter("models.graph.replays") == steps - 2
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)
    want, want_logits = _decode(m, prompt, steps, max_seq=4096)
    assert torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)


@pytest.mark.gpu
def test_a_replayed_step_does_not_synchronise():
    """From the first replay (the third forward) on, decoding raises
    nothing under the sync-debug mode "error"."""
    dev = cuda_or_skip()
    m, _ = model_and_weights(reduced("bfloat16"), device=dev)
    seen = [0]
    mode = torch.cuda.get_sync_debug_mode()

    def strict(*_):
        seen[0] += 1
        if seen[0] == 3:
            torch.cuda.set_sync_debug_mode("error")
    h = m.register_forward_pre_hook(strict)
    try:
        greedy_decode(m, m.cfg, tokens(4, 20, device=dev), steps=8)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        h.remove()
    assert seen[0] == 8


@pytest.mark.gpu
def test_the_chunked_rule_on_the_card_equals_the_cpu():
    """The rule at the cell's head sizes (32 heads of 128), 2 sequences of
    a ragged 3 chunks from a state: the card's float32 against the CPU's
    (no TF32 in either: the products are float32 cuBLAS)."""
    dev = cuda_or_skip()
    args = _rule_inputs(3 * KDA_CHUNK + 5, 4.0, 0.0, nh=32, dk=128, dv=128)
    want_o, want_s = _kda_chunked(*args)
    o, s = _kda_chunked(*(x.to(dev) for x in args))
    assert rel_err(o.cpu(), want_o) <= STATE
    assert rel_err(s.cpu(), want_s) <= STATE
