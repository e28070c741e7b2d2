"""Nemotron 3 Nano (``nemotron_h``) in the port
(``configs/nemotron_3_nano_30b_a3b.py``), held against the plain float32
reference ``simbench/reference/hybrid_moe_lm.py`` on seeded weights at
the reduced size: ``MEM*EME`` at d_model 64, Mamba-2 4 heads of 8 in 2
groups of state 8 (chunk 8), 4 of 8 sigmoid-routed relu² experts held
(top-3) and a shared expert, GQA 4/2 heads of 16, vocab 256.  The
reference package has no such model, so the oracle is the published
model's math in plain PyTorch, which imports nothing of the port; its SSD
is the quadratic form over the whole sequence, not the port's chunked
scan, so the cache handoff is held against an independent formula.

Tolerances: float32 compute agrees with the float32 reference up to
rounding (other summation orders): 1e-4 × max|logit|, the port's float32
rule, which the reference with its weight products rounded to bf16
misses.  The cell's bf16 compute is held to the port's bf16 rule, 5e-2 ×
max|logit|.  The chunked SSD and the cached states are float32 sums of a
few terms against the recurrence: 1e-5 of their largest magnitude.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import NemotronHConfig
from repro_torch.models import layers, transformer
from repro_torch.models.layers import SigmoidMoE, _ssd_scan
from repro_torch.models.transformer import (DecodeGraph, Transformer,
                                            init_caches, leaf_names,
                                            model_defs)
from repro_torch.serve.decode import greedy_decode
from simbench.reference import hybrid_moe_lm as ref

ARCH = "nemotron-3-nano-30b-a3b"
F32 = 1e-4                  # × max|logit|: float32 against float32
BF16 = 5e-2                 # × max|logit|: bf16 compute against float32
STATE = 1e-5                # × max|state|: float32 scan against recurrence


def reduced(dtype: str = "float32", **fields) -> NemotronHConfig:
    return dataclasses.replace(get_reduced(ARCH), param_dtype=dtype,
                               compute_dtype=dtype, **fields)


def ref_config(cfg) -> dict:
    """The published keys of the port's config, for the reference."""
    return {
        "hybrid_override_pattern": cfg.block_pattern,
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
        "mamba_num_heads": cfg.ssm_heads, "mamba_head_dim": cfg.ssm_head_dim,
        "n_groups": cfg.ssm_groups, "ssm_state_size": cfg.ssm_state,
        "layer_norm_epsilon": cfg.norm_eps,
        "moe_intermediate_size": cfg.d_expert,
        "moe_shared_expert_intermediate_size": cfg.shared_expert_width,
        "n_routed_experts": cfg.held,
        "expert_share": {"published_n_routed_experts": cfg.n_experts,
                         "first_expert": cfg.first_expert},
        "num_experts_per_tok": cfg.experts_per_tok,
        "routed_scaling_factor": cfg.routed_scaling,
        "vocab_size": cfg.vocab}


def model_and_weights(cfg, seed: int = 32, device="cpu"):
    """The model drawn from ``seed``, its Mamba-2 parameters and scales
    drawn as the cell's are (``A_log = log U[1, 16]``, dt_bias the
    softplus⁻¹ of dt log-uniform in [1e-3, 0.1], D, the norm scales, the
    conv bias and the router's choice bias not at their init), so every
    mechanism is exercised."""
    model = Transformer(cfg, device).draw_params(
        torch.Generator(device).manual_seed(seed))
    gen = torch.Generator(device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "d_skip"):
                p.uniform_(0.5, 1.5, generator=gen)
            elif leaf == "a_log":
                p.uniform_(1.0, 16.0, generator=gen).log_()
            elif leaf == "dt_bias":
                dt = torch.empty_like(p, dtype=torch.float32).uniform_(
                    math.log(1e-3), math.log(0.1), generator=gen).exp()
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf == "conv_b":
                p.uniform_(-0.5, 0.5, generator=gen)
            elif leaf == "choice_bias":
                p.normal_(generator=gen).mul_(0.02)
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
    assert isinstance(cfg, NemotronHConfig) and "nemotron_3_nano_30b_a3b" \
        not in ARCHS and len(ARCHS) == 10
    assert cfg.param_count() == 16_890_536_256
    assert dataclasses.replace(cfg, experts_held=0).param_count() \
        == 31_577_940_288
    assert cfg.pattern().count("ssm") == cfg.pattern().count("moe") == 23
    assert cfg.pattern().count("attn") == 6
    assert (cfg.d_inner, cfg.n_ssm_heads, cfg.held, cfg.n_experts) == (
        4096, 64, 64, 128)
    for arch in ARCHS:           # the ten keep their own class
        assert not isinstance(get_config(arch), NemotronHConfig)


def test_the_defs_are_the_modules_parameters():
    cfg = get_reduced(ARCH)
    m = Transformer(cfg, "meta")
    names = [n for leaf in leaf_names(cfg) for n in leaf]
    assert sorted(names) == sorted(n for n, _ in m.named_parameters())
    assert sum(p.numel() for p in m.parameters()) == cfg.param_count()
    defs = model_defs(cfg)
    assert defs["moe_blocks"]["mixer"]["router"].shape == (3, 64, 8)
    assert defs["moe_blocks"]["mixer"]["w_up"].shape == (3, 4, 64, 32)
    assert defs["attn_blocks"]["mixer"]["wk"].shape == (1, 64, 2, 16)
    assert defs["ssm_blocks"]["mixer"]["w_in"].shape == (3, 64, 32 + 64 + 4)


@pytest.mark.parametrize("fields,match", [
    ({"ffn_act": "silu"}, "ffn_act"), ({"router": "softmax"}, "router"),
    ({"experts_held": 4, "first_expert": 6}, "not among"),
    ({"ssm_groups": 3}, "multiple")])
def test_settings_the_port_does_not_compute_are_refused(fields, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(get_reduced(ARCH), **fields)


# ---------------------------------------------------------------------------
# The whole model against the reference
# ---------------------------------------------------------------------------

def test_full_forward_matches_the_reference():
    cfg = reduced()
    model, w = model_and_weights(cfg)
    tok = tokens()
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
    tok = tokens()
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
PROMPTS = [5, 8, 13, 16]


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_prefill_then_cached_decode_matches_the_full_forward(prompt, dtype,
                                                             tol):
    cfg = reduced(dtype)
    model, w = model_and_weights(cfg)
    tok = tokens(t=22)
    got, caches = _prefill_and_decode(model, cfg, tok, prompt)
    want = ref.logits(w, ref_config(cfg), tok, range(prompt - 1, 22))
    assert rel_err(got, want) <= tol
    assert caches["pos"] == caches["ssm"]["pos"][0] == \
        caches["layers"]["pos"][0] == 22


@pytest.mark.parametrize("prompt", PROMPTS)
def test_a_prefill_leaves_the_caches_token_by_token_decoding_leaves(prompt):
    """The state and conv window of every Mamba-2 layer, and the KV cache,
    after one cached prefill of ``prompt`` tokens (the chunked scan from
    the zeroed state, its last chunk padded) against ``prompt`` one-token
    steps; then a second prefill from those caches against more steps."""
    cfg = reduced()
    model, _ = model_and_weights(cfg)
    tok = tokens(t=prompt + 11)

    def caches_after(*lengths):
        caches = init_caches(cfg, 2, tok.shape[1], dtype=torch.float32,
                             device="cpu")
        p = 0
        with torch.no_grad():
            for n in lengths:
                caches = model({"tokens": tok[:, p:p + n]}, caches)[2]
                p += n
        return caches

    def same(a, b):
        for group in ("ssm", "layers"):
            for k, t in a[group].items():
                if k == "pos":
                    assert torch.equal(t, b[group][k])
                else:
                    assert rel_err(t, b[group][k]) <= STATE, (group, k)

    same(caches_after(prompt), caches_after(*[1] * prompt))
    same(caches_after(prompt, 11), caches_after(*[1] * (prompt + 11)))


# ---------------------------------------------------------------------------
# The grouped SSD scan
# ---------------------------------------------------------------------------

def _recurrence(x, dt, la, b, c, h0):
    """The SSD one token at a time: h ← exp(la) h + (x dt) ⊗ B, y = h · C,
    head h reading group h // (heads / groups)."""
    rep = x.shape[2] // b.shape[2]
    h, ys = h0.clone(), []
    for t in range(x.shape[1]):
        bh = b[:, t].repeat_interleave(rep, 1)
        ch = c[:, t].repeat_interleave(rep, 1)
        h = (h * torch.exp(la[:, t])[..., None, None]
             + (x[:, t] * dt[:, t, :, None])[..., None] * bh[:, :, None, :])
        ys.append(torch.einsum("bhdn,bhn->bhd", h, ch))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("length", [3, 8, 21, 32])
@pytest.mark.parametrize("from_state", [False, True], ids=["zero", "state"])
def test_the_chunked_grouped_ssd_equals_the_recurrence(length, from_state):
    g = torch.Generator().manual_seed(length)
    bs, nh, hd, groups, n, chunk = 2, 6, 3, 3, 5, 8
    x = torch.randn(bs, length, nh, hd, generator=g)
    dt = torch.rand(bs, length, nh, generator=g) * 0.5
    la = -torch.rand(nh, generator=g) * 4 * dt
    b, c = (torch.randn(bs, length, groups, n, generator=g) for _ in "bc")
    h0 = (torch.randn(bs, nh, hd, n, generator=g) if from_state
          else torch.zeros(bs, nh, hd, n))
    want_y, want_h = _recurrence(x, dt, la, b, c, h0)
    y, h = _ssd_scan(x * dt[..., None], la, b, c, chunk,
                     h0 if from_state else None)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert rel_err(y, want_y) <= STATE
    assert rel_err(h, want_h) <= STATE


# ---------------------------------------------------------------------------
# The MoE: the expert share and the router
# ---------------------------------------------------------------------------

def _moe(cfg, full: SigmoidMoE, first: int, held: int) -> SigmoidMoE:
    """A layer holding experts first .. first + held − 1 of ``full``'s."""
    cfg = dataclasses.replace(cfg, experts_held=held, first_expert=first)
    m = SigmoidMoE(cfg, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            q = full.get_parameter(name)
            p.copy_(q[first:first + held] if name in ("w_up", "w_down")
                    else q)
    return m


def test_two_expert_shares_sum_to_the_uncut_layer():
    """Experts 0–3 and 4–7 of 8: the two layers' outputs, with the shared
    expert (which every chip computes) counted once, are the uncut
    layer's, and each share is the reference's for that share."""
    cfg = reduced(experts_held=0)
    model, _ = model_and_weights(cfg)
    full = model.moe_blocks[0].mixer
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        uncut = full(x)[0]
        lo, hi = (_moe(cfg, full, first, 4)(x)[0] for first in (0, 4))
        shared = full.shared(x)
    assert rel_err(lo + hi - shared, uncut) <= 1e-5
    assert not torch.allclose(lo, uncut)
    flat = x.reshape(-1, cfg.d_model)
    for first, got in ((0, lo), (4, hi)):
        share = _moe(cfg, full, first, 4)
        w = {n: p.detach() for n, p in share.named_parameters()}
        want = ref.moe(flat, w, ref_config(share.cfg), torch.matmul)
        assert rel_err(got.reshape(flat.shape), want) <= 1e-5


def _router(bias):
    """A layer of 4 experts (top-2, scaling 2.5) whose router makes token
    0's scores 0.9, 0.8, 0.7, 0.1."""
    cfg = reduced(d_model=4, n_experts=4, experts_per_tok=2, experts_held=0)
    m = SigmoidMoE(cfg, "cpu")
    with torch.no_grad():
        m.router.copy_(torch.eye(4))
        m.choice_bias.copy_(torch.tensor(bias))
    p = torch.tensor([0.9, 0.8, 0.7, 0.1], dtype=torch.float64)
    return m, torch.log(p / (1 - p)).float()[None, None]


def test_the_router_by_hand():
    m, tok = _router([0.0, 0.0, 0.0, 0.0])
    scores, gate, idx = m.route(tok)
    assert torch.allclose(scores[0, 0], torch.tensor([0.9, 0.8, 0.7, 0.1]))
    assert idx[0, 0].tolist() == [0, 1]
    # the chosen scores over their sum, then times 2.5
    assert torch.allclose(gate[0, 0], torch.tensor([0.9, 0.8]) / 1.7 * 2.5)
    # the bias changes the choice, and is in no gate
    m, tok = _router([0.0, 0.0, 0.3, 0.0])
    _, gate, idx = m.route(tok)
    assert idx[0, 0].tolist() == [2, 0]
    assert torch.allclose(gate[0, 0], torch.tensor([0.7, 0.9]) / 1.6 * 2.5)
    chosen, ref_gate = ref.route(tok[0], m.router.detach(),
                                 m.choice_bias.detach(),
                                 {"num_experts_per_tok": 2,
                                  "routed_scaling_factor": 2.5})
    assert chosen.tolist() == idx[0].tolist()
    assert torch.allclose(ref_gate, gate[0])


# ---------------------------------------------------------------------------
# The decode graph
# ---------------------------------------------------------------------------

class Taken(Exception):
    """Raised by the stand-in capture: the forward took the graph's path."""


def _prefilled(m, b: int = 2, t: int = 12, prompt: int = 6):
    caches = init_caches(m.cfg, b, t, device="cpu")
    with torch.no_grad():
        return m({"tokens": tokens(b, prompt)}, caches)[2]


def test_the_graph_rule_admits_this_family(monkeypatch):
    """A one-token step on the card (``transformer._cuda`` stood in for)
    takes the graph; a multi-token step does not."""
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
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)
    assert not m.in_graph({"tokens": tokens(2, 1)}, caches)


def test_a_graph_serves_only_the_ssm_caches_it_writes():
    m, _ = model_and_weights(reduced("bfloat16"))
    held = _prefilled(m)
    graph = DecodeGraph()
    graph.layers, graph.ssm = ({k: t for k, t in held[g].items()
                                if k != "pos"} for g in DecodeGraph.GROUPS)
    assert graph.serves(held)
    other = _prefilled(m)
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
    same logits, KV caches, states and conv windows."""
    cfg = reduced(dtype)
    m, _ = model_and_weights(cfg)
    t, prompt = 14, 9
    tok = tokens(2, t)
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
            assert torch.equal(got, want), p
            graphed = dict(eager, layers=graphed["layers"],
                           ssm=graphed["ssm"])
    for group in ("layers", "ssm"):
        for k, c in eager[group].items():
            if k != "pos":
                assert torch.equal(graphed[group][k], c), (group, k)


def test_a_replay_adds_the_state_bytes_the_recorded_step_added():
    m, _ = model_and_weights(reduced("bfloat16"))
    cfg = m.cfg
    caches = _prefilled(m, b=2, t=12)
    with torch.no_grad():
        _, counts = transformer._uncounted(
            lambda: m._forward({"tokens": tokens(2, 1)},
                               dict(caches, pos=torch.tensor([6])), False))
    state = 2 * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    conv = 2 * 3 * layers.mamba2_conv_channels(cfg) * 2
    assert counts["models.ssm.state_bytes"] == 3 * 2 * (state + conv)
    assert counts["models.moe.pairs"] == 3 * 2 * cfg.experts_per_tok


def test_the_ssm_spans_name_the_scan_and_the_step():
    m, _ = model_and_weights(reduced("bfloat16"))
    telemetry.reset("models.ssm.state_bytes")
    with torch.profiler.profile() as prof:
        greedy_decode(m, m.cfg, tokens(2, 6), steps=3)
    names = [e.name for e in prof.events()]
    assert names.count("models.ssm.scan") == 3          # the prefill
    assert names.count("models.ssm.step") == 3 * 2      # two steps
    assert telemetry.counter("models.ssm.state_bytes") > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _decode(m, prompt, steps: int):
    """``greedy_decode``'s tokens and every forward's logits."""
    logits = []
    h = m.register_forward_hook(lambda mod, a, out: logits.append(
        out[0][:, -1].float().clone()))
    try:
        out = greedy_decode(m, m.cfg, prompt, steps=steps)
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
