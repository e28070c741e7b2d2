"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``), held
against the plain float32 reference ``simbench/reference/mla_moe_lm.py``
on seeded weights at the reduced size: one dense layer, then 2 MoE layers
of 8 experts (top-3, 1 shared), latent 32, rope 8, vocab 256.  The
reference package has no such model, so the oracle is the published
model's math in plain PyTorch, which imports nothing of the port.

Tolerances: float32 compute (and a float32 latent cache) agrees with the
float32 reference up to rounding (the port absorbs ``w_uk`` in decode and
sums in other orders): 1e-4 × max|logit|, the port's float32 rule, where
the reference with its weight products rounded to bf16 misses by ~20
times that.  The cell's bf16 compute and bf16 cache are held to the
port's bf16 rule, 5e-2 × max|logit|.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import DeepSeekV2Config, ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import MoE, yarn_freqs, yarn_mscale
from repro_torch.models.transformer import Transformer, init_caches
from repro_torch.serve.decode import make_prefill, make_serve_step
from simbench.reference import mla_moe_lm as ref

F32 = 1e-4                  # × max|logit|: float32 against float32
BF16 = 5e-2                 # × max|logit|: bf16 compute against float32


def reduced(dtype: str = "float32") -> DeepSeekV2Config:
    return dataclasses.replace(get_reduced("deepseek-v2-lite"),
                               param_dtype=dtype, compute_dtype=dtype)


def ref_config(cfg) -> dict:
    """The published keys of the port's config, for the reference."""
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
        "q_lora_rank": None, "qk_nope_head_dim": cfg.hd,
        "qk_rope_head_dim": cfg.rope_head_dim, "v_head_dim": cfg.hd,
        "intermediate_size": cfg.d_ff, "moe_intermediate_size": cfg.d_expert,
        "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.experts_per_tok,
        "n_shared_experts": cfg.n_shared_experts,
        "first_k_dense_replace": cfg.first_k_dense,
        "norm_topk_prob": cfg.norm_topk_prob, "routed_scaling_factor": 1,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "vocab_size": cfg.vocab,
        "rope_scaling": {"factor": cfg.yarn_factor,
                         "original_max_position_embeddings":
                             layers.YARN_ORIGINAL_POSITIONS,
                         "beta_fast": layers.YARN_BETA_FAST,
                         "beta_slow": layers.YARN_BETA_SLOW,
                         "mscale": cfg.yarn_mscale,
                         "mscale_all_dim": cfg.yarn_mscale}}


def model_and_weights(cfg, seed: int = 28):
    model = Transformer(cfg, "cpu").draw_params(
        torch.Generator("cpu").manual_seed(seed))
    # the router and the scales are drawn like the rest (not ones), so
    # the latent norm and the routing are exercised
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.uniform_(0.5, 1.5, generator=torch.Generator(
                    "cpu").manual_seed(len(name)))
    return model, {n: p.detach() for n, p in model.named_parameters()}


def tokens(b: int = 2, t: int = 24, seed: int = 5):
    return torch.randint(0, 256, (b, t),
                         generator=torch.Generator().manual_seed(seed))


def rel_err(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def bf16_matmul(a, b):
    return (a.bfloat16() @ b.bfloat16()).float()


def test_found_by_name_and_not_among_the_reference_archs():
    cfg = get_config("deepseek-v2-lite")
    assert isinstance(cfg, DeepSeekV2Config) and "deepseek_v2_lite" not in ARCHS
    assert len(ARCHS) == 10
    assert round(cfg.param_count() / 1e9, 2) == 15.71
    for arch in ARCHS:           # the ten keep every option off
        c = get_config(arch)
        assert type(c) is ModelConfig and not c.dropless
        assert (c.first_k_dense, c.kv_norm, c.yarn_factor,
                c.norm_topk_prob) == (0, False, 1.0, True)


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
    """Logits of positions prompt − 1 .. T − 1: a prefill of ``prompt``
    tokens through caches of the compute dtype, then one-token steps fed
    ``tok``."""
    caches = init_caches(cfg, tok.shape[0], tok.shape[1],
                         dtype=layers._dt(cfg), device="cpu")
    logits, caches = make_prefill(cfg)(model, {"tokens": tok[:, :prompt]},
                                       caches)
    out = [logits[:, -1]]
    step = make_serve_step(cfg)
    for t in range(prompt, tok.shape[1]):
        logits, caches = step(model, caches, {"tokens": tok[:, t:t + 1]})
        out.append(logits[:, -1])
    return torch.stack(out, 1)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_prefill_then_cached_decode_matches_the_full_forward(dtype, tol):
    cfg = reduced(dtype)
    model, w = model_and_weights(cfg)
    tok = tokens(t=30)
    with torch.no_grad():
        got = _prefill_and_decode(model, cfg, tok, prompt=18)
    want = ref.logits(w, ref_config(cfg), tok, range(17, 30))
    assert rel_err(got, want) <= tol


def test_blocked_cached_prefill_equals_the_unblocked(monkeypatch):
    """A multi-token step through the caches, at positions 0 and again at
    20, the second attending the first's keys: the online-softmax path in
    blocks of 8 (a threshold lowered to 4, the blocks passed to
    ``MLAttention._explicit``) against the absorbed path.  Layer 0 caches
    the same latent either way; later layers' inputs carry the first
    layer's rounding."""
    cfg = reduced()
    model, _ = model_and_weights(cfg)
    tok = tokens(t=36)

    def run():
        caches = init_caches(cfg, 2, 40, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            a, _, caches = model({"tokens": tok[:, :20]}, caches)
            b, _, caches = model({"tokens": tok[:, 20:]}, caches)
        return torch.cat([a, b], 1), caches["layers"]["c"].clone()

    plain, plain_c = run()
    calls, blocks = [], []
    explicit, flash = layers.MLAttention._explicit, layers._flash_attn

    def in_blocks_of_8(self, q_nope, q_rope, c, k_rope, q_offset):
        calls.append((q_nope.shape[1], c.shape[1], q_offset))
        return explicit(self, q_nope, q_rope, c, k_rope, q_offset,
                        block_q=8, block_k=8)

    def counted(*a, **kw):
        blocks.append((kw["block_q"], kw["block_k"]))
        return flash(*a, **kw)
    monkeypatch.setattr(layers, "FLASH_THRESHOLD", 4)
    monkeypatch.setattr(layers.MLAttention, "_explicit", in_blocks_of_8)
    monkeypatch.setattr(layers, "_flash_attn", counted)
    blocked, blocked_c = run()
    # every layer, both steps: (queries, keys written so far, offset),
    # each through the online-softmax path
    assert calls == [(20, 20, 0)] * 3 + [(16, 36, 20)] * 3
    assert blocks == [(8, 8)] * 6
    assert torch.equal(plain_c[0], blocked_c[0])
    assert rel_err(blocked_c, plain_c) <= F32
    assert rel_err(blocked, plain) <= F32


def test_rope_is_made_once_a_forward_and_decode_reads_written_positions(
        monkeypatch):
    """The :class:`Transformer` makes MLA's cos/sin once for all its
    layers; a one-token step's output depends on the positions written so
    far alone: it scores the whole cache, as the step a decode graph
    records does, the positions past its own masked, so garbage there
    changes no bit; it counts the latent and rope-key bytes it reads, the
    whole cache's."""
    from repro_torch import telemetry
    cfg = reduced()
    model, _ = model_and_weights(cfg)
    tok = tokens(t=12)
    made = []
    rope = layers.MLAttention.rope

    def counted(self, positions, dtype):
        made.append(positions.shape[-1])
        return rope(self, positions, dtype)
    monkeypatch.setattr(layers.MLAttention, "rope", counted)
    caches = init_caches(cfg, 2, 40, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        _, _, caches = model({"tokens": tok[:, :10]}, caches)
        dirty = {**caches, "layers": {k: v.clone() for k, v in
                                      caches["layers"].items()}}
        for k in ("c", "k_rope"):
            dirty["layers"][k][:, :, 11:].normal_(0, 1e3)
        telemetry.reset()
        want, _, caches = model({"tokens": tok[:, 10:11]}, caches)
        got = telemetry.snapshot()["counters"]["models.mla.latent_bytes"]
        dirty_logits, _, _ = model({"tokens": tok[:, 10:11]}, dirty)
    assert made == [10, 1, 1]
    assert torch.equal(dirty_logits, want)
    # 3 layers × batch 2 × 40 positions × (latent 32 + rope 8) × 4 bytes
    assert got == 3 * 2 * 40 * (32 + 8) * 4


def test_flash_skips_only_blocks_wholly_masked():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 40, 4, 12, generator=g) for _ in range(3))
    want = layers._sdpa_naive(q, k, v, causal=True, q_offset=0)
    got = layers._flash_attn(q, k, v, causal=True, block_q=8, block_k=8)
    assert rel_err(got, want) <= 1e-5
    kk = torch.randn(2, 56, 4, 12, generator=g)
    vv = torch.randn(2, 56, 4, 12, generator=g)
    want = layers._sdpa_naive(q, kk, vv, causal=True, q_offset=16)
    got = layers._flash_attn(q, kk, vv, causal=True, q_offset=16,
                             block_q=8, block_k=16)
    assert rel_err(got, want) <= 1e-5


def _moes(norm: bool):
    """A dropless MoE and a capacity-bound one whose capacity holds every
    token, on the same parameters."""
    cfg = dataclasses.replace(reduced(), norm_topk_prob=norm)
    drop = MoE(cfg, "cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in drop.parameters():
            p.normal_(generator=g).mul_(0.3)
    full = MoE(dataclasses.replace(
        cfg, dropless=False,
        capacity_factor=cfg.n_experts / cfg.experts_per_tok), "cpu")
    full.load_state_dict(drop.state_dict())
    x = torch.randn(3, 10, cfg.d_model, generator=g)
    return cfg, drop, full, x


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "renormalised"])
def test_dropless_equals_a_capacity_that_drops_nothing(norm):
    _, drop, full, x = _moes(norm)
    with torch.no_grad():
        got, aux = drop(x)
        want, want_aux = full(x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert torch.allclose(aux, want_aux, rtol=1e-6)


def test_gates_are_the_probabilities_not_renormalised():
    cfg, drop, _, x = _moes(False)
    with torch.no_grad():
        got = drop(x)[0].reshape(-1, cfg.d_model)
        flat = x.reshape(-1, cfg.d_model)
        probs = torch.softmax(flat @ drop.router, -1)
        gate, chosen = torch.topk(probs, cfg.experts_per_tok)
        assert float(gate.sum(-1).mean()) < 0.95     # not summing to 1
        want = drop.shared(flat[None])[0]
        for t in range(flat.shape[0]):
            for j in range(cfg.experts_per_tok):
                e = int(chosen[t, j])
                h = (torch.nn.functional.silu(flat[t] @ drop.w_gate[e])
                     * (flat[t] @ drop.w_up[e]))
                want[t] += gate[t, j] * (h @ drop.w_down[e])
    assert rel_err(got, want) <= 1e-5


def test_yarn_frequencies_and_scale_by_hand():
    cfg = get_config("deepseek-v2-lite")
    inv = yarn_freqs(cfg, 64)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # correction range: floor(64·ln(4096/(32·2π)) / (2·ln 1e4)) = 10,
    # ceil(64·ln(4096/(2π)) / (2·ln 1e4)) = 23; original frequencies
    # below dim 10, ÷ 40 from dim 23, a linear ramp between
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    assert torch.allclose(inv.double(), want, rtol=1e-6)
    assert inv[0] == 1.0 and inv[31] == pytest.approx(base[31] / 40)
    m = yarn_mscale(40, 0.707)
    assert m == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert yarn_mscale(1.0, 0.707) == 1.0
    # the reference computes both on its own
    assert torch.equal(inv, ref.yarn_inv_freq(ref_config(cfg)))
    assert ref.softmax_scale(ref_config(cfg)) == pytest.approx(
        192 ** -0.5 * m * m)


def test_parameters_are_held_in_param_dtype():
    lite = Transformer(reduced("bfloat16"), "cpu")
    assert {p.dtype for p in lite.parameters()} == {torch.bfloat16}
    olmoe = Transformer(get_reduced("olmoe-1b-7b"), "cpu")
    assert {p.dtype for p in olmoe.parameters()} == {torch.float32}
    d = layers.P((3, 4), ("embed", None))
    assert layers._param(d, "cpu").dtype == torch.float32
    assert layers._param(d, "cpu", torch.bfloat16).dtype == torch.bfloat16


def test_the_leading_dense_layer_has_the_ports_names():
    model = Transformer(get_config("deepseek-v2-lite"), "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["blocks.0.ffn.w_gate"] == (2048, 10944)
    assert shapes["blocks.0.ffn.w_down"] == (10944, 2048)
    assert shapes["blocks.1.ffn.w_gate"] == (64, 2048, 1408)
    assert shapes["blocks.26.ffn.shared.w_up"] == (2048, 2816)
    assert shapes["blocks.3.attn.kv_norm.scale"] == (512,)
    assert "blocks.0.ffn.router" not in shapes
    assert sum(math.prod(s) for s in shapes.values()) == (
        model.cfg.param_count() + 27 * 2 * 2048 + 2048)


def test_load_params_fills_the_dense_and_moe_blocks():
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import leaf_names, model_defs
    cfg = reduced()
    defs = model_defs(cfg)
    assert defs["dense_blocks"]["ffn"]["w_gate"].shape == (1, 64, 96)
    assert defs["blocks"]["ffn"]["w_gate"].shape == (2, 8, 64, 32)
    tree = init_params(defs, torch.Generator("cpu").manual_seed(1),
                       device="cpu")
    model = Transformer(cfg, "cpu").load_params(tree)
    assert torch.equal(model.blocks[0].ffn.w_gate,
                       tree["dense_blocks"]["ffn"]["w_gate"][0])
    assert torch.equal(model.blocks[2].ffn.w_up, tree["blocks"]["ffn"]["w_up"][1])
    names = [n for group in leaf_names(cfg) for n in group]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite"])
def test_prefill_head_runs_on_the_last_position(arch):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32",
                              compute_dtype="float32")
    model = Transformer(cfg, "cpu").draw_params(
        torch.Generator("cpu").manual_seed(2))
    tok = tokens(t=16)
    with torch.no_grad():
        full = model({"tokens": tok}, init_caches(cfg, 2, 20, device="cpu"))[0]
        caches = init_caches(cfg, 2, 20, device="cpu")
        last, _ = make_prefill(cfg)(model, {"tokens": tok}, caches)
    assert last.shape == (2, 1, cfg.vocab) and last.dtype == torch.float32
    assert torch.allclose(last, full[:, -1:], rtol=1e-5, atol=1e-6)


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_decode_step_does_not_synchronise():
    """On the card, a one-token step of the reduced model in the cell's
    dtypes (the dropless routing and grouped products, the absorbed
    latent decode) raises nothing under the sync-debug mode "error" and
    equals the same step run without it."""
    dev = cuda_or_skip()
    cfg = reduced("bfloat16")
    model = Transformer(cfg, dev).draw_params(
        torch.Generator(dev).manual_seed(4))
    tok = tokens(b=4, t=24).to(dev)
    outs = []
    for debug in (False, True):
        caches = init_caches(cfg, 4, 32, device=dev)
        with torch.no_grad():
            _, _, caches = model({"tokens": tok[:, :20]}, caches)
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(model({"tokens": tok[:, 20:21]}, caches)[0])
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    assert torch.equal(outs[0], outs[1])
