"""The dense model stack: ``repro_torch.models`` held against
``repro.models`` on the CPU.

The reference's parameters (``repro.models.params.init_params``) are carried
across with ``repro_torch.interop.params_from_reference``, and the same
numpy-seeded tokens go through both packages.  Tolerances:

* float32 compute: |port − reference| ≤ 1e-4 × max|reference logit| (the
  two frameworks sum in other orders and round ``sin``/``cos``/``rsqrt``
  differently in the last place);
* bfloat16 compute: ≤ 5e-2 × max|reference logit| (every einsum rounds its
  output to bf16, and XLA's CPU fusions keep some elementwise
  intermediates in float32 where PyTorch rounds each op);
* greedy ids are equal wherever the reference's top-2 gap exceeds the
  tolerance;
* the port's own cached decode against its no-cache forward: 2e-3
  absolute, the reference tests' bound (``tests/test_models.py``);
* ``pum_mlp``'s output and gradients: ≤ 1e-4 × max|reference value| in
  float32; the binarized contraction against K3: exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.layers as ref_layers
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro_torch.configs as port_configs
import repro_torch.models.layers as port_layers
import repro_torch.models.params as port_params
import repro_torch.models.transformer as port_tf
from repro.kernels.bitserial_matmul import pack_signs as ref_pack_signs
from repro_torch.interop import params_from_reference
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_plain,
                                                  pack_signs)

F32_REL, BF16_REL, SELF_ABS = 1e-4, 5e-2, 2e-3
ARCHS = ("qwen1_5_0_5b", "qwen2_vl_2b", "stablelm_12b")
# the reference's forward, compiled once per config and shape
ref_forward = jax.jit(ref_tf.forward, static_argnums=(1,))


def configs(arch: str, **over):
    """(reference cfg, port cfg) of ``arch``'s reduced config."""
    return (dataclasses.replace(ref_configs.get_reduced(arch), **over),
            dataclasses.replace(port_configs.get_reduced(arch), **over))


def ref_tree(cfg, seed: int = 1):
    params = ref_params.init_params(ref_tf.model_defs(cfg),
                                    jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def models(arch: str, seed: int = 1, **over):
    """(ref cfg, ref params, port cfg, port model) with equal parameters."""
    rcfg, pcfg = configs(arch, **over)
    tree = ref_tree(rcfg, seed)
    params = jax.tree.map(jnp.asarray, tree)
    return rcfg, params, pcfg, params_from_reference(pcfg, tree, "cpu")


def tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def batches(cfg, toks: np.ndarray, start: int = 0):
    """The same batch for the reference and the port (M-RoPE ids for the
    vlm family, every section at the token's position)."""
    ref = {"tokens": jnp.asarray(toks)}
    port = {"tokens": torch.from_numpy(toks).long()}
    if cfg.rope == "mrope":
        b, s = toks.shape
        pos = np.broadcast_to(np.arange(start, start + s)[None, :, None],
                              (b, s, 3)).astype(np.int32)
        ref["mrope_positions"] = jnp.asarray(pos)
        port["mrope_positions"] = torch.from_numpy(pos.copy())
    return ref, port


def assert_logits_close(got, want, rel: float):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def assert_scaled_close(got, want, rel: float = F32_REL):
    """|got − want| ≤ rel × max|want| (sums of many products cancel, so an
    elementwise relative bound would test the summation order)."""
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def ref_caches(cfg, b, t, dtype=jnp.float32):
    shapes = ref_tf.init_cache_shapes(cfg, b, t, dtype=dtype)
    return jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_defs_specs_and_bytes_match_reference(arch):
    rcfg, pcfg = configs(arch)
    rdefs, pdefs = ref_tf.model_defs(rcfg), port_tf.model_defs(pcfg)
    ref_leaves = jax.tree.leaves_with_path(
        rdefs, is_leaf=lambda x: isinstance(x, ref_params.ParamDef))
    port_leaves = port_params.tree_leaves(pdefs)
    assert [".".join(k.key for k in p) for p, _ in ref_leaves] \
        == [p for p, _ in port_leaves]
    assert [dataclasses.astuple(d) for _, d in ref_leaves] \
        == [dataclasses.astuple(d) for _, d in port_leaves]
    assert port_params.param_bytes(pdefs) == ref_params.param_bytes(rdefs)
    assert port_params.tree_leaves(port_params.logical_specs(pdefs)) \
        == [(p, d.axes) for p, d in port_leaves]


def test_init_params_draws_from_the_generator():
    _, pcfg = configs("qwen1_5_0_5b")
    defs = port_tf.model_defs(pcfg)
    a = port_params.init_params(defs, torch.Generator().manual_seed(3),
                                device="cpu")
    b = port_params.init_params(defs, torch.Generator().manual_seed(3),
                                device="cpu")
    c = port_params.init_params(defs, torch.Generator().manual_seed(4),
                                device="cpu")
    for (path, d), (_, x), (_, y), (_, z) in zip(
            port_params.tree_leaves(defs), port_params.tree_leaves(a),
            port_params.tree_leaves(b), port_params.tree_leaves(c)):
        assert x.shape == d.shape and x.dtype == torch.float32, path
        assert torch.equal(x, y), path
        if d.init == "normal":
            assert not torch.equal(x, z), path
            assert abs(float(x.std()) - d.scale) < 0.3 * d.scale, path
        else:
            assert torch.equal(x, torch.full(d.shape, float(d.init == "ones"))
                               ), path


@pytest.mark.parametrize("arch,lm_head", [("qwen1_5_0_5b", False),
                                          ("stablelm_12b", True)])
def test_params_from_reference_unstacks_and_ties(arch, lm_head):
    rcfg, _, pcfg, model = models(arch)
    tree = ref_tree(rcfg)
    state = model.state_dict()
    assert ("lm_head" in state) == lm_head == ("lm_head" in tree)
    n = pcfg.n_layers
    assert len(model.blocks) == n
    for i in range(n):
        np.testing.assert_array_equal(
            state[f"blocks.{i}.attn.wq"].numpy(), tree["blocks"]["attn"]["wq"][i])
        np.testing.assert_array_equal(
            state[f"blocks.{i}.ffn.w_down"].numpy(),
            tree["blocks"]["ffn"]["w_down"][i])
    np.testing.assert_array_equal(state["embed"].numpy(), tree["embed"])
    # a tied model takes no lm_head, an untied one needs it
    tensors = port_params.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   tree)
    if lm_head:
        del tensors["lm_head"]
    else:
        tensors["lm_head"] = torch.zeros(pcfg.d_model, pcfg.vocab)
    with pytest.raises(RuntimeError, match="lm_head"):
        port_tf.Transformer(pcfg, "cpu").load_params(tensors)


def test_cuda_model_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = configs("qwen1_5_0_5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tf.Transformer(pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tf.init_caches(pcfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_params.init_params(port_tf.model_defs(pcfg), torch.Generator())


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL),
                                       ("bfloat16", BF16_REL)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, rel):
    rcfg, params, pcfg, model = models(arch, compute_dtype=dtype)
    rb, pb = batches(rcfg, tokens(rcfg, 2, 16, seed=5))
    want, aux, _ = ref_forward(params, rcfg, rb)
    with torch.no_grad():
        got, paux, none = model(pb)
    assert none is None and float(paux) == float(aux) == 0.0
    assert got.dtype == torch.float32
    assert_logits_close(got, want, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_layers_gives_the_same_result(arch):
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32")
    rb, pb = batches(rcfg, tokens(rcfg, 2, 8, seed=6))
    unrolled = dataclasses.replace(pcfg, scan_layers=False, remat="none")
    other = port_tf.Transformer(unrolled, "cpu")
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        a = model(pb)[0]
        b = other(pb)[0]
    assert torch.equal(a, b)
    want = ref_forward(params, dataclasses.replace(rcfg, scan_layers=False),
                          rb)[0]
    assert_logits_close(b, want, F32_REL)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_vl_2b"])
def test_prefill_through_bf16_cache_matches_reference(arch):
    """``greedy_decode``'s path: the prompt goes through zeroed caches of
    the default bf16 dtype (``_sdpa`` over the cache at the prompt's
    offset, not over the prompt's own keys), in float32 compute."""
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32")
    b, s, t = 2, 10, 16
    rb, pb = batches(rcfg, tokens(rcfg, b, s, seed=7))
    want, _, rc = ref_forward(params, rcfg, rb,
                                 ref_caches(rcfg, b, t, jnp.bfloat16))
    caches = port_tf.init_caches(pcfg, b, t, device="cpu")
    assert caches["layers"]["k"].dtype == torch.bfloat16
    got, _, pc = model(pb, caches)
    assert_logits_close(got, want, F32_REL)
    assert int(pc["pos"]) == int(rc["pos"]) == s
    np.testing.assert_array_equal(pc["layers"]["pos"].numpy(),
                                  np.asarray(rc["layers"]["pos"]))
    # the cache holds the same keys, rounded to bf16 the same way
    np.testing.assert_allclose(
        pc["layers"]["k"][:, :, :s].float().numpy(),
        np.asarray(rc["layers"]["k"][:, :, :s].astype(jnp.float32)),
        rtol=1e-2, atol=1e-2)
    assert not pc["layers"]["k"][:, :, s:].any()


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_vl_2b",
                                  "granite_34b"])
def test_decode_matches_prefill(arch):
    """The reference's ``test_decode_matches_prefill`` on the port, and each
    decode step's logits against the reference's."""
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32",
                                       remat="none")
    b, s = 2, 12
    toks = tokens(rcfg, b, s, seed=5)
    rb, pb = batches(rcfg, toks)
    with torch.no_grad():
        full = model(pb)[0]
    caches = port_tf.init_caches(pcfg, b, s, dtype=torch.float32,
                                 device="cpu")
    rc = ref_caches(rcfg, b, s)
    outs = []
    for t in range(s):
        rdb, pdb = batches(rcfg, toks[:, t:t + 1], start=t)
        dl, _, caches = model(pdb, caches)
        want, _, rc = ref_forward(params, rcfg, rdb, rc)
        assert_logits_close(dl, want, F32_REL)
        outs.append(dl)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < SELF_ABS, err
    assert int(caches["pos"]) == s


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_vl_2b"])
def test_multi_token_prefill_into_cache(arch):
    """Cache-populating prefill (serving path) matches no-cache forward."""
    rcfg, _, pcfg, model = models(arch, compute_dtype="float32",
                                  remat="none")
    b, s = 2, 16
    toks = tokens(rcfg, b, s + 4, seed=9)
    _, pb = batches(rcfg, toks[:, :s])
    with torch.no_grad():
        full = model(pb)[0]
    caches = port_tf.init_caches(pcfg, b, 32, dtype=torch.float32,
                                 device="cpu")
    logits, _, caches = model(pb, caches)
    assert float((logits - full).abs().max()) < SELF_ABS
    assert int(caches["pos"]) == s
    # a second chunk continues from pos
    _, pb2 = batches(rcfg, toks[:, s:], start=s)
    with torch.no_grad():
        full2 = model(batches(rcfg, toks)[1])[0]
    logits2, _, caches = model(pb2, caches)
    assert float((logits2 - full2[:, s:]).abs().max()) < SELF_ABS
    assert int(caches["pos"]) == s + 4


@pytest.mark.parametrize("arch", ["stablelm_12b", "qwen2_vl_2b"])
def test_int8_kv_cache_decode(arch):
    """Quantized KV cache: the reference's criteria (relative error < 0.1,
    greedy agreement > 0.95 against the no-cache forward) on the port, and
    each step's logits against the reference's int8-cache decode."""
    rcfg, params, pcfg, model = models(arch, remat="none",
                                       compute_dtype="float32",
                                       kv_cache_dtype="int8")
    b, s = 2, 12
    toks = tokens(rcfg, b, s, seed=7)
    rb, pb = batches(rcfg, toks)
    with torch.no_grad():
        full = model(pb)[0]
    caches = port_tf.init_caches(pcfg, b, s, dtype=torch.float32,
                                 device="cpu")
    assert caches["layers"]["k"].dtype == torch.int8
    assert caches["layers"]["k_scale"].dtype == torch.float32
    rc = ref_caches(rcfg, b, s)
    outs = []
    for t in range(s):
        rdb, pdb = batches(rcfg, toks[:, t:t + 1], start=t)
        dl, _, caches = model(pdb, caches)
        want, _, rc = ref_forward(params, rcfg, rdb, rc)
        assert_logits_close(dl, want, F32_REL)
        outs.append(dl)
    dec = torch.cat(outs, 1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 0.1, rel
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    assert agree > 0.95, agree
    # codes within one step of the reference's (a half-way x/s may round
    # either way after the frameworks' last-place differences)
    codes = caches["layers"]["k"].long().numpy()
    ref_codes = np.asarray(rc["layers"]["k"]).astype(np.int64)
    assert np.abs(codes - ref_codes).max() <= 1
    assert (codes == ref_codes).mean() > 0.99


def test_cache_overflow_raises():
    """The reference's ``dynamic_update_slice`` would shift a write that
    runs past ``max_seq``; the port refuses it."""
    rcfg, _, pcfg, model = models("qwen1_5_0_5b")
    caches = port_tf.init_caches(pcfg, 2, 4, device="cpu")
    _, pb = batches(rcfg, tokens(rcfg, 2, 3, seed=1))
    _, _, caches = model(pb, caches)
    _, pb2 = batches(rcfg, tokens(rcfg, 2, 2, seed=2))
    with pytest.raises(ValueError, match="cache overflow"):
        model(pb2, caches)
    _, pb1 = batches(rcfg, tokens(rcfg, 2, 1, seed=2))
    _, _, caches = model(pb1, caches)            # fills the last slot
    assert int(caches["pos"]) == 4


# -- attention paths ------------------------------------------------------------

def qkv(b, s, t, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32))


def test_flash_attention_equals_naive():
    """The reference's test on the port (port vs port), and each against
    the reference's functions."""
    q, k, v = qkv(2, 96, 96, 8, 4, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = port_layers._sdpa_naive(tq, tk, tv, causal=True)
    f = port_layers._flash_attn(tq, tk, tv, causal=True, block_q=32,
                                block_k=40)
    assert float((a - f).abs().max()) < 1e-4
    ra = ref_layers._sdpa_naive(q, k, v, causal=True)
    rf = ref_layers._flash_attn(q, k, v, causal=True, block_q=32,
                                block_k=40)
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(rf), atol=1e-5)


def test_flash_attention_with_offset_and_kv_len():
    q, k, v = qkv(2, 5, 23, 4, 2, 8, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for kw in ({"q_offset": 9}, {"q_offset": 3, "kv_len": 2}):
        got = port_layers._flash_attn(tq, tk, tv, causal=True, block_q=2,
                                      block_k=7, **kw)
        want = ref_layers._flash_attn(q, k, v, causal=True, block_q=2,
                                      block_k=7, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_masked_decode_attn_paths(flash, monkeypatch):
    """Cached attention (``_sdpa`` at a query offset) on both of its paths
    (the flash one taken by lowering the threshold in both packages),
    against the reference's ``_masked_decode_attn`` and against the naive
    causal attention at that offset."""
    q, k, v = qkv(2, 3, 20, 4, 2, 8, seed=2)
    if flash:
        monkeypatch.setattr(port_layers, "FLASH_THRESHOLD", 4)
        monkeypatch.setattr(ref_layers, "FLASH_THRESHOLD", 4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port_layers._sdpa(tq, tk, tv, causal=True, q_offset=6)
    want = ref_layers._masked_decode_attn(q, k, v, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # only cache positions ≤ 6 + i are visible to query i
    naive = port_layers._sdpa_naive(tq, tk[:, :9], tv[:, :9], causal=True,
                                    q_offset=6)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-5)


@pytest.mark.parametrize("sections", [None, (2, 2, 4)])
def test_apply_rope_matches_reference(sections):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    got = port_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = ref_layers.apply_rope(x, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mpos = rng.integers(0, 50, (2, 7, 3)).astype(np.int32)
    got = port_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(mpos),
                                 mrope_sections=sections)
    want = ref_layers.apply_rope(x, mpos, mrope_sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    scale = rng.standard_normal(64, dtype=np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x).astype(jdt))
    got = port_layers.rmsnorm(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(scale))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-5 if dtype == "float32" else 1e-2)


# -- the PuM MLP ----------------------------------------------------------------

def pum_case(seed: int = 0):
    """Reference pum_mlp params, the port's PumMLP with them, and x."""
    rcfg, pcfg = configs("qwen1_5_0_5b", compute_dtype="float32",
                         pum_mlp=True, d_ff=128)
    params = ref_params.init_params(ref_layers.mlp_defs(rcfg),
                                    jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    mod = port_layers.PumMLP(pcfg, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in tree.items()})
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 4, pcfg.d_model), dtype=np.float32)
    x[0, 0, :3] = 0.0                       # sign(0) → +1 on both sides
    return rcfg, params, tree, mod, x


def test_pum_mlp_forward_and_ste_gradient_match_reference():
    rcfg, params, tree, mod, x = pum_case()
    w = np.random.default_rng(9).standard_normal(
        (2, 4, rcfg.d_model), dtype=np.float32)

    def ref_loss(p, x):
        return jnp.sum(ref_layers.pum_mlp(p, rcfg, x) * w)

    want = ref_layers.pum_mlp(params, rcfg, jnp.asarray(x))
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = mod(tx)
    assert_scaled_close(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    assert_scaled_close(tx.grad.numpy(), gx)
    for name in ("w_gate", "w_up", "w_down"):
        g = getattr(mod, name).grad
        assert g is not None and bool(g.abs().sum() > 0), name
        assert_scaled_close(g.numpy(), gp[name])


def test_sign_ste_is_clipped_straight_through():
    v = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5],
                     requires_grad=True)
    y = port_layers.sign_ste(v)
    assert y.tolist() == [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0]
    y.backward(torch.arange(1.0, 8.0))
    assert v.grad.tolist() == [0.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.0]


def test_pum_gate_contraction_equals_xnor_popcount():
    """The binarized gate contraction inside ``PumMLP`` equals K3's plain
    version (the wrapper on CPU tensors) on ``pack_signs`` of the operands,
    exactly — the reference's ``test_pum_mlp_matches_bitserial_kernel``."""
    rcfg, _, tree, mod, x = pum_case(seed=2)
    d = rcfg.d_model
    tx = torch.from_numpy(x)
    xb = port_layers.sign_ste(tx)
    wb = port_layers.sign_ste(mod.w_gate.detach())
    ref = torch.einsum("bsd,df->bsf", xb, wb).reshape(-1, wb.shape[1])
    xp = pack_signs(tx.reshape(-1, d))
    wp = pack_signs(mod.w_gate.detach().t())
    np.testing.assert_array_equal(xp.numpy().view(np.uint32),
                                  np.asarray(ref_pack_signs(
                                      jnp.asarray(x.reshape(-1, d)))))
    kern = bitserial_matmul(xp, wp, d)
    assert torch.equal(kern, bitserial_matmul_plain(xp, wp, d))
    np.testing.assert_array_equal(kern.numpy(), ref.numpy().astype(np.int32))


def test_pum_model_forward_matches_reference():
    rcfg, params, pcfg, model = models("qwen1_5_0_5b", pum_mlp=True,
                                       compute_dtype="float32")
    rb, pb = batches(rcfg, tokens(rcfg, 2, 8, seed=11))
    want = ref_forward(params, rcfg, rb)[0]
    with torch.no_grad():
        got = model(pb)[0]
    assert isinstance(model.blocks[0].ffn, port_layers.PumMLP)
    assert_logits_close(got, want, F32_REL)
