"""The MoE, MLA, SSM, hybrid and enc-dec model families:
``repro_torch.models`` held against ``repro.models`` on the CPU.

The reference's parameters (``repro.models.params.init_params``) are carried
across with ``repro_torch.interop.params_from_reference``, and the same
numpy-seeded tokens (and, for whisper, encoder frames) go through both
packages.  Tolerances, as in ``tests/test_torch_models.py``:

* float32 compute: |port − reference| ≤ 1e-4 × max|reference logit|, and
  the MoE ``aux`` loss within 1e-4 × |reference aux|;
* bfloat16 compute: ≤ 5e-2 × max|reference logit| (and aux);
* greedy ids equal wherever the reference's top-2 gap exceeds the
  tolerance;
* caches: the same tree, shapes and dtypes, values within the logits'
  relative bound of the reference's largest entry;
* the port's own cached decode against its no-cache forward: 2e-3
  absolute, the reference tests' bound (``tests/test_models.py``).

MoE routes (the chosen expert sets) are compared before the logits: a
route may differ only where the k-th and (k+1)-th router probabilities
are within float rounding of each other, and such a near-tie is reported
as one.
"""
import dataclasses
import functools

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
from repro_torch.interop import params_from_reference

F32_REL, BF16_REL, SELF_ABS = 1e-4, 5e-2, 2e-3
FAMILIES = ("olmoe_1b_7b", "deepseek_v2_236b", "mamba2_130m", "zamba2_7b",
            "whisper_large_v3")
MOE = ("olmoe_1b_7b", "deepseek_v2_236b")
NEAR_TIE = 1e-6          # router probabilities this close may order either way
# the reference's forward, compiled once per config and shape
ref_forward = jax.jit(ref_tf.forward, static_argnums=(1,))


def configs(arch: str, **over):
    """(reference cfg, port cfg) of ``arch``'s reduced config."""
    return (dataclasses.replace(ref_configs.get_reduced(arch), **over),
            dataclasses.replace(port_configs.get_reduced(arch), **over))


@functools.lru_cache(maxsize=None)
def ref_tree(arch: str, seed: int = 1):
    rcfg, _ = configs(arch)
    params = ref_params.init_params(ref_tf.model_defs(rcfg),
                                    jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def models(arch: str, seed: int = 1, **over):
    """(ref cfg, ref params, port cfg, port model) with equal parameters."""
    rcfg, pcfg = configs(arch, **over)
    tree = ref_tree(arch, seed)
    return (rcfg, jax.tree.map(jnp.asarray, tree), pcfg,
            params_from_reference(pcfg, tree, "cpu"))


def inputs(cfg, b: int, s: int, seed: int):
    """(reference batch, port batch, tokens) of seeded tokens, plus encoder
    frames for the enc-dec family."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks)}
    port = {"tokens": torch.from_numpy(toks).long()}
    if cfg.enc_dec:
        frames = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                  * 0.1).astype(np.float32)
        ref["encoder_frames"] = jnp.asarray(frames)
        port["encoder_frames"] = torch.from_numpy(frames)
    return ref, port, toks


def frames_of(ref: dict, port: dict):
    """The encoder frames of a batch pair (empty dicts without)."""
    return ({k: v for k, v in ref.items() if k == "encoder_frames"},
            {k: v for k, v in port.items() if k == "encoder_frames"})


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


def assert_aux_close(got, want, rel: float):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


def ref_caches(cfg, b, t, dtype):
    shapes = ref_tf.init_cache_shapes(cfg, b, t, dtype=dtype)
    return jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)


def assert_caches_close(got, want, rel: float = F32_REL):
    """The same tree of the same shapes and dtypes, values within ``rel`` ×
    the reference's largest entry of each leaf; a bf16 entry may also
    round one bf16 step (2⁻⁷ of its value) the other way, since the
    float32 values it was rounded from differ in their last place."""
    want = jax.tree.map(np.asarray, want)
    glv = port_params.tree_leaves(got)
    wlv = port_params.tree_leaves(want)
    assert [p for p, _ in glv] == [p for p, _ in wlv]
    for (path, g), (_, w) in zip(glv, wlv):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), \
            (path, g.dtype, w.dtype)
        bf16 = g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = w.astype(np.float32)
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        if bf16:
            bound = bound + 2.0 ** -7 * np.abs(w)
        assert (np.abs(g - w) <= bound).all(), \
            (path, float(np.abs(g - w).max()))


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
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


@pytest.mark.parametrize("arch", port_configs.ARCHS)
def test_every_config_builds_loads_and_runs(arch):
    """All ten configs (reduced): built, loaded from the reference's tree,
    one no-cache forward and one cached step, finite and of the
    reference's shapes."""
    rcfg, params, pcfg, model = models(arch)
    rb, pb, _ = inputs(rcfg, 2, 8, seed=2)
    with torch.no_grad():
        logits, aux, none = model(pb)
    assert none is None and logits.shape == (2, 8, pcfg.vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    caches = port_tf.init_caches(pcfg, 2, 9, device="cpu")
    _, pframes = frames_of(rb, pb)
    logits, _, caches = model({"tokens": pb["tokens"][:, :1], **pframes},
                              caches)
    assert logits.shape == (2, 1, pcfg.vocab)
    assert bool(torch.isfinite(logits).all()) and int(caches["pos"]) == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_unstacks_every_stacked_tree(arch):
    rcfg, _, pcfg, model = models(arch)
    tree = ref_tree(arch)
    state = model.state_dict()
    n_leaves = 0
    for path, want in port_params.tree_leaves(tree):
        head, _, rest = path.partition(".")
        if head in ("blocks", "ssm_blocks", "enc_blocks"):
            for i in range(want.shape[0]):
                np.testing.assert_array_equal(
                    state[f"{head}.{i}.{rest}"].numpy(), want[i])
                n_leaves += 1
        else:                       # shared_attn stays one block
            np.testing.assert_array_equal(state[path].numpy(), want)
            n_leaves += 1
    assert n_leaves == len(state)
    if arch == "zamba2_7b":
        assert "shared_attn.attn.wq" in state
        assert len(model.ssm_blocks) == pcfg.n_layers
    if arch == "deepseek_v2_236b":
        assert "blocks.1.ffn.shared.w_gate" in state
        assert "blocks.0.attn.w_uk" in state
    if arch == "whisper_large_v3":
        assert "blocks.1.xattn.wk" in state and "enc_blocks.1.attn.wq" in state


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_caches_match_reference_shapes(arch):
    rcfg, pcfg = configs(arch)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = port_params.tree_leaves(jax.tree.map(
            lambda x: (x.shape, str(x.dtype)),
            ref_tf.init_cache_shapes(rcfg, 3, 10, dtype=jdt),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
        caches = port_tf.init_caches(pcfg, 3, 10, dtype=tdt, device="cpu")
        got = [(p, (tuple(t.shape), str(t.dtype).removeprefix("torch.")))
               for p, t in port_params.tree_leaves(caches)]
        assert got == want
        for p, t in port_params.tree_leaves(caches):
            assert not t.any(), p
            assert t.device.type == "cpu"


# (arch, parameters) at full width and depth, as the reference counts them
FULL_WIDTH = (("zamba2_7b", 6_750_539_856), ("whisper_large_v3",
                                             2_020_421_120))


@pytest.mark.parametrize("arch,n_params", FULL_WIDTH)
def test_full_width_defs_and_cache_shapes_match_reference(arch, n_params):
    """At ``get_config`` (nothing cut), without allocating: every parameter
    leaf's path, shape, dtype and axes, ``param_bytes``, and the decode
    caches' shapes and dtypes at 16 sequences × 160 positions."""
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    rdefs, pdefs = ref_tf.model_defs(rcfg), port_tf.model_defs(pcfg)
    ref_leaves = jax.tree.leaves_with_path(
        rdefs, is_leaf=lambda x: isinstance(x, ref_params.ParamDef))
    port_leaves = port_params.tree_leaves(pdefs)
    assert [".".join(k.key for k in p) for p, _ in ref_leaves] \
        == [p for p, _ in port_leaves]
    assert [dataclasses.astuple(d) for _, d in ref_leaves] \
        == [dataclasses.astuple(d) for _, d in port_leaves]
    assert port_params.param_bytes(pdefs) == ref_params.param_bytes(rdefs) \
        == 4 * n_params
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = port_params.tree_leaves(jax.tree.map(
            lambda x: (x.shape, str(x.dtype)),
            ref_tf.init_cache_shapes(rcfg, 16, 160, dtype=jdt),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
        got = port_params.tree_leaves(port_tf.init_cache_shapes(
            pcfg, 16, 160, dtype=tdt))
        assert [(p, (tuple(shape), str(dt).removeprefix("torch.")))
                for p, (shape, dt) in got] == want


def test_draw_params_fills_the_module_in_place():
    _, pcfg = configs("deepseek_v2_236b")
    a = port_tf.Transformer(pcfg, "cpu").draw_params(
        torch.Generator().manual_seed(3))
    b = port_tf.Transformer(pcfg, "cpu").draw_params(
        torch.Generator().manual_seed(3))
    c = port_tf.Transformer(pcfg, "cpu").draw_params(
        torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    defs = dict(port_params.tree_leaves(port_tf.model_defs(pcfg)))
    for name, x in sa.items():
        path = name
        for head in ("blocks", "ssm_blocks", "enc_blocks"):
            if name.startswith(head + "."):
                path = head + "." + name.split(".", 2)[2]
        d = defs[path]
        assert torch.equal(x, sb[name]), name
        if d.init == "normal":
            assert not torch.equal(x, sc[name]), name
            assert abs(float(x.std()) - d.scale) < 0.3 * d.scale, name
        else:
            assert torch.equal(x, torch.full_like(x, float(d.init == "ones"))
                               ), name


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL),
                                       ("bfloat16", BF16_REL)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch, dtype, rel):
    rcfg, params, pcfg, model = models(arch, compute_dtype=dtype)
    rb, pb, _ = inputs(rcfg, 2, 16, seed=5)
    if rcfg.moe:
        check_routes(rcfg, params, model, rb, pb)
    want, aux, _ = ref_forward(params, rcfg, rb)
    with torch.no_grad():
        got, paux, none = model(pb)
    assert none is None and got.dtype == torch.float32
    if rcfg.moe:
        assert float(aux) > 0
        assert_aux_close(paux, aux, rel)
    else:
        assert float(paux) == float(aux) == 0.0
    assert_logits_close(got, want, rel)


def check_routes(rcfg, params, model, rb, pb):
    """Layer 0's MoE routes: the reference's and the port's top-k expert
    sets on the same FFN input (the port's), equal wherever the k-th and
    (k+1)-th probabilities are more than ``NEAR_TIE`` apart."""
    seen = []
    hook = model.blocks[0].ffn.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(pb)
    finally:
        hook.remove()
    h = seen[0]
    k, d = rcfg.experts_per_tok, rcfg.d_model
    tokens = h.reshape(1, -1, d)
    with torch.no_grad():
        probs, _, idx = model.blocks[0].ffn.route(tokens)
    router = params["blocks"]["ffn"]["router"][0]
    ref_probs = jax.nn.softmax(jnp.einsum(
        "gtd,de->gte", jnp.asarray(tokens.float().numpy()),
        router.astype(jnp.float32)), -1)
    _, ref_idx = jax.lax.top_k(ref_probs, k)
    got = np.sort(idx.numpy(), -1)
    want = np.sort(np.asarray(ref_idx), -1)
    sorted_p = np.sort(np.asarray(ref_probs), -1)[..., ::-1]
    gap = sorted_p[..., k - 1] - sorted_p[..., k]
    differ = (got != want).any(-1)
    near = gap <= NEAR_TIE
    assert not (differ & ~near).any(), \
        f"routes differ on {int((differ & ~near).sum())} tokens"
    assert not differ.any(), (f"routes differ only on {int(differ.sum())} "
                              f"near-tied tokens (gap ≤ {NEAR_TIE})")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cached_steps_match_reference(arch, cache_dtype):
    """A 12-token prefill through zeroed caches (primed for whisper), then
    12 one-token steps, in float32 compute: each step's logits and the
    whole cache tree against the reference's.  A bf16 cache under float32
    compute is ``greedy_decode``'s case on the CPU: the SSM conv window
    comes back float32 after the first step, as in the reference."""
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32")
    b, s, n = 2, 12, 12
    rb, pb, toks = inputs(rcfg, b, s + n, seed=7)
    rframes, pframes = frames_of(rb, pb)
    jdt, tdt = ((jnp.float32, torch.float32) if cache_dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rc = ref_caches(rcfg, b, s + n, jdt)
    caches = port_tf.init_caches(pcfg, b, s + n, dtype=tdt, device="cpu")
    if rcfg.enc_dec:
        rc = ref_tf.prime_encdec_caches(params, rcfg, rframes, rc)
        caches = port_tf.prime_encdec_caches(model, pcfg, pframes, caches)
        assert_caches_close(caches, rc)
    for t in range(n + 1):
        sl = slice(0, s) if t == 0 else slice(s + t - 1, s + t)
        want, aux, rc = ref_forward(
            params, rcfg, {"tokens": jnp.asarray(toks[:, sl]), **rframes}, rc)
        got, paux, caches = model(
            {"tokens": torch.from_numpy(toks[:, sl]).long(), **pframes},
            caches)
        assert_logits_close(got, want, F32_REL)
        if rcfg.moe:
            assert_aux_close(paux, aux, F32_REL)
        assert_caches_close(caches, rc)
    assert int(caches["pos"]) == s + n


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch):
    """The reference's ``test_decode_matches_prefill`` on the port, MoE
    included at ``capacity_factor=8.0`` (no token drops, so one-token
    groups route as the whole sequence does), and each step's logits
    against the reference's."""
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32",
                                       remat="none", capacity_factor=8.0)
    b, s = 2, 12
    rb, pb, toks = inputs(rcfg, b, s, seed=5)
    rframes, pframes = frames_of(rb, pb)
    with torch.no_grad():
        full = model(pb)[0]
    caches = port_tf.init_caches(pcfg, b, s, dtype=torch.float32,
                                 device="cpu")
    rc = ref_caches(rcfg, b, s, jnp.float32)
    if rcfg.enc_dec:
        caches = port_tf.prime_encdec_caches(model, pcfg, pframes, caches)
        rc = ref_tf.prime_encdec_caches(params, rcfg, rframes, rc)
    outs = []
    for t in range(s):
        dl, _, caches = model({"tokens": pb["tokens"][:, t:t + 1],
                               **pframes}, caches)
        want, _, rc = ref_forward(
            params, rcfg, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                           **rframes}, rc)
        assert_logits_close(dl, want, F32_REL)
        outs.append(dl)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < SELF_ABS, err
    assert int(caches["pos"]) == s


def test_whisper_cross_kv_cache_exact():
    """The reference's test on the port: cross-attention K/V computed once
    at priming equal the per-step projections."""
    rcfg, _, pcfg, model = models("whisper_large_v3", remat="none",
                                  compute_dtype="float32")
    assert pcfg.cross_kv_cache
    b, s = 2, 8
    _, pb, _ = inputs(rcfg, b, s, seed=3)
    _, pframes = frames_of({}, pb)
    with torch.no_grad():
        full = model(pb)[0]
    caches = port_tf.init_caches(pcfg, b, s, dtype=torch.float32,
                                 device="cpu")
    assert "xk" in caches["layers"]
    caches = port_tf.prime_encdec_caches(model, pcfg, pframes, caches)
    outs = []
    for t in range(s):
        dl, _, caches = model({"tokens": pb["tokens"][:, t:t + 1],
                               **pframes}, caches)
        outs.append(dl)
    err = float((torch.cat(outs, 1) - full).abs().max())
    assert err < SELF_ABS, err


@pytest.mark.parametrize("cross_kv_cache,primed", [(True, False),
                                                   (False, True),
                                                   (False, False)])
def test_whisper_cache_variants_match_reference(cross_kv_cache, primed):
    """Without priming the caches' ``encoder_out`` (and ``xk``/``xv``) stay
    zero and the decoder attends over them, as in the reference; without
    the cross-KV cache the keys and values come from ``encoder_out`` at
    every step."""
    rcfg, params, pcfg, model = models("whisper_large_v3",
                                       compute_dtype="float32",
                                       cross_kv_cache=cross_kv_cache)
    b, s = 2, 6
    rb, pb, toks = inputs(rcfg, b, s, seed=4)
    rframes, pframes = frames_of(rb, pb)
    rc = ref_caches(rcfg, b, s, jnp.float32)
    caches = port_tf.init_caches(pcfg, b, s, dtype=torch.float32,
                                 device="cpu")
    assert ("xk" in caches["layers"]) == cross_kv_cache
    if primed:
        rc = ref_tf.prime_encdec_caches(params, rcfg, rframes, rc)
        caches = port_tf.prime_encdec_caches(model, pcfg, pframes, caches)
    for t in range(s):
        want, _, rc = ref_forward(
            params, rcfg, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                           **rframes}, rc)
        got, _, caches = model({"tokens": pb["tokens"][:, t:t + 1],
                                **pframes}, caches)
        assert_logits_close(got, want, F32_REL)
        assert_caches_close(caches, rc)


def test_hybrid_shared_block_is_weight_tied():
    """One ``shared_attn`` module serves every invocation (after SSM layers
    6 and 12 of the reduced zamba2), each with its own KV cache."""
    _, _, pcfg, model = models("zamba2_7b", compute_dtype="float32")
    calls = []
    hook = model.shared_attn.register_forward_hook(
        lambda mod, args, out: calls.append(args[2]))
    try:
        caches = port_tf.init_caches(pcfg, 1, 4, dtype=torch.float32,
                                     device="cpu")
        model({"tokens": torch.tensor([[1, 2]])}, caches)
    finally:
        hook.remove()
    assert len(calls) == pcfg.n_layers // 6 == 2
    k = caches["shared_attn"]["k"]
    assert k.shape[0] == 2
    assert calls[0]["k"].data_ptr() == k[0].data_ptr()
    assert calls[1]["k"].data_ptr() == k[1].data_ptr()
    assert k[:, :, :2].abs().amax((1, 2, 3, 4)).gt(0).all()
    assert not k[:, :, 2:].any()
    assert sum(1 for n, _ in model.named_parameters()
               if n.startswith("shared_attn.")) == 9


# -- layers ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_drops_tokens_as_the_reference_does(arch):
    """The MoE layer at the default capacity factor (1.25) on 512 tokens
    (two groups of 256, capacity int(1.25·256·k/E)): tokens beyond an
    expert's capacity drop, and output and aux equal the reference's.  The
    tokens share a component, so routes concentrate enough to drop."""
    rcfg, pcfg = configs(arch, compute_dtype="float32")
    params = ref_params.init_params(ref_layers.moe_defs(rcfg),
                                    jax.random.key(2))
    tree = jax.tree.map(np.asarray, params)
    mod = port_layers.MoE(pcfg, "cpu")
    mod.load_state_dict({p: torch.from_numpy(np.array(a))
                         for p, a in port_params.tree_leaves(tree)})
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 128, pcfg.d_model))
         + 3.0 * rng.standard_normal(pcfg.d_model)).astype(np.float32)
    want, aux = ref_layers.moe(params, rcfg, jnp.asarray(x))
    with torch.no_grad():
        got, paux = mod(torch.from_numpy(x))
    assert_aux_close(paux, aux, F32_REL)
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= F32_REL * float(np.abs(want).max()), err
    # the capacity bound binds: some (token, expert) assignments drop
    with torch.no_grad():
        _, _, idx = mod.route(torch.from_numpy(x).reshape(2, 256, -1))
    e, k = pcfg.n_experts, pcfg.experts_per_tok
    capacity = max(1, int(pcfg.capacity_factor * 256 * k / e))
    per_expert = torch.nn.functional.one_hot(idx, e).sum((1, 2))
    dropped = int((per_expert - capacity).clamp(min=0).sum())
    assert dropped > 0


def test_moe_capacity_of_a_decode_step():
    """OLMoE at full width decodes 16 sequences a step: one group of 16,
    capacity int(1.25·16·8/64) = 2 (the ``int`` truncation of 2.5), and a
    group size halved until it divides the token count."""
    pcfg = port_configs.get_config("olmoe_1b_7b")
    assert max(1, int(pcfg.capacity_factor * 16 * 8 / 64)) == 2
    rcfg, pcfg = configs("olmoe_1b_7b", compute_dtype="float32")
    params = ref_params.init_params(ref_layers.moe_defs(rcfg),
                                    jax.random.key(4))
    mod = port_layers.MoE(pcfg, "cpu")
    mod.load_state_dict({p: torch.from_numpy(np.array(a))
                         for p, a in port_params.tree_leaves(
                             jax.tree.map(np.asarray, params))})
    x = np.random.default_rng(5).standard_normal(
        (3, 100, pcfg.d_model)).astype(np.float32)   # 300 tokens: groups of 4
    want, aux = ref_layers.moe(params, rcfg, jnp.asarray(x))
    with torch.no_grad():
        got, paux = mod(torch.from_numpy(x))
    assert_aux_close(paux, aux, F32_REL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("f32", [True, False])
def test_ssd_chunked_matches_reference(f32):
    rng = np.random.default_rng(6)
    bs, s, nh, hd, n, chunk = 2, 48, 3, 8, 5, 16
    xh = rng.standard_normal((bs, s, nh, hd)).astype(np.float32)
    a = rng.uniform(0.5, 0.99, (bs, s, nh)).astype(np.float32)
    b = rng.standard_normal((bs, s, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, n)).astype(np.float32)
    want = np.asarray(ref_layers._ssd_chunked(xh, a, b, c, chunk, f32=f32))
    got = port_layers._ssd_chunked(*map(torch.from_numpy, (xh, a, b, c)),
                                   chunk, f32=f32)
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= F32_REL * float(np.abs(want).max()), err
    # the chunked scan equals the step-by-step recurrence
    h = np.zeros((bs, nh, hd, n), np.float32)
    seq = []
    for t in range(s):
        h = h * a[:, t, :, None, None] + np.einsum("bhd,bn->bhdn", xh[:, t],
                                                   b[:, t])
        seq.append(np.einsum("bhdn,bn->bhd", h, c[:, t]))
    rec = np.stack(seq, 1)
    tol = (F32_REL if f32 else 2e-2) * float(np.abs(rec).max())
    assert float(np.abs(got.numpy() - rec).max()) <= tol


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
def test_cached_multi_token_ssm_prefill_copies_the_reference(arch):
    """With caches, the reference's SSM mixer runs the one-token recurrence
    on the first token alone and broadcasts it over every position
    (``repro/models/layers.py:548-557``), so its cache-populating prefill
    differs from its no-cache forward.  The port computes the same
    (ROADMAP C): equal to the reference's cached prefill, and as far from
    the no-cache forward."""
    rcfg, params, pcfg, model = models(arch, compute_dtype="float32")
    b, s = 2, 12
    rb, pb, _ = inputs(rcfg, b, s, seed=8)
    want, _, _ = ref_forward(params, rcfg, rb,
                             ref_caches(rcfg, b, s, jnp.float32))
    nocache, _, _ = ref_forward(params, rcfg, rb)
    got, _, _ = model(pb, port_tf.init_caches(pcfg, b, s,
                                              dtype=torch.float32,
                                              device="cpu"))
    assert_logits_close(got[:, -1], want[:, -1], F32_REL)
    want_gap = float(np.abs(np.asarray(want - nocache))[:, -1].max())
    with torch.no_grad():
        port_gap = float((got - model(pb)[0])[:, -1].abs().max())
    assert want_gap > 10 * F32_REL * float(np.abs(np.asarray(want)).max())
    assert abs(port_gap - want_gap) <= 0.01 * want_gap
    # the first position is the recurrence's own and agrees
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(nocache[:, 0]),
                               atol=SELF_ABS)


def test_mla_flash_path_matches_reference(monkeypatch):
    """MLA's no-cache path switches to the online-softmax attention past
    ``FLASH_THRESHOLD`` tokens (``s``, where ``_sdpa`` compares ``s·t``):
    taken here by lowering the threshold in both packages."""
    monkeypatch.setattr(port_layers, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(ref_layers, "FLASH_THRESHOLD", 8)
    rcfg, pcfg = configs("deepseek_v2_236b", compute_dtype="float32")
    params = ref_params.init_params(ref_layers.mla_defs(rcfg),
                                    jax.random.key(5))
    mod = port_layers.MLAttention(pcfg, "cpu")
    mod.load_state_dict({p: torch.from_numpy(np.array(a))
                         for p, a in port_params.tree_leaves(
                             jax.tree.map(np.asarray, params))})
    x = np.random.default_rng(9).standard_normal(
        (2, 12, pcfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None, :]
    want, _ = ref_layers.mla_attention(params, rcfg, jnp.asarray(x),
                                       jnp.asarray(pos))
    got, _ = mod(torch.from_numpy(x), torch.from_numpy(pos))
    want = np.asarray(want)
    assert float(np.abs(got.detach().numpy() - want).max()) \
        <= F32_REL * float(np.abs(want).max())
    # and the flash path equals the plain one
    monkeypatch.setattr(port_layers, "FLASH_THRESHOLD", 4096)
    with torch.no_grad():
        plain, _ = mod(torch.from_numpy(x), torch.from_numpy(pos))
    assert float((plain - got.detach()).abs().max()) <= F32_REL * float(
        np.abs(want).max())
