"""Training every model family: the loss and every gradient of
``repro_torch.train.train_step.make_loss_fn`` under autograd held against
``jax.value_and_grad`` of ``repro.train.train_step.make_loss_fn`` on the
CPU, at each family's reduced config.

The reference's parameters are carried across with
``repro_torch.interop.params_from_reference`` and the port's gradients
carried back with ``params_to_reference``; the same numpy-seeded tokens,
labels (and M-RoPE positions, encoder frames) go through both packages.
Tolerances, per gradient leaf and for the loss (``aux`` included):

* float32 compute: |port − reference| ≤ 1e-4 × max|reference|;
* bfloat16 compute: ≤ 5e-2 × max|reference| (every einsum rounds to bf16;
  the port's embedding gradient sums repeated tokens in float32 where the
  reference's scatter-add of its bf16 table runs in bf16).  Where the
  reference's own bf16 gradient leaf lies farther than that from its
  float32 gradient, the reference cannot vouch for the leaf at this bound,
  and the port's bf16 leaf must instead lie no farther from the
  reference's float32 leaf than the reference's bf16 leaf does.  This
  happens at zamba2's 12 layers only: there the reference's bf16
  gradients of ``ssm_blocks`` ``ln.scale``, ``mixer.conv_w``,
  ``mixer.d_skip``, ``mixer.dt_bias``, ``mixer.norm.scale`` and
  ``mixer.w_in`` are 5.0–8.7 % of their largest entry off its own float32
  ones, the port's 1.8–5.1 % (and 5.3–9.3 % off the reference's bf16);
* remat on and off: bit for bit (the recomputation repeats the same ops).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro.train.train_step as ref_step
import repro_torch.configs as port_configs
import repro_torch.models.params as port_params
import repro_torch.train.optimizer as port_opt
import repro_torch.train.train_step as port_step
from repro_torch.interop import params_from_reference, params_to_reference

F32_REL, BF16_REL = 1e-4, 5e-2
# one config of each family: dense, vlm, MoE, MLA (with MoE), SSM, hybrid,
# enc-dec
FAMILIES = ("qwen1_5_0_5b", "qwen2_vl_2b", "olmoe_1b_7b",
            "deepseek_v2_236b", "mamba2_130m", "zamba2_7b",
            "whisper_large_v3")
B, S = 2, 16


def configs(arch: str, **over):
    return (dataclasses.replace(ref_configs.get_reduced(arch), **over),
            dataclasses.replace(port_configs.get_reduced(arch), **over))


def ref_tree(cfg, seed: int = 1):
    params = ref_params.init_params(ref_tf.model_defs(cfg),
                                    jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def batches(cfg, seed: int = 4):
    """(reference batch, port batch) of seeded tokens and labels, with
    M-RoPE positions (vlm) and encoder frames (enc-dec)."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.rope == "mrope":
        arrs["mrope_positions"] = np.tile(
            np.arange(S, dtype=np.int32)[None, :, None], (B, 1, 3))
    if cfg.enc_dec:
        arrs["encoder_frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def port_loss_and_grads(model, cfg, batch):
    for p in model.parameters():
        p.grad = None
    objective, metrics = port_step.make_loss_fn(cfg)(model, batch)
    objective.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return objective.detach(), metrics, grads


def assert_close(got, want, rel: float, what: str):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def reference(cfg, tree, batch):
    """``((objective, metrics), gradients)`` of the reference's loss."""
    return jax.jit(jax.value_and_grad(ref_step.make_loss_fn(cfg),
                                      has_aux=True))(
        jax.tree.map(jnp.asarray, tree), batch)


def ref_gradients(cfg, tree, batch):
    return jax.tree.map(np.asarray, reference(cfg, tree, batch)[1])


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL),
                                       ("bfloat16", BF16_REL)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch, dtype, rel):
    rcfg, pcfg = configs(arch, compute_dtype=dtype)
    tree = ref_tree(rcfg)
    rb, pb = batches(rcfg)
    (want, want_m), want_g = reference(rcfg, tree, rb)
    model = params_from_reference(pcfg, tree, "cpu")
    got, got_m, got_g = port_loss_and_grads(model, pcfg, pb)
    assert_close(got, want, rel, "objective")
    assert_close(got_m["loss"], want_m["loss"], rel, "loss")
    if pcfg.moe:
        assert float(want_m["aux"]) > 0
        assert_close(got_m["aux"], want_m["aux"], rel, "aux")
    got_tree = params_to_reference(model, got_g)
    want_leaves = port_params.tree_leaves(jax.tree.map(np.asarray, want_g))
    got_leaves = port_params.tree_leaves(got_tree)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    f32 = None
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        bound = rel * float(np.abs(w).max())
        if dtype == "bfloat16" and float(np.abs(g - w).max()) > bound:
            if f32 is None:
                f32 = dict(port_params.tree_leaves(ref_gradients(
                    dataclasses.replace(rcfg, compute_dtype="float32"),
                    tree, rb)))
            own = float(np.abs(w - f32[path]).max())
            assert own > bound, (path, own, bound)
            err = float(np.abs(g - f32[path]).max())
            assert err <= own, (path, err, own)
            continue
        assert_close(g, w, rel, path)
    if arch == "zamba2_7b":     # the tied block's gradient sums over its calls
        assert float(np.abs(got_tree["shared_attn"]["attn"]["wq"]).max()) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_loss_or_gradient(arch):
    _, pcfg = configs(arch, compute_dtype="float32")
    assert pcfg.remat == "full"
    rcfg, _ = configs(arch)
    tree = ref_tree(rcfg)
    _, pb = batches(pcfg)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(pcfg, remat=remat)
        out[remat] = port_loss_and_grads(
            params_from_reference(cfg, tree, "cpu"), cfg, pb)
    for remat in ("full", "dots"):
        loss, metrics, grads = out[remat]
        assert torch.equal(loss, out["none"][0])
        assert torch.equal(metrics["aux"], out["none"][1]["aux"])
        for k, g in grads.items():
            assert torch.equal(g, out["none"][2][k]), (remat, k)


def test_remat_recomputes_blocks_in_the_backward_pass():
    """Under ``remat`` a block's forward runs again during the backward
    pass; without it, or without autograd, once."""
    _, pcfg = configs("qwen1_5_0_5b", compute_dtype="float32")
    tree = ref_tree(configs("qwen1_5_0_5b")[0])
    _, pb = batches(pcfg)
    for remat, grad, want in (("full", True, 2), ("none", True, 1),
                              ("full", False, 1)):
        cfg = dataclasses.replace(pcfg, remat=remat)
        model = params_from_reference(cfg, tree, "cpu")
        calls = []
        model.blocks[0].register_forward_pre_hook(
            lambda *_: calls.append(1))
        with torch.set_grad_enabled(grad):
            objective, _ = port_step.make_loss_fn(cfg)(model, pb)
            if grad:
                objective.backward()
        assert len(calls) == want, (remat, grad)


@pytest.mark.parametrize("arch", port_configs.ARCHS)
def test_every_config_trains(arch):
    """Every config's reduced model takes three steps: finite losses,
    the step counter at 3, and parameters moved (the reference's
    ``test_arch_train_step_smoke``)."""
    rcfg, pcfg = configs(arch)
    model = params_from_reference(pcfg, ref_tree(rcfg, 0), "cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = port_step.init_train_state(model)
    step = port_step.make_train_step(pcfg, port_opt.AdamWConfig(lr=1e-3))
    _, pb = batches(pcfg)
    for _ in range(3):
        state, metrics = step(state, pb)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state.opt.step) == 3
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) == len(before)
