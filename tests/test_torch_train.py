"""The single-device training path: ``repro_torch.train``,
``repro_torch.distributed.{checkpoint,failover}``, ``launch.train`` and the
``train_100m`` example, held against ``repro`` on the CPU.

The reference's parameters are carried across with
``repro_torch.interop.params_from_reference`` (and back with
``params_to_reference``), and the same numpy-seeded batches go through both
packages.  Tolerances:

* ``synthetic_batch`` tokens, ``_pack_signs`` words and
  ``_majority_from_packed`` votes: exactly;
* ``lr_schedule``: within one float32 ulp (2.4e-7 relative; ``cos`` rounds
  its last place differently in the two frameworks), ``global_norm``
  within 1e-6 relative (other summation orders);
* one ``adamw_update`` on given gradients: every value within 1e-6
  relative of the reference's largest entry of its leaf;
* the loss in float32 compute: 1e-5 relative; gradients 1e-4 × max|·| of
  each leaf;
* a 3-step ``make_train_step`` trajectory in float32 compute: loss and
  ``grad_norm`` within 1e-5 relative, ``lr`` within one ulp, and the
  parameters within ``lr · steps`` absolute, with at most 0.1 % of the
  elements off by more than 1e-5.  Adam's first steps move an element by
  ≈ ``lr · sign(g)``, so a gradient of ~1e-9 whose sign differs between the
  packages moves that element by a whole ``lr``: that is the bound;
* the port against itself (checkpoint round trips, resumed runs, retries,
  remat): bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro.train.data as ref_data
import repro.train.optimizer as ref_opt
import repro.train.train_step as ref_step
import repro_torch
import repro_torch.configs as port_configs
import repro_torch.models.params as port_params
import repro_torch.models.transformer as port_tf
import repro_torch.train.data as port_data
import repro_torch.train.optimizer as port_opt
import repro_torch.train.train_step as port_step
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ModelConfig as RefModelConfig
from repro.distributed.failover import StragglerMonitor as RefMonitor
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.failover import (FailoverConfig, FailoverRunner,
                                              StragglerMonitor)
from repro_torch.examples import train_100m
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import train as port_launch

ARCH = "qwen1_5_0_5b"
F32_REL, LOSS_REL, ULP = 1e-4, 1e-5, 2.4e-7
LR, STEPS, B, S = 1e-3, 3, 4, 32
SRC = Path(repro_torch.__file__).resolve().parents[1]


def configs(arch: str = ARCH, **over):
    """(reference cfg, port cfg) of ``arch``'s reduced config."""
    return (dataclasses.replace(ref_configs.get_reduced(arch), **over),
            dataclasses.replace(port_configs.get_reduced(arch), **over))


def ref_tree(cfg, seed: int = 1):
    params = ref_params.init_params(ref_tf.model_defs(cfg),
                                    jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def opt_cfgs(**over):
    kw = dict(lr=LR, warmup_steps=2, total_steps=6, **over)
    return ref_opt.AdamWConfig(**kw), port_opt.AdamWConfig(**kw)


def data_cfgs(cfg, b: int = B, s: int = S):
    return (ref_data.DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b),
            port_data.DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b))


def port_state(cfg, seed: int = 1):
    """A fresh port state over the reference's parameters of ``seed``."""
    rcfg = RefModelConfig(**dataclasses.asdict(cfg))
    return port_step.init_train_state(
        params_from_reference(cfg, ref_tree(rcfg, seed), "cpu"))


def assert_tree_close(got: dict, want, rel: float, what: str = ""):
    """Leaf for leaf (the reference's sorted paths): |got − want| ≤ rel ×
    max|want| of the leaf."""
    glv = port_params.tree_leaves(got)
    wlv = port_params.tree_leaves(jax.tree.map(np.asarray, want))
    assert [p for p, _ in glv] == [p for p, _ in wlv]
    for (path, g), (_, w) in zip(glv, wlv):
        g = np.asarray(g, dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape, path
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, (what, path, err, bound)


def state_tensors(state) -> dict:
    """Every tensor of a port state, copied, by checkpoint key."""
    from repro_torch.distributed.checkpoint import state_leaves
    return {k: t.detach().clone() for k, t in state_leaves(state).items()}


def assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 5, 2**40])
def test_synthetic_batch_equals_reference_exactly(step):
    rd, pd = data_cfgs(ref_configs.get_reduced(ARCH), b=8, s=48)
    want = ref_data.synthetic_batch(rd, step)
    got = port_data.synthetic_batch(pd, step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    half = port_data.synthetic_batch(pd, step, lo=3, hi=7, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(
            half[k].numpy(),
            np.asarray(ref_data.synthetic_batch(rd, step, lo=3, hi=7)[k]))
        np.testing.assert_array_equal(half[k].numpy(), got[k][3:7].numpy())


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "whisper_large_v3"])
def test_batch_spec_and_make_batch_like_match_reference(arch):
    rcfg, pcfg = configs(arch)
    shape = dataclasses.replace(REF_SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    pshape = dataclasses.replace(PORT_SHAPES["train_4k"], seq_len=16,
                                 global_batch=2)
    want_spec = ref_data.batch_spec(rcfg, shape)
    got_spec = port_data.batch_spec(pcfg, pshape)
    assert list(got_spec) == list(want_spec)
    for k, spec in got_spec.items():
        assert spec.is_meta and tuple(spec.shape) == want_spec[k].shape
        assert str(spec.dtype).removeprefix("torch.") \
            == str(want_spec[k].dtype)
    want = ref_data.make_batch_like(want_spec, seed=3)
    got = port_data.make_batch_like(got_spec, seed=3, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


# -- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 60, 99, 100, 150])
def test_lr_schedule_equals_reference(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(ref_opt.lr_schedule(ref_opt.AdamWConfig(**kw),
                                     jnp.int32(step)))
    got = port_opt.lr_schedule(port_opt.AdamWConfig(**kw), step)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert abs(float(got) - want) <= ULP * want


def random_tree(seed: int, scale: float = 1.0) -> dict:
    """The reduced config's parameter shapes, seeded normal values."""
    rng = np.random.default_rng(seed)
    defs = port_tf.model_defs(port_configs.get_reduced(ARCH))
    return {path: (rng.standard_normal(d.shape) * scale).astype(np.float32)
            for path, d in port_params.tree_leaves(defs)}


def test_global_norm_equals_reference():
    tree = random_tree(0)
    want = float(ref_opt.global_norm({k: jnp.asarray(v)
                                      for k, v in tree.items()}))
    got = port_opt.global_norm({k: torch.from_numpy(v)
                                for k, v in tree.items()})
    assert abs(float(got) - want) <= 1e-6 * want


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])     # unclipped, clipped
def test_adamw_update_matches_reference(grad_scale):
    params, grads = random_tree(1, 0.05), random_tree(2, grad_scale)
    m, v = random_tree(3, 1e-3), random_tree(4, 1e-3)
    v = {k: np.abs(x) for k, x in v.items()}
    rcfg, pcfg = ref_opt.AdamWConfig(lr=1e-3), port_opt.AdamWConfig(lr=1e-3)
    j = lambda t: {k: jnp.asarray(x) for k, x in t.items()}   # noqa: E731
    t = lambda t: {k: torch.from_numpy(x.copy())              # noqa: E731
                   for k, x in t.items()}
    want_p, want_s, want_stats = ref_opt.adamw_update(
        rcfg, ref_opt.AdamWState(jnp.int32(4), j(m), j(v)), j(params),
        j(grads))
    got_p, got_s, got_stats = port_opt.adamw_update(
        pcfg, port_opt.AdamWState(torch.tensor(4, dtype=torch.int32), t(m),
                                  t(v)), t(params), t(grads))
    assert int(got_s.step) == int(want_s.step) == 5
    assert_tree_close(got_p, want_p, 1e-6, "params")
    assert_tree_close(got_s.m, want_s.m, 1e-6, "m")
    assert_tree_close(got_s.v, want_s.v, 1e-6, "v")
    for k in ("grad_norm", "lr"):
        assert abs(float(got_stats[k]) - float(want_stats[k])) \
            <= 1e-6 * float(want_stats[k]), k


# -- the sign packing and the vote ---------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 130, 1000])
def test_pack_signs_and_majority_bit_for_bit(n):
    rng = np.random.default_rng(n)
    grads = rng.standard_normal((5, n)).astype(np.float32)
    grads[:, ::7] = 0.0
    grads[1, ::5] = -0.0
    grads[2, ::3] = np.float32(-1e-30)
    want = jnp.stack([ref_step._pack_signs(jnp.asarray(g)) for g in grads])
    got = torch.stack([port_step._pack_signs(torch.from_numpy(g))
                       for g in grads])
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    for voters in (1, 2, 5):
        w = ref_step._majority_from_packed(want[:voters], voters, n)
        g = port_step._majority_from_packed(got[:voters], voters, n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    votes = (grads >= 0).sum(0)
    np.testing.assert_array_equal(
        port_step._majority_from_packed(got, 5, n).numpy(),
        np.where(2 * votes > 5, 1.0, -1.0))


def test_pack_signs_of_a_matrix_packs_its_flat_order():
    """Bit i is element i of the flattened tensor; the padding lanes are
    zeros and pack as 1 (0.0 ≥ 0), as in the reference."""
    g = torch.tensor([[-0.0, 1.0, -2.0], [0.0, -1e-9, 3.0]])
    word = int(port_step._pack_signs(g)[0]) & 0xFFFFFFFF
    assert word == 0xFFFFFFC0 | 0b101011


# -- loss and gradients --------------------------------------------------------

def loss_and_grads(model, cfg, batch, loss_chunk: int = 0):
    loss_fn = port_step.make_loss_fn(cfg, loss_chunk=loss_chunk)
    for p in model.parameters():
        p.grad = None
    objective, metrics = loss_fn(model, batch)
    objective.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(objective.detach()), metrics, grads


@pytest.mark.parametrize("loss_chunk", [0, 8, 32])
def test_loss_fn_matches_reference(loss_chunk):
    rcfg, pcfg = configs(compute_dtype="float32")
    tree = ref_tree(rcfg)
    rd, pd = data_cfgs(rcfg)
    rb, pb = ref_data.synthetic_batch(rd, 0), port_data.synthetic_batch(
        pd, 0, device="cpu")
    fn = jax.jit(jax.value_and_grad(
        ref_step.make_loss_fn(rcfg, loss_chunk=loss_chunk), has_aux=True))
    (want, want_m), want_g = fn(jax.tree.map(jnp.asarray, tree), rb)
    model = params_from_reference(pcfg, tree, "cpu")
    got, got_m, got_g = loss_and_grads(model, pcfg, pb, loss_chunk)
    assert abs(got - float(want)) <= LOSS_REL * abs(float(want))
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) \
        <= LOSS_REL * abs(float(want_m["loss"]))
    assert_tree_close(params_to_reference(model, got_g), want_g, F32_REL)


def test_chunked_loss_needs_chunks_that_divide_the_sequence():
    _, pcfg = configs(compute_dtype="float32")
    model = port_state(pcfg).params
    _, pd = data_cfgs(pcfg, s=30)
    with pytest.raises(RuntimeError):           # 4 chunks of 7 positions
        port_step.make_loss_fn(pcfg, loss_chunk=7)(
            model, port_data.synthetic_batch(pd, 0, device="cpu"))


# -- the train step ------------------------------------------------------------

def assert_trajectories_close(rcfg, pcfg, microbatches: int = 1,
                              loss_chunk: int = 0):
    """``STEPS`` steps of ``jax.jit(make_train_step(...))`` and the port's,
    from the same parameters on the same batches."""
    ropt, popt = opt_cfgs()
    tree = ref_tree(rcfg)
    rstep = jax.jit(ref_step.make_train_step(rcfg, ropt, microbatches,
                                             loss_chunk))
    rstate = ref_step.init_train_state(jax.tree.map(jnp.asarray, tree))
    pstep = port_step.make_train_step(pcfg, popt, microbatches, loss_chunk)
    pstate = port_step.init_train_state(
        params_from_reference(pcfg, tree, "cpu"))
    rd, pd = data_cfgs(rcfg)
    for s in range(STEPS):
        rstate, want = rstep(rstate, ref_data.synthetic_batch(rd, s))
        pstate, got = pstep(pstate, port_data.synthetic_batch(
            pd, s, device="cpu"))
        assert set(got) == {"loss", "aux", "grad_norm", "lr"}
        for k, rel in (("loss", LOSS_REL), ("grad_norm", LOSS_REL),
                       ("lr", ULP)):
            assert abs(float(got[k]) - float(want[k])) \
                <= rel * abs(float(want[k])), (s, k)
    assert int(pstate.opt.step) == int(rstate.opt.step) == STEPS
    got = np.concatenate([v.ravel() for _, v in port_params.tree_leaves(
        params_to_reference(pstate.params))])
    want = np.concatenate([np.asarray(v).ravel() for _, v in
                           port_params.tree_leaves(jax.tree.map(
                               np.asarray, rstate.params))])
    err = np.abs(got - want)
    assert err.max() <= LR * STEPS, err.max()
    assert (err > 1e-5).mean() <= 1e-3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_trajectory_matches_reference(microbatches):
    rcfg, pcfg = configs(compute_dtype="float32")
    assert_trajectories_close(rcfg, pcfg, microbatches=microbatches)


def test_chunked_loss_train_step_matches_reference():
    rcfg, pcfg = configs(compute_dtype="float32")
    assert_trajectories_close(rcfg, pcfg, loss_chunk=16)


def test_microbatch_metrics_are_the_last_microbatchs():
    _, pcfg = configs(compute_dtype="float32")
    _, pd = data_cfgs(pcfg)
    batch = port_data.synthetic_batch(pd, 0, device="cpu")
    state = port_state(pcfg)
    want = port_step.make_loss_fn(pcfg)(state.params,
                                        {k: v[B // 2:] for k, v in
                                         batch.items()})[1]["loss"]
    _, popt = opt_cfgs()
    _, got = port_step.make_train_step(pcfg, popt, microbatches=2)(state,
                                                                   batch)
    assert float(got["loss"]) == float(want)


@pytest.mark.parametrize("where", ["loss", "backward"])
def test_train_step_updates_in_place_only_after_the_backward(where):
    """A step that fails before its update (in the loss, or in the
    backward pass after some gradients were accumulated) leaves the state
    bit for bit as it was; the same step then retried equals a step that
    never failed."""
    _, pcfg = configs(compute_dtype="float32")
    _, popt = opt_cfgs()
    step = port_step.make_train_step(pcfg, popt)
    _, pd = data_cfgs(pcfg)
    batch = port_data.synthetic_batch(pd, 1, device="cpu")
    clean, _, _ = trained_state(1)
    clean, want = step(clean, batch)
    state, _, _ = trained_state(1)
    before = state_tensors(state)
    if where == "loss":
        bad = dict(batch, labels=batch["labels"] + pcfg.vocab)
    else:
        bad = batch

        def fail(grad):
            raise RuntimeError("simulated failure in the backward pass")
        hook = state.params.embed.register_hook(fail)
    with pytest.raises(RuntimeError):
        step(state, bad)
    assert_states_equal(state_tensors(state), before)
    if where == "backward":
        assert state.params.blocks[1].ffn.w_down.grad is not None
        hook.remove()
    state, got = step(state, batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert_states_equal(state_tensors(state), state_tensors(clean))


def test_every_parameter_gets_a_gradient_or_zeros():
    """zamba2's reduced config calls the shared block (every parameter
    then has a gradient); a model whose shared block never runs still
    decays it, as ``jax.grad``'s zeros do in the reference."""
    _, pcfg = configs("zamba2_7b", n_layers=5, layer_pattern=("ssm",) * 5)
    _, popt = opt_cfgs()
    state = port_state(pcfg)
    w = state.params.shared_attn.attn.wq.detach().clone()
    _, pd = data_cfgs(pcfg)
    state, m = port_step.make_train_step(pcfg, popt)(
        state, port_data.synthetic_batch(pd, 0, device="cpu"))
    assert bool(torch.isfinite(m["loss"]))
    assert torch.equal(state.opt.m["shared_attn.attn.wq"],
                       torch.zeros_like(w))
    want = w - float(m["lr"]) * popt.weight_decay * w
    torch.testing.assert_close(state.params.shared_attn.attn.wq.detach(),
                               want, rtol=1e-6, atol=0)


# -- checkpoint and failover ---------------------------------------------------

def trained_state(steps: int = 2):
    _, pcfg = configs(compute_dtype="float32")
    _, popt = opt_cfgs()
    state = port_state(pcfg)
    step = port_step.make_train_step(pcfg, popt)
    _, pd = data_cfgs(pcfg)
    for s in range(steps):
        state, _ = step(state, port_data.synthetic_batch(pd, s,
                                                         device="cpu"))
    return state, step, pd


def test_checkpoint_roundtrip_is_exact(tmp_path):
    state, _, _ = trained_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, blocking=True)
    assert mgr.latest_step() == 7
    saved = state_tensors(state)
    assert {"params__embed", "opt__step", "opt__m__blocks.1.attn.wq",
            "opt__v__final_norm.scale"} <= saved.keys()
    fresh = port_state(state.params.cfg, seed=2)
    assert not torch.equal(fresh.params.embed, state.params.embed)
    restored = mgr.restore(7, fresh)
    assert restored is fresh
    assert_states_equal(state_tensors(restored), saved)
    mgr.close()


def test_checkpoint_snapshots_before_returning(tmp_path):
    """The save copies to host memory before it returns: in-place updates
    after it do not reach the checkpoint."""
    state, step, pd = trained_state(1)
    saved = state_tensors(state)
    mgr = CheckpointManager(str(tmp_path))
    fut = mgr.save(1, state)
    step(state, port_data.synthetic_batch(pd, 1, device="cpu"))
    fut.result()
    mgr.restore(1, state)
    assert_states_equal(state_tensors(state), saved)
    mgr.close()


def test_checkpoint_gc_atomicity_and_refusals(tmp_path):
    state, _, _ = trained_state(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == [3, 4]
    assert not any(".tmp" in p for p in os.listdir(tmp_path))
    other = port_state(configs(compute_dtype="float32",
                               d_model=32)[1])
    with pytest.raises(ValueError, match="cannot restore"):
        mgr.restore(4, other)
    mgr.close()


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    state, step, pd = trained_state(2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=True)
    straight = []
    for s in range(2, 5):
        state, m = step(state, port_data.synthetic_batch(pd, s,
                                                         device="cpu"))
        straight.append(m)
    end = state_tensors(state)
    resumed = mgr.restore(2, port_state(state.params.cfg, seed=3))
    assert int(resumed.opt.step) == 2
    for s, want in zip(range(2, 5), straight):
        resumed, got = step(resumed, port_data.synthetic_batch(
            pd, s, device="cpu"))
        for k in want:
            assert torch.equal(got[k], want[k]), (s, k)
    assert_states_equal(state_tensors(resumed), end)
    mgr.close()


def test_failover_restores_after_persistent_failure(tmp_path):
    state, step, pd = trained_state(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    boom = {"armed": True}

    def injector(s):
        if s == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    runner = FailoverRunner(step, mgr,
                            FailoverConfig(checkpoint_every=2, max_retries=0),
                            failure_injector=injector)
    final, hist = runner.run(state, lambda s: port_data.synthetic_batch(
        pd, s, device="cpu"), 0, 6)
    assert "step 3 attempt 0 failed: RuntimeError" in runner.events
    assert "restored at step 2" in runner.events
    assert int(final.opt.step) == 6 and mgr.latest_step() == 6
    # steps 2 and 3 ran twice; the restored run repeats step 2 exactly
    assert len(hist) == 7 and hist[2] == hist[3]
    clean, _, _ = trained_state(6)
    assert_states_equal(state_tensors(final), state_tensors(clean))
    mgr.close()


def test_failover_retries_a_transient_failure_exactly(tmp_path):
    state, step, pd = trained_state(0)
    mgr = CheckpointManager(str(tmp_path))
    fails = {1: 2}

    def injector(s):
        if fails.get(s):
            fails[s] -= 1
            raise RuntimeError("transient")

    runner = FailoverRunner(step, mgr, FailoverConfig(max_retries=2),
                            failure_injector=injector)
    final, hist = runner.run(state, lambda s: port_data.synthetic_batch(
        pd, s, device="cpu"), 0, 3)
    assert len(hist) == 3 and not any("restored" in e for e in runner.events)
    clean, _, _ = trained_state(3)
    assert_states_equal(state_tensors(final), state_tensors(clean))
    mgr.close()


def test_straggler_monitor_flags_the_reference_steps():
    rng = np.random.default_rng(5)
    times = rng.uniform(0.09, 0.11, 80)
    times[[3, 10, 11, 40, 70]] = [1.0, 0.5, 0.31, 0.29, 2.0]
    want, got = RefMonitor(3.0, keep=16), StragglerMonitor(3.0, keep=16)
    flags = [(want.record(i, t), got.record(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert got.flagged == want.flagged and [s for s, _ in got.flagged] \
        == [10, 11, 70]


# -- parameters ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "olmoe_1b_7b",
                                  "zamba2_7b", "whisper_large_v3"])
def test_abstract_params_match_reference(arch):
    rcfg, pcfg = configs(arch)
    full_r = ref_configs.get_config(arch)
    full_p = port_configs.get_config(arch)
    for rc, pc in ((rcfg, pcfg), (full_r, full_p)):
        want = ref_params.abstract_params(ref_tf.model_defs(rc))
        got = port_params.abstract_params(port_tf.model_defs(pc))
        wl = jax.tree.leaves_with_path(want)
        gl = port_params.tree_leaves(got)
        assert [".".join(k.key for k in p) for p, _ in wl] \
            == [p for p, _ in gl]
        for (_, w), (_, g) in zip(wl, gl):
            assert g.is_meta and g.dtype == torch.float32
            assert tuple(g.shape) == w.shape
    bf16 = port_params.abstract_params(port_tf.model_defs(pcfg),
                                       torch.bfloat16)
    assert port_params.tree_leaves(bf16)[0][1].dtype == torch.bfloat16


# -- launcher and example ------------------------------------------------------

def run_module(*args, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_train_on_the_cpu_exits_0(tmp_path):
    out = run_module("repro_torch.launch.train", "--device", "cpu",
                     "--reduced", "--steps", "6", "--batch", "4", "--seq",
                     "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final loss" in out.stdout and "device=cpu" in out.stdout
    assert CheckpointManager(str(tmp_path)).steps() == [3, 6]


def test_launch_train_refuses_compressed(tmp_path, capsys):
    """``--compressed`` was refused until the majority-vote exchange was
    ported; now it trains, here as a world of one over gloo, and leaves
    no process group behind."""
    assert port_launch.main(["--device", "cpu", "--reduced", "--compressed",
                             "--steps", "6", "--batch", "4", "--seq", "32",
                             "--lr", "5e-3", "--log-every", "1",
                             "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "compressed=True" in out and "final loss" in out
    assert not torch.distributed.is_initialized()


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    port_launch.main(argv)
    capsys.readouterr()
    port_launch.main(argv[:4] + ["8"] + argv[5:])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 4" in out and "step     4" in out
    assert "step     3" not in out


def test_setup_runs_on_cuda_unless_asked(monkeypatch):
    _, pcfg = configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.setup(pcfg, None, port_opt.AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_data.synthetic_batch(port_data.DataConfig(), 0)
    state, _, _ = port_launch.setup(pcfg, None, port_opt.AdamWConfig(),
                                    device="cpu")
    assert state.params.device.type == "cpu"


def test_train_100m_example_at_a_smoke_setting(tmp_path, monkeypatch, capsys):
    """The example's loop at a small width (its 111M-parameter config is
    the card's: ``chip_smoke.py`` phase 4g runs it)."""
    assert sum(int(np.prod(d.shape)) for _, d in port_params.tree_leaves(
        port_tf.model_defs(train_100m.CONFIG_100M))) == 111_096_960
    small = dataclasses.replace(train_100m.CONFIG_100M, n_layers=2,
                                d_model=64, n_heads=4, n_kv_heads=2,
                                d_ff=128, vocab=512)
    monkeypatch.setattr(train_100m, "CONFIG_100M", small)
    rc = train_100m.main(["--device", "cpu", "--steps", "12", "--batch", "4",
                          "--seq", "32", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "improved" in out and "over 12 steps" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 12
