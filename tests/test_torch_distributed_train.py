"""The sharded plain training step, the elastic checkpoint and the
launcher across gloo ranks.

* ``launch.train.setup``'s sharded step (parameters placed by
  ``tree_shardings``, the batch over the data axes, DTensor's collectives)
  on ``(4, 2)`` and ``(2, 2)`` meshes, for the dense, MoE, MLA
  (DeepSeek-V2) and SSM (Mamba2) families,
  against ``jax.jit(make_train_step)`` on one device, from the reference's
  parameters carried across, 3 steps in float32 compute: loss and
  ``grad_norm`` within 1e-4 relative, parameters within lr · steps with at
  most 0.1 % of the elements off by more than 1e-5 (the one-device tests'
  bound: Adam's first steps move an element by ≈ lr · sign(g));
* a checkpoint saved on ``(4, 2)`` restores on ``(2, 2)`` exactly, into a
  state placed there and, through ``shardings``, into a plain one;
* ``python -m repro_torch.launch.train --compressed --device cpu`` exits 0
  under 4 gloo ranks (a ``(2, 2)`` mesh).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro.train.data as ref_data
import repro.train.optimizer as ref_opt
import repro.train.train_step as ref_step
import repro_torch
import repro_torch.configs
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch.mesh import spawn_ranks

SRC = Path(repro_torch.__file__).resolve().parents[1]
ARCHS = ("qwen1_5_0_5b", "olmoe_1b_7b", "deepseek_v2_236b", "mamba2_130m")
B, S, STEPS, LR, REL = 8, 16, 3, 1e-3, 1e-4


def cfgs(arch: str):
    return (dataclasses.replace(ref_configs.get_reduced(arch),
                                compute_dtype="float32"),
            dataclasses.replace(repro_torch.configs.get_reduced(arch),
                                compute_dtype="float32"))


def flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}" if prefix else k).items()}
    return {prefix: np.asarray(tree)}


def unflat(arrays: dict) -> dict:
    out: dict = {}
    for path, a in arrays.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


def opt_kw() -> dict:
    return dict(lr=LR, warmup_steps=2, total_steps=6)


def sharded_rank(rank: int, world: int, n_model: int, tmp: str) -> None:
    """Each family, 3 sharded steps from the reference's parameters; rank 0
    saves metrics and whole parameters.  On (4, 2) the dense state is then
    checkpointed; on (2, 2) it is restored, two ways."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.checkpoint import state_leaves
    from repro_torch.distributed.sharding import param_placements
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import sharded_step
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    mesh = make_mesh((world // n_model, n_model), ("data", "model"), "cpu")

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()

    def build(arch, placed=True):
        _, cfg = cfgs(arch)
        init = unflat(dict(np.load(f"{tmp}/init_{arch}.npz")))
        model = params_from_reference(cfg, init, "cpu")
        if placed:
            from repro_torch.distributed.sharding import tree_shardings
            tree_shardings(model, mesh)
        return cfg, model

    for arch in ARCHS:
        cfg, model = build(arch)
        state = init_train_state(model)
        step = sharded_step(make_train_step(cfg, AdamWConfig(**opt_kw())),
                            mesh)
        d = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
        metrics = [step(state, synthetic_batch(d, i, device="cpu"))[1]
                   for i in range(STEPS)]
        params = {k: whole(p) for k, p in model.named_parameters()}
        out = {k: np.array([float(m[k]) for m in metrics])
               for k in ("loss", "grad_norm")}
        out.update({f"params/{k}": v for k, v in flat(params_to_reference(
            model, {k: torch.from_numpy(v) for k, v in params.items()})
        ).items()})
        if rank == 0:
            np.savez(f"{tmp}/port{world}x{n_model}_{arch}.npz", **out)
        if arch != ARCHS[0]:
            continue
        ckpt = CheckpointManager(f"{tmp}/ckpt")
        if n_model == 2 and world == 8:
            leaves = {k: whole(t) for k, t in state_leaves(state).items()}
            if rank == 0:
                np.savez(f"{tmp}/saved.npz", **leaves)
            ckpt.save(STEPS, state, mesh, blocking=True)
        else:
            # fresh states: one placed on this mesh, one plain
            fresh = init_train_state(build(arch)[1])
            restored = ckpt.restore(STEPS, fresh)
            _, plain = build(arch, placed=False)
            plain_state = init_train_state(plain)
            pl = param_placements(plain, mesh)
            placed = ckpt.restore(STEPS, plain_state, {
                f"params__{k}": (mesh, p) for k, p in pl.items()})
            got = {k: whole(t) for k, t in state_leaves(restored).items()}
            got2 = {k: whole(t) for k, t in state_leaves(placed).items()}
            kinds = {k: type(t).__name__ for k, t in
                     state_leaves(placed).items()}
            if rank == 0:
                np.savez(f"{tmp}/restored.npz", **got)
                np.savez(f"{tmp}/restored_plain.npz", **got2)
                np.save(f"{tmp}/kinds.npy", np.array(sorted(kinds.items())))
        ckpt.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    for arch in ARCHS:
        ref_cfg, _ = cfgs(arch)
        params = ref_params.init_params(ref_tf.model_defs(ref_cfg),
                                        jax.random.key(7))
        np.savez(tmp / f"init_{arch}.npz",
                 **flat(jax.tree.map(np.asarray, params)))
        state = ref_step.init_train_state(params)
        step = jax.jit(ref_step.make_train_step(
            ref_cfg, ref_opt.AdamWConfig(**opt_kw())))
        d = ref_data.DataConfig(vocab=ref_cfg.vocab, seq_len=S,
                                global_batch=B)
        metrics = []
        for i in range(STEPS):
            state, m = step(state, ref_data.synthetic_batch(d, i))
            metrics.append(m)
        out = {k: np.array([float(m[k]) for m in metrics])
               for k in ("loss", "grad_norm")}
        out.update({f"params/{k}": v for k, v in flat(
            jax.tree.map(np.asarray, state.params)).items()})
        np.savez(tmp / f"ref_{arch}.npz", **out)
    spawn_ranks(sharded_rank, 8, (2, str(tmp)), timeout=300)
    spawn_ranks(sharded_rank, 4, (2, str(tmp)), timeout=300)
    return tmp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
def test_sharded_step_equals_the_single_device_reference(runs, mesh, arch):
    world = {"4x2": 8, "2x2": 4}[mesh]
    got = dict(np.load(runs / f"port{world}x2_{arch}.npz"))
    want = dict(np.load(runs / f"ref_{arch}.npz"))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=0,
                                   err_msg=k)
    keys = sorted(k for k in want if k.startswith("params/"))
    assert keys == sorted(k for k in got if k.startswith("params/"))
    for k in keys:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= LR * STEPS, (k, float(diff.max()))
        assert (diff > 1e-5).sum() <= 1e-3 * diff.size, k


def test_checkpoint_saved_on_4x2_restores_on_2x2_exactly(runs):
    saved = dict(np.load(runs / "saved.npz"))
    manifest = (runs / "ckpt" / f"step_{STEPS:08d}" / "manifest.json")
    assert '"mesh_axes": ["data", "model"]' in manifest.read_text()
    for name in ("restored.npz", "restored_plain.npz"):
        got = dict(np.load(runs / name))
        assert got.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    kinds = dict(np.load(runs / "kinds.npy"))
    assert {kinds[k] for k in kinds if k.startswith("params__")} \
        == {"DTensor"}


def _launch_rank(rank: int, world: int, tmp: Path):
    env = dict(os.environ, PYTHONPATH=str(SRC), RANK=str(rank),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--compressed", "--steps", "6", "--batch", "8",
         "--seq", "32", "--lr", "5e-3", "--log-every", "1", "--ckpt-every",
         "3", "--ckpt-dir", str(tmp / "ckpt"), "--dist-init",
         f"file://{tmp / 'rendezvous'}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_launch_train_compressed_under_gloo_ranks(tmp_path):
    procs = [_launch_rank(r, 4, tmp_path) for r in range(4)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err[-3000:]
    assert "mesh={'data': 2, 'model': 2}" in outs[0][0]
    assert "compressed=True" in outs[0][0] and "final loss" in outs[0][0]
    assert CheckpointManager(str(tmp_path / "ckpt")).steps() == [3, 6]
