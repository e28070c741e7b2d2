"""The majority-vote compressed data-parallel step
(``repro_torch.train.train_step.make_compressed_train_step``) on 2 and 4
gloo ranks against the reference's compressed step on an ``(R, 1)`` mesh
of R forced host devices (a subprocess), from the reference's parameters
carried across, on the same batches: the ``packed`` and ``psum``
exchanges, fused and per leaf, and the ``two_phase`` exchange; and the port
on a ``(2, 2)`` mesh (parameters sharded over ``model``) against the
reference's ``(2, 1)``.

Tolerances, over 3 steps of float32 compute: losses and ``grad_norm``
within 1e-5 relative; parameters and error-feedback buffers within 1e-5
but for the elements whose vote turned (a gradient sign that the two
frameworks' sums round differently), at most one, or 0.1 %, of a leaf:
such a parameter lies within 2·lr a step (Adam's first steps move an
element by ≈ lr), such an error-feedback entry within twice the leaf's
scale, less than twice its largest entry.
Every rank holds the same parameters, bit for bit.  The error feedback
compared is rank 0's: the reference's is per device too, and reads back
as device 0's.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro_torch
import repro_torch.configs
from repro_torch.launch.mesh import spawn_ranks

SRC = Path(repro_torch.__file__).resolve().parents[1]
ARCH, B, S, STEPS, LR = "qwen1_5_0_5b", 8, 32, 3, 1e-3
REL = 1e-5
FAR = 1e-5       # an element off by more has had its vote turned
# name → (exchange, fused, two_phase)
VARIANTS = {"packed": ("packed", True, False), "psum": ("psum", True, False),
            "packed_per_leaf": ("packed", False, False),
            "psum_per_leaf": ("psum", False, False),
            "two_phase": ("packed", True, True)}

REFERENCE = """
    import dataclasses, sys
    import jax, numpy as np
    from jax.sharding import PartitionSpec as PS
    from repro.configs import get_reduced
    from repro.distributed.compat import shard_map_compat
    from repro.models.params import init_params
    from repro.models.transformer import model_defs
    from repro.train.data import DataConfig, synthetic_batch
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import (init_train_state,
                                        make_compressed_train_step)
    R, B, S, STEPS, LR = {r}, {b}, {s}, {steps}, {lr}
    cfg = dataclasses.replace(get_reduced({arch!r}), compute_dtype="float32")
    mesh = jax.make_mesh((R, 1), ("data", "model"))
    d = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    flat = lambda t: {{"/".join(str(getattr(k, "key", k)) for k in p):
                      np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}}
    out = {{}}
    for name, (exchange, fused, two_phase) in {variants!r}.items():
        state = init_train_state(init_params(model_defs(cfg),
                                             jax.random.key(0)),
                                 compressed=True)
        inner, _ = make_compressed_train_step(
            cfg, AdamWConfig(lr=LR, warmup_steps=2, total_steps=6), mesh,
            fused=fused, two_phase=two_phase, exchange=exchange)
        step = jax.jit(shard_map_compat(
            inner, mesh=mesh, axis_names={{"data"}},
            in_specs=(jax.tree.map(lambda _: PS(), state),
                      {{"tokens": PS("data"), "labels": PS("data")}}),
            out_specs=(jax.tree.map(lambda _: PS(), state),
                       {{"loss": PS(), "aux": PS(), "grad_norm": PS(),
                         "lr": PS()}}), check_vma=False))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, synthetic_batch(d, i))
            metrics.append(m)
        for k in ("loss", "grad_norm", "lr"):
            out[f"{{name}}/{{k}}"] = np.array([float(m[k]) for m in metrics])
        for k, v in flat(state.params).items():
            out[f"{{name}}/params/{{k}}"] = v
        for k, v in flat(state.error_fb).items():
            out[f"{{name}}/error_fb/{{k}}"] = v
    np.savez(sys.argv[1], **out)
"""


def cfgs():
    ref = dataclasses.replace(ref_configs.get_reduced(ARCH),
                              compute_dtype="float32")
    return ref, dataclasses.replace(repro_torch.configs.get_reduced(ARCH),
                                    compute_dtype="float32")


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


def port_rank(rank: int, world: int, n_model: int, init_npz: str,
              out_dir: str) -> None:
    """Every variant (one, ``packed``, on a model axis), 3 steps, from the
    reference's initial parameters; each rank saves its metrics, whole
    parameters and error feedback."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.compat import shard_map_compat
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.interop import params_from_reference, params_to_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_compressed_train_step)
    _, cfg = cfgs()
    mesh = make_mesh((world // n_model, n_model), ("data", "model"), "cpu")
    init = unflat(dict(np.load(init_npz)))
    d = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    variants = VARIANTS if n_model == 1 else {"packed": VARIANTS["packed"]}

    def whole(named: dict) -> dict:
        return {k: t.full_tensor() if isinstance(t, DTensor) else t
                for k, t in named.items()}

    for name, (exchange, fused, two_phase) in variants.items():
        model = params_from_reference(cfg, init, "cpu")
        if n_model > 1:
            tree_shardings(model, mesh["model"])
        state = init_train_state(model, compressed=True)
        inner, axes = make_compressed_train_step(
            cfg, AdamWConfig(lr=LR, warmup_steps=2, total_steps=6), mesh,
            fused=fused, two_phase=two_phase, exchange=exchange)
        step = shard_map_compat(inner, mesh, set(axes),
                                in_specs=(None, {"tokens": ("data",),
                                                 "labels": ("data",)}))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, synthetic_batch(d, i, device="cpu"))
            metrics.append(m)
        out = {k: np.array([float(m[k]) for m in metrics])
               for k in ("loss", "grad_norm", "lr")}
        params = whole(dict(model.named_parameters()))
        out.update({f"params/{k}": v for k, v in flat(
            params_to_reference(model, params)).items()})
        out.update({f"error_fb/{k}": v for k, v in flat(
            params_to_reference(model, whole(state.error_fb))).items()})
        np.savez(f"{out_dir}/{name}_{rank}.npz", **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(R, n_model): (reference npz or None, [rank npz])}: the reference's
    subprocesses run while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("compressed")
    ref_cfg, _ = cfgs()
    init = jax.tree.map(np.asarray, ref_params.init_params(
        ref_tf.model_defs(ref_cfg), jax.random.key(0)))
    np.savez(tmp / "init.npz", **flat(init))
    procs = {}
    for r in (2, 4):
        code = textwrap.dedent(REFERENCE.format(
            r=r, b=B, s=S, steps=STEPS, lr=LR, arch=ARCH, variants=VARIANTS))
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                   + f" --xla_force_host_platform_device_count={r}")
        procs[r] = subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"ref{r}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for world, n_model in ((2, 1), (4, 1), (4, 2)):
            out = tmp / f"port{world}x{n_model}"
            out.mkdir()
            spawn_ranks(port_rank, world,
                        (n_model, str(tmp / "init.npz"), str(out)),
                        timeout=300)
        for r, p in procs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs.values():
            p.kill()
    return tmp


def check(runs, ref_r: int, world: int, n_model: int, name: str):
    ref = dict(np.load(runs / f"ref{ref_r}.npz"))
    got = [dict(np.load(runs / f"port{world}x{n_model}" / f"{name}_{r}.npz"))
           for r in range(world)]
    for k in ("loss", "grad_norm"):
        want = ref[f"{name}/{k}"]
        np.testing.assert_allclose(got[0][k], want, rtol=REL, atol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got[0]["lr"], ref[f"{name}/lr"], rtol=3e-7)
    bound = 2 * float(ref[f"{name}/lr"].sum())      # 2·lr a step
    for kind in ("params", "error_fb"):
        keys = sorted(k for k in got[0] if k.startswith(kind + "/"))
        assert keys and keys == sorted(
            k.split("/", 1)[1] for k in ref if k.startswith(f"{name}/{kind}/"))
        for k in keys:
            want = ref[f"{name}/{k}"]
            diff = np.abs(got[0][k] - want)
            # only an element whose vote the two packages' sums decide
            # differently lies beyond 1e-5: its parameter moves by at most
            # 2·lr a step, its error feedback by twice the leaf's scale
            far = diff > FAR
            assert far.sum() <= max(1, 1e-3 * diff.size), (k, int(far.sum()))
            if kind == "params":
                assert diff.max() <= bound, (k, float(diff.max()), bound)
            else:
                assert diff.max() <= 2 * np.abs(want).max(), (k, diff.max())
    for r in range(1, world):                  # one model, every rank
        for k in got[0]:
            if k.startswith("params/"):
                np.testing.assert_array_equal(got[r][k], got[0][k], k)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_compressed_step_equals_the_reference(runs, world, name):
    check(runs, world, world, 1, name)


def test_compressed_step_on_a_model_axis_equals_the_reference(runs):
    """(2, 2): each leaf's scale is its whole mean over the model shards;
    the reference's (2, 1) computes the same values."""
    check(runs, 2, 4, 2, "packed")
