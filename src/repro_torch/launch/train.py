"""End-to-end training launcher.

Wires configs → mesh → placed state → data pipeline → training loop with
periodic checkpoints (resuming from the latest one in ``--ckpt-dir``) and,
with ``--compressed``, majority-vote compressed data parallelism: the
reference's launcher (:mod:`repro.launch.train`) on ``torch.distributed``.
Every rank runs this program: under ``torchrun`` the ranks join through
``env://`` (or ``--dist-init``); run alone it is a world of one.  The
process group is ``nccl`` on ``cuda`` and ``gloo`` on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 200 --batch 8 --seq 256 [--compressed] [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --reduced --compressed \
        --steps 6 --batch 8 --seq 32 --lr 5e-3 --ckpt-dir DIR

Runs on ``cuda`` unless ``--device`` says otherwise.  Exits 0 iff the last
logged loss is below the first.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..distributed.checkpoint import CheckpointManager
from ..distributed.compat import shard_map_compat
from ..distributed.sharding import batch_shardings, tree_shardings
from ..models.transformer import Transformer
from ..train.data import DataConfig, synthetic_batch
from ..train.optimizer import AdamWConfig
from ..train.train_step import (init_train_state, make_compressed_train_step,
                                make_train_step)
from .mesh import make_mesh


def init_distributed(device, init_method: str | None = None) -> bool:
    """Create the default process group unless one exists; returns whether
    this call created it.  With ``RANK`` and ``WORLD_SIZE`` in the
    environment (``torchrun``) every rank joins through ``init_method``
    (default ``env://``); otherwise this process is a world of one,
    meeting itself through a file in a temporary directory (no port).
    ``nccl`` on ``cuda`` (each rank on ``cuda:LOCAL_RANK``), ``gloo`` on
    the CPU."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg"), "rdv")
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=0, world_size=1)
    return True


def build_mesh(n_model: int | None = None, device_type: str = "cuda"):
    """(data, model) over every rank of the default process group: a
    2-way model axis where the world is even and larger than one."""
    n_dev = dist.get_world_size()
    n_model = n_model or (2 if n_dev % 2 == 0 and n_dev > 1 else 1)
    return make_mesh((n_dev // n_model, n_model), ("data", "model"),
                     device_type)


def sharded_step(step, mesh):
    """The counterpart of ``jax.jit(step, in_shardings=...)``: the batch
    (the whole global batch on every rank) is sharded over the data axes,
    and ``step`` runs on DTensors, DTensor inserting the collectives the
    placements imply.  Tensors the model makes itself (positions, RoPE
    tables, masks, the zero ``aux``) are the same on every rank and enter
    as replicated (``implicit_replication``), also in the backward pass's
    recompute.  The metrics come back as plain tensors."""
    def run(state, batch):
        with implicit_replication():
            state, metrics = step(state, batch_shardings(mesh, batch))
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
    return run


def setup(cfg, mesh, opt_cfg: AdamWConfig, compressed: bool = False,
          microbatches: int = 1, seed: int = 0, exchange: str = "packed",
          device="cuda"):
    """``(state, placements, step)``: the model of ``cfg`` on ``device``,
    its parameters drawn in place from a generator seeded with ``seed``
    (the same on every rank), placed on ``mesh``, a fresh AdamW state placed
    like them, and the step.

    * ``compressed``: the majority-vote step, manual over the data axes
      (:func:`~repro_torch.distributed.compat.shard_map_compat` gives each
      rank its block of the batch); parameters sharded over ``model`` live
      on the mesh's ``model`` dimension.
    * otherwise, on a mesh of more than one rank: the plain step on
      parameters placed by ``tree_shardings`` (:func:`sharded_step`).
    * ``mesh`` None or of one rank: the plain step on plain tensors, one
      device — a DTensor of one rank would only add dispatch work.

    ``placements`` is ``{parameter name: placements}``, or None where
    nothing is placed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev).draw_params(gen)
    placements = None
    if compressed:
        if mesh["model"].size() > 1:
            placements = tree_shardings(model, mesh["model"])
        state = init_train_state(model, compressed=True)
        inner, data_axes = make_compressed_train_step(cfg, opt_cfg, mesh,
                                                      exchange=exchange)
        bspec = (data_axes if len(data_axes) > 1 else data_axes[0],)
        step = shard_map_compat(inner, mesh, set(data_axes),
                                in_specs=(None, {"tokens": bspec,
                                                 "labels": bspec}))
    elif mesh is not None and mesh.size() > 1:
        placements = tree_shardings(model, mesh)
        state = init_train_state(model)
        step = sharded_step(make_train_step(cfg, opt_cfg,
                                            microbatches=microbatches), mesh)
    else:
        state = init_train_state(model)
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    return state, placements, step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compressed", action="store_true",
                    help="majority-vote 1-bit gradient all-reduce")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: %(default)s)")
    ap.add_argument("--dist-init", default=None,
                    help="init method of the ranks' process group under "
                         "torchrun (default: env://)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    created = init_distributed(device, args.dist_init)
    try:
        return _train(args, cfg, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, cfg, device) -> int:
    mesh = build_mesh(device_type=device.type)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    state, _, step = setup(cfg, mesh, opt_cfg, compressed=args.compressed,
                           microbatches=args.microbatches, device=device)
    n_params = sum(p.numel() for p in state.params.parameters())
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device} "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"compressed={args.compressed}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore(start, state)
        if rank0:
            print(f"resumed from checkpoint step {start}")

    t0 = time.time()
    losses = []
    try:
        for s in range(start, args.steps):
            state, metrics = step(state, synthetic_batch(dcfg, s,
                                                         device=device))
            if s % args.log_every == 0 or s == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                if rank0:
                    print(f"step {s:5d} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"({(time.time()-t0):.1f}s)")
            if (s + 1) % args.ckpt_every == 0:
                ckpt.save(s + 1, state, mesh)
    finally:
        ckpt.close()
    if not losses:
        print(f"nothing to train: the checkpoint in {args.ckpt_dir} is at "
              f"step {start}, --steps is {args.steps}")
        return 1
    if rank0:
        print(f"final loss {losses[-1]:.4f} (initial {losses[0]:.4f})")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
