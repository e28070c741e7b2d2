"""Production mesh construction on ``torch.distributed``.

The reference's meshes (:mod:`repro.launch.mesh`) as
:func:`~torch.distributed.device_mesh.init_device_mesh` calls over the
default process group, which the caller creates first (a ``nccl`` or
``gloo`` group, or the dry-run's ``fake`` one).  Defined as functions,
never module-level state, so importing this module touches no process
group.  A mesh's device type is ``"cuda"`` unless the caller asks for the
CPU, as every entry point of the port; the dry-run's fake group uses
``"cpu"`` with ``meta`` tensors.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over every
    rank of the default process group (whose size must be the mesh's)."""
    return init_device_mesh(resolve_device(device_type).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16×16 = 256 ranks (data, model).
    Multi-pod: 2×16×16 = 512 ranks (pod, data, model) — the pod axis is the
    slowest (DCN-connected in the reference's TPU setting) dimension."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cuda"):
    """Small mesh for the spawned-process distributed tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def _rank_main(rank: int, fn, world: int, init: str, args: tuple) -> None:
    """A spawned rank: join the gloo group through ``init``, run ``fn``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), timeout: float = 300.0,
                rendezvous_dir: str | None = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``gloo`` process group, meeting through a file in
    ``rendezvous_dir`` (a fresh temporary directory by default: no port).
    ``fn`` must be importable by name; each rank runs one CPU thread.
    Raises if a rank exits with an error, or is still running after
    ``timeout`` seconds (then every rank is killed)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, world, init, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if hung or failed:
            raise RuntimeError(f"spawned ranks failed: still running after "
                               f"{timeout} s {hung}, exit codes {failed}")
