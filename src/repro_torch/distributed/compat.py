"""The torch counterparts of the reference's version shims
(:mod:`repro.distributed.compat`).

JAX runs one program over every device and ``shard_map`` makes a function
*manual* over some mesh axes: its body sees each device's block and names
those axes in explicit collectives.  ``torch.distributed`` already runs one
process per rank, so a manual body is simply the per-process code; what it
needs is the process group of the manual axes and the collectives over
it.  :class:`ManualGroup` is that group, :func:`shard_map_compat` gives a
body its block of the batch.  XLA's ``cost_analysis`` has no torch
counterpart; :func:`cost_analysis_dict` returns the measure the dry-run
takes instead (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist


def _subgroup(mesh, names: tuple[str, ...]):
    """The process group of this rank's ranks that differ only along the
    mesh dimensions ``names`` (one group per fixed coordinate of the other
    dimensions, created by every rank)."""
    if len(names) == 1:
        return mesh.get_group(names[0])
    dims = [mesh.mesh_dim_names.index(n) for n in names]
    keep = [d for d in range(mesh.ndim) if d not in dims]
    ranks = mesh.mesh.permute(*keep, *dims).reshape(
        -1, math.prod(mesh.shape[d] for d in dims))
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return group


class ManualGroup:
    """The ranks a step is manual over: the mesh dimensions ``axis_names``
    (the data axes, ``("data",)`` or ``("pod", "data")`` flattened in mesh
    order), with this rank's coordinates along the others fixed.  Its
    collectives are the reference's ``jax.lax`` ones over those axes:

    * :meth:`all_gather`: ``all_gather(x, axes, tiled=False)``, a new
      leading axis of ``size``;
    * :meth:`psum` and :meth:`pmean`;
    * :meth:`all_to_all`: ``all_to_all(x, axes, 0, 0, tiled=True)`` — row
      block ``j`` of every rank lands, in rank order, on rank ``j``.

    Each runs on CUDA tensors over ``nccl`` and over ``gloo`` (measured
    on the H100 machine, ``chip_smoke.py`` phase 4h).
    """

    def __init__(self, mesh, axis_names) -> None:
        wanted = set(axis_names)
        self.names = tuple(a for a in mesh.mesh_dim_names if a in wanted)
        if set(self.names) != wanted:
            raise ValueError(f"{sorted(wanted)} are not all dimensions of "
                             f"the mesh {mesh.mesh_dim_names}")
        self.group = _subgroup(mesh, self.names)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_empty(self.size * t.numel())
        dist.all_gather_into_tensor(out, t.reshape(-1), group=self.group)
        return out.view((self.size,) + tuple(t.shape))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self.psum(t) / self.size

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out


def stage_gloo_all_gather_through_host():
    """Route this process's ``_c10d_functional.all_gather_into_tensor`` on
    CUDA tensors through host memory: the operand is copied to the CPU,
    gathered there and copied back.

    DTensor gathers a sharded tensor with that functional collective, and
    over ``gloo`` it crashes the process on CUDA tensors (a segmentation
    fault, torch 2.11 on the H100 machine; gloo's other collectives, and
    the eager ``all_gather_into_tensor``, run on CUDA tensors).  The CUDA
    kernel of the op is replaced for the whole process, so call this only
    in a process whose collectives all run over ``gloo``: several ranks
    sharing one card (``chip_smoke.py`` phase 4h), where ``nccl`` cannot
    run.  Returns the library registration, which must stay alive."""
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def staged(tensor, group_size: int, group_name: str):
        out = torch.ops._c10d_functional.all_gather_into_tensor(
            tensor.cpu(), group_size, group_name)
        return torch.ops._c10d_functional.wait_tensor(out).to(tensor.device)

    lib.impl("all_gather_into_tensor", staged, "CUDA")
    return lib


def _block(t: torch.Tensor, spec, group: ManualGroup) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: dim 0 split over the
    manual axes when its entry names them, else ``t`` whole."""
    entry = spec[0] if len(spec) else None
    names = entry if isinstance(entry, tuple) else (entry,)
    if entry is None or not set(names) <= set(group.names):
        return t
    if t.shape[0] % group.size:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split over "
                         f"{group.size} ranks of {group.names}")
    n = t.shape[0] // group.size
    return t[group.rank * n:(group.rank + 1) * n]


def shard_map_compat(f, mesh, axis_names, in_specs):
    """The reference's ``shard_map_compat(f, mesh, axis_names, in_specs,
    out_specs)``: ``f`` made manual over the mesh dimensions
    ``axis_names``.

    In torch every process already runs ``f``; the returned function gives
    it, for each argument, this rank's block (the leading dim split over
    the manual axes where the argument's spec names them — a spec is the
    reference's ``PartitionSpec`` entries; a dict argument takes a dict of
    specs) and returns ``f``'s result as it is.  Differences: the specs of
    other dimensions are not applied (a tensor parallel over ``model``
    lives in ``f``'s own DTensors), and there are no ``out_specs``: each
    process returns its own value, which ``f`` makes equal through its
    collectives where the reference's output is replicated."""
    group = ManualGroup(mesh, axis_names)

    def one(arg, spec):
        if isinstance(arg, dict):
            return {k: one(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in arg.items()}
        if isinstance(arg, torch.Tensor) and spec is not None:
            return _block(arg, tuple(spec), group)
        return arg

    def g(*args):
        return f(*(one(a, s) for a, s in itertools.zip_longest(
            args, in_specs)))

    g.group = group
    return g


def cost_analysis_dict(stats: dict) -> dict:
    """The reference's ``cost_analysis_dict(compiled)`` reads XLA's
    ``{"flops", "bytes accessed"}`` of a compiled step.  Torch compiles
    nothing here; the dry-run counts the step as it runs on meta tensors
    (``FlopCounterMode`` on the local shards for the FLOPs, the bytes each
    op reads and writes for the bytes, see
    :func:`repro_torch.launch.dryrun.count_step`), and this returns those
    two counts under XLA's keys."""
    return {"flops": float(stats.get("flops", 0.0)),
            "bytes accessed": float(stats.get("bytes", 0.0))}
