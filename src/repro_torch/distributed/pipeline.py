"""GPipe-style pipeline parallelism over an explicit mesh dimension.

The reference's ``pipeline_apply`` (:mod:`repro.distributed.pipeline`) on
``torch.distributed``: a homogeneous stage function over ``P`` pipeline
stages, one a rank of the mesh dimension ``axis``, streaming ``M``
microbatches with the classic (M + P − 1)-tick schedule.  Activations move
one stage down the ring after every tick; the reference's ``ppermute``
becomes an ``all_to_all_single`` whose only non-empty block goes to the
next stage (gloo has no point-to-point path for CUDA tensors, and this
collective runs on every backend).  It is the differentiable one of
``torch.distributed.nn.functional``: its backward pass is the same
exchange with the splits swapped, so the cotangent moves one stage back,
as ``jax.grad`` through ``ppermute`` does.  The whole schedule is
differentiable (GPipe semantics: no weight staleness).

Stage parameters are stacked on a leading axis of size P and placed
``Shard(0)`` over ``axis``, so each rank holds exactly its stage's weights.
"""
from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn
from torch.distributed.tensor import DTensor

from ..models.params import tree_map


def _stage_params(a, stage: int):
    """This stage's slice of a stacked leaf: a DTensor sharded over the
    pipe dimension holds it as its one local row; a plain stacked tensor
    (every stage's weights) is indexed."""
    return a.to_local()[0] if isinstance(a, DTensor) else a[stage]


def _shift(y: torch.Tensor, stage: int, p: int, group) -> torch.Tensor:
    """Stage ``i``'s ``y`` arrives at stage ``(i + 1) % p``."""
    n = y.shape[0]
    send = [0] * p
    send[(stage + 1) % p] = n
    recv = [0] * p
    recv[(stage - 1) % p] = n
    out = torch.empty_like(y)
    return dist_fn.all_to_all_single(out, y.contiguous(), recv, send,
                                     group=group)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str = "pipe",
                   microbatches: int | None = None):
    """Run ``stage_fn(params_p, x) -> y`` over P pipeline stages.

    stage_params: dict tree whose leaves are stacked on a leading axis P —
    DTensors placed ``Shard(0)`` over ``axis`` (each rank holds its stage's
    row), or plain stacked tensors.
    x: (M, mb, ...) microbatched input, the same on every rank (stage 0
    consumes it).

    Returns this rank's buffer of (M, mb, ...) outputs.  As in the
    reference, every stage returns its own buffer and only the last
    stage's is meaningful (the others hold zeros, tied to the graph with a
    zero cotangent): that is how the last stage's output reaches the
    caller, on the last stage's rank.  A loss over every rank's buffer
    then has the sequential composition's gradients; a broadcast of the
    last stage's output would count its cotangent once per rank.  Every
    rank must run the backward pass, since the ring's exchanges run in it.
    """
    p = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    m = x.shape[0] if microbatches is None else microbatches
    params = tree_map(lambda a: _stage_params(a, stage), stage_params)
    state = torch.zeros_like(x[0])            # current activation
    outputs = [torch.zeros_like(x[0]) for _ in range(m)]

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=x.device)

    # every stage runs the same ops each tick, selecting as the reference
    # does, so each rank's backward graph has the same ring exchanges in
    # the same order (a stage that skipped one would leave its peers
    # waiting in the backward pass)
    for t in range(m + p - 1):
        # stage 0 ingests microbatch t; the others take the shifted input
        x_in = torch.where(flag(stage == 0), x[min(t, m - 1)], state)
        y = torch.where(flag(0 <= t - stage < m), stage_fn(params, x_in),
                        state)
        # the last stage writes its result for microbatch t - P + 1
        i = min(max(t - p + 1, 0), m - 1)
        outputs[i] = torch.where(flag(stage == p - 1 and t >= p - 1), y,
                                 outputs[i])
        state = _shift(y, stage, p, group)
    return torch.stack(outputs)


def stack_stage_params(per_stage_params: list):
    """List of P per-stage dict trees → one tree with a leading P axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in per_stage_params])
                for k in first}
    return torch.stack(per_stage_params)
