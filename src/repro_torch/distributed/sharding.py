"""Logical-axis → mesh-dimension sharding, as DTensor placements.

The reference's rules (:mod:`repro.distributed.sharding`): model code names
*logical* axes (see :mod:`repro_torch.models.params`), mapped to mesh
dimensions with a divisibility-safe fallback: an axis whose dimension does
not divide by the mesh dimension's size replicates instead (e.g. granite's
single KV head, qwen2-vl's 12 heads on a 16-way model axis).  Data-parallel
batch axes span ``('pod', 'data')`` when the pod axis exists.

The reference resolves to a ``PartitionSpec``: one entry per tensor
dimension, naming the mesh axis (or axes) it is split over.  DTensor wants
one placement per *mesh* dimension: ``Shard(d)`` if tensor dim ``d`` is split
over it, else ``Replicate()``.  :func:`to_placements` is that translation,
written once; every function here resolves a spec the reference's way and
translates it, and the tests translate the reference's own specs with it.

A mesh is a ``DeviceMesh``; the functions that only resolve read its
``mesh_dim_names`` and ``shape``.  The port's model holds the stacked
subtrees unstacked (``blocks.<i>.attn.wq``), so a parameter's placements
are its stacked leaf's without the leading ``layers`` axis, which never
shards.
"""
from __future__ import annotations

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models.params import tree_leaves, tree_map

# tensor-parallel rules: logical axis → mesh axis
LOGICAL_RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",       # expert parallelism over the model axis
    "inner": "model",         # SSM inner channels
    "embed": None,
    "state": None,
    "lora": None,
    "layers": None,
    None: None,
}


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= sizes[a]
        return n
    return sizes[name]


def routing_placements(mesh, groups: int) -> list:
    """The placements the MoE's input runs under on ``mesh``, split into
    ``groups`` routing groups along its leading (batch) dim: that dim
    sharded over the batch axes when their ranks each hold whole groups
    (``groups`` a multiple of their size), replicated on every other
    dimension.  DTensor cannot unflatten a dimension sharded unevenly, nor
    reshape one sharded over two dimensions."""
    axes = batch_axes(mesh)
    even = groups % _axis_size(mesh, axes) == 0
    return [Shard(0) if even and n in axes else Replicate()
            for n in mesh.mesh_dim_names]


def to_placements(spec, mesh) -> tuple:
    """A ``PartitionSpec``-like sequence (per tensor dim: None, a mesh axis
    name or a tuple of names) → one placement per mesh dimension:
    ``Shard(d)`` for the dimension split over it, else ``Replicate()``.
    A dim split over several mesh axes (``('pod', 'data')``) is
    ``Shard(d)`` on each, major to minor in mesh order, as in JAX."""
    by_axis = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                by_axis[a] = d
    unknown = set(by_axis) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {tuple(spec)} names {sorted(unknown)}, not "
                         f"dimensions of the mesh {mesh.mesh_dim_names}")
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh.mesh_dim_names)


def resolve_spec(axes: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Logical axes → the reference's PartitionSpec entries (trailing
    ``None`` dropped), with the divisibility fallback."""
    spec = []
    for dim, logical in zip(shape, axes):
        mesh_axis = LOGICAL_RULES.get(logical, None)
        if mesh_axis is not None and dim % _axis_size(mesh, mesh_axis) == 0 \
                and _axis_size(mesh, mesh_axis) > 1:
            spec.append(mesh_axis)
        else:
            spec.append(None)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def resolve_pspec(axes: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Logical axes tuple → placements with divisibility fallback."""
    return to_placements(resolve_spec(axes, shape, mesh), mesh)


def tree_pspecs(defs, mesh):
    """ParamDef tree → placements tree (the reference's stacked leaves)."""
    return tree_map(lambda d: resolve_pspec(d.axes, d.shape, mesh), defs)


def param_placements(model, mesh) -> dict:
    """{parameter name: placements} of a ``Transformer``: each stacked
    leaf's placements on every layer's tensor, the ``layers`` axis (always
    replicated) dropped, so ``Shard(d + 1)`` becomes ``Shard(d)``."""
    from ..models.transformer import model_defs
    out = {}
    for path, d in tree_leaves(model_defs(model.cfg)):
        names = model._names(path)
        axes, shape = d.axes, d.shape
        if names != [path]:
            axes, shape = axes[1:], shape[1:]
        pl = resolve_pspec(axes, shape, mesh)
        out.update((n, pl) for n in names)
    return out


def place(t, mesh, placements) -> DTensor:
    """``t`` (the same values on every rank of ``mesh``) as a DTensor of
    ``placements``: each rank keeps its own block, nothing is sent."""
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def tree_shardings(model, mesh) -> dict:
    """Place a ``Transformer``'s parameters on ``mesh`` in place: each
    becomes a parameter holding a DTensor of :func:`param_placements`
    (every rank must hold the same values first, as a seeded draw or a
    loaded tree gives).  Returns the placements by parameter name."""
    placements = param_placements(model, mesh)
    for name, pl in placements.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        data = p.to_local() if isinstance(p, DTensor) else p.detach()
        mod.register_parameter(leaf, type(p)(place(data, mesh, pl),
                                             requires_grad=p.requires_grad))
    return placements


def data_pspec(mesh, global_batch: int, extra_dims: int = 1) -> tuple:
    """Batch placements: dim 0 over (pod, data) with divisibility
    fallback."""
    return to_placements(_data_spec(mesh, global_batch, extra_dims), mesh)


def _data_spec(mesh, global_batch: int, extra_dims: int) -> tuple:
    axes = batch_axes(mesh)
    n = _axis_size(mesh, axes)
    if axes and global_batch % n == 0:
        return (axes if len(axes) > 1 else axes[0],) + (None,) * extra_dims
    return (None,) * (extra_dims + 1)


def batch_shardings(mesh, batch: dict) -> dict:
    """A batch (every rank holding the whole global batch) → DTensors
    sharded along dim 0 per :func:`data_pspec`."""
    return {k: place(t, mesh, data_pspec(mesh, t.shape[0], t.dim() - 1))
            for k, t in batch.items()}


def cache_pspec(shape: tuple[int, ...], mesh) -> tuple:
    """Decode caches: (layers, batch, seq, heads..) — shard batch over data
    axes and the head/feature axis over 'model' when divisible."""
    if len(shape) == 0:
        return to_placements((), mesh)
    if len(shape) == 1:                       # per-layer scalars
        return to_placements((None,), mesh)
    axes: list = [None] * len(shape)
    baxes = batch_axes(mesh)
    n = _axis_size(mesh, baxes)
    if shape[1] % max(n, 1) == 0 and baxes:
        axes[1] = baxes if len(baxes) > 1 else baxes[0]
    if len(shape) >= 4:
        m = _sizes(mesh).get("model", 1)
        if m > 1 and shape[3] % m == 0:
            axes[3] = "model"
    return to_placements(axes, mesh)


def cache_shardings(mesh, caches: dict) -> dict:
    """Decode caches (``init_caches``) → the same tree with every tensor
    but the host ``pos`` counters a DTensor of :func:`cache_pspec`."""
    def one(name, t):
        if isinstance(t, dict):
            return {k: one(k, v) for k, v in t.items()}
        if name == "pos":
            return t
        return place(t, mesh, cache_pspec(tuple(t.shape), mesh))
    return {k: one(k, v) for k, v in caches.items()}


def replicated(mesh) -> tuple:
    return to_placements((), mesh)

