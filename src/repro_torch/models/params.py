"""Parameter definition framework: one source of truth for shapes, logical
sharding axes and initialization, so that ``init_params`` and the modules
of :mod:`repro_torch.models` never drift apart.

A definition tree is a nested ``dict`` whose leaves are :class:`ParamDef`;
``init_params`` turns it into the same tree of tensors.  Model code only
names logical axes (mapped to mesh axes by
:mod:`repro_torch.distributed.sharding`):

  embed     d_model dims                (replicated)
  vocab     vocabulary                  → 'model'
  heads     attention-head dims         → 'model'
  kv_heads  kv-head dims                → 'model' (replicates if indivisible)
  mlp       FFN hidden                  → 'model'
  experts   MoE expert dim              → 'model'  (expert parallelism)
  inner     SSM inner channels          → 'model'
  state     SSM state dim               (replicated)
  lora      low-rank bottlenecks        (replicated)
  layers    stacked layer dim           (replicated)
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list:
    """``(dotted path, leaf)`` pairs of a nested dict, keys sorted at every
    level (the reference's pytree order)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layer dim to every ParamDef."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                                       d.init, d.scale), defs)


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda"):
    """Tree of tensors on ``device``: ``normal × scale``, zeros or ones per
    leaf, drawn from ``generator`` (which must live on ``device``'s type)
    leaf by leaf in sorted-key order.  The draws differ from the
    reference's ``jax.random`` ones; carry its parameters across with
    :func:`repro_torch.interop.params_from_reference` instead."""
    device = resolve_device(device)
    out: dict = {}
    for path, d in tree_leaves(defs):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            t = torch.randn(d.shape, generator=generator, dtype=dtype,
                            device=device) * d.scale
        node = out
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def abstract_params(defs, dtype: torch.dtype = torch.float32):
    """Tree of ``device="meta"`` tensors of each leaf's shape: the
    reference's ``ShapeDtypeStruct`` tree (the dry-run path), allocating
    nothing."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def logical_specs(defs):
    """Tree of logical-axis tuples, mirroring the params tree."""
    return tree_map(lambda d: d.axes, defs)


def param_bytes(defs, bytes_per: int = 4) -> int:
    return sum(math.prod(d.shape) * bytes_per for _, d in tree_leaves(defs))
