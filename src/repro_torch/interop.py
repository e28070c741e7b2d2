"""Pass state between the port and numpy (and through numpy to the
reference package): a :class:`BitplaneArray` is its uint32 plane words plus
``(n_bits, length, signed)``; a model is its parameter tree."""
from __future__ import annotations

import numpy as np
import torch

from .simdram.layout import BitplaneArray


def bitplanes_from_numpy(planes_u32: np.ndarray, n_bits: int, length: int,
                         signed: bool = False,
                         device: str | torch.device = "cuda") -> BitplaneArray:
    """uint32 planes (``[n_bits, W]`` or ``[banks, n_bits, W]``) → the port's
    :class:`BitplaneArray` on ``device`` (int32 words, same bits)."""
    p = np.ascontiguousarray(planes_u32, dtype=np.uint32).view(np.int32)
    return BitplaneArray(torch.from_numpy(p.copy()).to(device), n_bits,
                         length, signed)


def bitplanes_to_numpy(arr: BitplaneArray) -> tuple[np.ndarray, int, int, bool]:
    """Inverse of :func:`bitplanes_from_numpy`: ``(planes_u32, n_bits,
    length, signed)``."""
    planes = arr.planes.detach().cpu().contiguous().numpy().view(np.uint32)
    return planes.copy(), arr.n_bits, arr.length, arr.signed


def params_from_reference(cfg, tree, device: str | torch.device = "cuda"):
    """The reference's parameter tree as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) → a
    :class:`~repro_torch.models.transformer.Transformer` on ``device`` that
    holds the same values, for every family: the stacked ``blocks`` (with
    the enc-dec decoder's ``xattn`` and MoE's ``ffn.shared``),
    ``ssm_blocks`` and ``enc_blocks`` unstacked along the layer axis, the
    hybrid's weight-tied ``shared_attn`` kept as one block, no ``lm_head``
    where the embeddings are tied."""
    from .models.params import tree_map
    from .models.transformer import Transformer
    tensors = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return Transformer(cfg, device=device).load_params(tensors)


def params_to_reference(model, named: dict | None = None) -> dict:
    """Inverse of :func:`params_from_reference`: ``named`` (parameter name →
    tensor, for example the gradients of a step; the model's own
    parameters when None) → the reference's tree of numpy arrays, the
    per-layer tensors stacked again along the layer axis."""
    from .models.params import tree_leaves
    from .models.transformer import STACKED, model_defs
    if named is None:
        named = dict(model.named_parameters())
    out: dict = {}
    for path, _ in tree_leaves(model_defs(model.cfg)):
        names = model._names(path)
        ts = [named[n].detach().cpu() for n in names]
        arr = (torch.stack(ts) if path.partition(".")[0] in STACKED
               else ts[0]).numpy()
        node = out
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return out
