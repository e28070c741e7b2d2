"""Sharded, asynchronous, atomic, *elastic* checkpointing of a training
state.

The reference's protocol (:mod:`repro.distributed.checkpoint`) on torch
tensors and DTensors:

* each leaf is saved as one or more ``.npy`` chunk files along its first
  axis, with a JSON manifest recording the leaves' global shapes and
  dtypes, the chunk counts, the step and the dimension names of the mesh
  it was saved under (``[]`` without one);
* a save gathers every DTensor leaf to its full value (``full_tensor()``,
  a collective: every rank of the mesh calls ``save``), copies every
  tensor to host memory synchronously (the next in-place training step may
  then change the live tensors), and rank 0 of the default process group
  (the only process without one) writes on a background thread,
  atomically (into a unique ``.tmp`` directory, then a rename), so a crash
  mid-save never corrupts the latest checkpoint; older checkpoints beyond
  ``max_to_keep`` are removed.  A blocking save ends in a barrier, so every
  rank may read the checkpoint once it returns;
* restore is **elastic**: the full arrays are re-placed under the *target*
  mesh's placements — each DTensor leaf of ``like`` takes its own block,
  and ``shardings`` may place plain leaves — so a checkpoint saved on one
  mesh restores onto another;
* ``latest_step`` + ``restore`` give crash-recovery semantics for the
  failover runner.

A state is a tree of dataclasses (``TrainState``, ``AdamWState``), dicts,
``nn.Module``s (their named parameters) and tensors; ``None`` leaves are
skipped.  Leaf keys join the path with ``__``, e.g. ``params__embed``,
``opt__step``, ``opt__m__blocks.0.attn.wq``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

_SEP = "__"


def state_leaves(tree, prefix: str = "") -> dict:
    """{key: tensor} of every tensor leaf of ``tree`` (the checkpoint's
    leaf keys)."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} "
                        f"at {prefix!r}")
    out = {}
    for name, sub in items:
        out.update(state_leaves(sub, f"{prefix}{_SEP}{name}" if prefix
                            else str(name)))
    return out


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 chunk_bytes: int = 1 << 28) -> None:
        self.dir = directory
        self.max_to_keep = max_to_keep
        self.chunk_bytes = chunk_bytes
        self._pool = ThreadPoolExecutor(max_workers=4)
        self._pending: list = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state, mesh=None, blocking: bool = False):
        """Snapshot to host memory synchronously (a copy, never a view of a
        CPU tensor; DTensors gathered whole), write asynchronously on rank
        0.  Returns the write's future (already done on other ranks)."""
        host = {k: _full(t).detach().to("cpu", copy=True).numpy()
                for k, t in state_leaves(state).items()}
        if _rank() == 0:
            fut = self._pool.submit(
                self._write, step, host,
                list(mesh.mesh_dim_names) if mesh is not None else [])
            self._pending.append(fut)
        else:
            fut = Future()
            fut.set_result(None)
        if blocking:
            fut.result()
            if dist.is_initialized() and dist.get_world_size() > 1:
                dist.barrier()
        return fut

    def _write(self, step: int, host: dict, mesh_axes: list) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        # unique tmp dir per writer: concurrent saves of the same step (e.g.
        # a periodic save racing the final blocking save) must not clobber
        # each other's in-progress files
        tmp = final + f".tmp{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "mesh_axes": mesh_axes, "leaves": {}}
        for key, arr in host.items():
            chunks = self._chunk(arr)
            manifest["leaves"][key] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "n_chunks": len(chunks),
            }
            for i, c in enumerate(chunks):
                np.save(os.path.join(tmp, f"{key}.{i}.npy"), c)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _chunk(self, arr: np.ndarray) -> list[np.ndarray]:
        if arr.ndim == 0 or arr.nbytes <= self.chunk_bytes:
            return [arr]
        n = max(1, min(arr.shape[0], arr.nbytes // self.chunk_bytes))
        return np.array_split(arr, n, axis=0)

    def wait(self) -> None:
        """Wait for every pending write (raising a write's error)."""
        for f in self._pending:
            f.result()
        self._pending.clear()

    def close(self) -> None:
        """Wait for the pending writes and stop the writer threads."""
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like, shardings: dict | None = None):
        """Restore checkpoint ``step`` into ``like`` and return it.  Each
        leaf is written in place (a full-width state is not held twice): a
        DTensor leaf takes its own block of the saved array under its own
        mesh and placements.  ``shardings`` (``{leaf key: (mesh,
        placements)}``) re-places the leaves it names instead: each becomes
        a new DTensor of the saved values (a parameter stays a
        parameter).  A leaf absent at save time keeps its value; a leaf
        whose saved shape or dtype differs raises ``ValueError``, as does a
        ``meta`` leaf (it has no storage to restore into)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = state_leaves(like)
        shardings = shardings or {}
        with torch.no_grad():
            for key, meta in manifest["leaves"].items():
                if key not in leaves:
                    continue
                parts = [np.load(os.path.join(path, f"{key}.{i}.npy"))
                         for i in range(meta["n_chunks"])]
                arr = (parts[0] if len(parts) == 1
                       else np.concatenate(parts, 0)).reshape(meta["shape"])
                dst = leaves[key]
                src = torch.from_numpy(arr)
                if dst.is_meta or src.shape != dst.shape \
                        or src.dtype != dst.dtype:
                    raise ValueError(
                        f"checkpoint leaf {key!r} is {src.dtype}"
                        f"{list(src.shape)}; cannot restore it into "
                        f"{dst.dtype}{list(dst.shape)} on {dst.device}")
                if key in shardings:
                    mesh, placements = shardings[key]
                    _set_leaf(like, key.split(_SEP), distribute_tensor(
                        src.to(mesh.device_type), mesh, list(placements),
                        src_data_rank=None))
                elif isinstance(dst, DTensor):
                    dst.to_local().copy_(distribute_tensor(
                        src, dst.device_mesh, dst.placements,
                        src_data_rank=None).to_local())
                else:
                    dst.copy_(src)
        return like


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _set_leaf(tree, parts: list[str], value) -> None:
    """Replace the leaf at checkpoint key ``parts`` of ``tree``."""
    head, rest = parts[0], parts[1:]
    if isinstance(tree, nn.Module):
        owner, _, leaf = head.rpartition(".")
        mod = tree.get_submodule(owner) if owner else tree
        old = getattr(mod, leaf)
        mod.register_parameter(leaf, nn.Parameter(
            value, requires_grad=old.requires_grad))
    elif dataclasses.is_dataclass(tree):
        if rest:
            _set_leaf(getattr(tree, head), rest, value)
        else:
            setattr(tree, head, value)
    elif rest:
        _set_leaf(tree[head], rest, value)
    else:
        tree[head] = value
