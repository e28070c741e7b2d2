"""Multi-pod dry-run: run every (architecture × shape × mesh) cell's step
on meta tensors under a fake process group and count memory / FLOPs /
collectives for the roofline.

The reference (:mod:`repro.launch.dryrun`) lowers and compiles each cell
with XLA on 512 forced host devices and reads XLA's cost analysis and the
optimized HLO.  Torch compiles nothing here; this module runs the step
itself, once, on ``meta`` tensors placed as DTensors on the production
mesh over a ``fake`` process group of 256 or 512 ranks (this process is
rank 0; collectives send nothing, meta tensors hold no storage), and
counts what rank 0 would execute (:class:`StepCounter`):

* **FLOPs a device**: ``torch.utils.flop_counter``'s formulas applied to
  the ops on each rank's *local* shards — the counter lets DTensor lower
  every op to its local ops and collectives first.  (``FlopCounterMode``
  around a DTensor op sees the global shapes: a 16×16 mesh's matmul
  counts 256× its per-device FLOPs.)
* **Collectives**: count and result bytes of every collective the step
  issues, by kind, the reference's ``collective_bytes`` measure, from the
  ``_c10d_functional`` and ``c10d`` ops the step dispatches.
* **Bytes accessed**: the bytes every non-view op reads and writes on the
  local shards — an upper bound without fusion (XLA's count after fusion
  is lower).
* **Memory**: argument bytes from the local shard shapes of the
  parameters, optimizer state, caches and batch; output bytes from the
  step's new results (a training step updates its state in place).  Temp
  and generated-code bytes are ``null``: meta tensors have no allocator
  and nothing is compiled.

MUST create its process group before anything else distributed happens in
the process, so it runs in a process of its own, as the reference's does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k [--multi-pod] [--all] [--out results.json]
"""
from __future__ import annotations

import argparse
import dataclasses as _dc
import functools as _ft
import json
import re
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, get_config
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..distributed.compat import cost_analysis_dict
from ..distributed.sharding import (batch_shardings, cache_shardings,
                                    param_placements, replicated,
                                    tree_shardings)
from ..models.transformer import Transformer, init_caches, model_defs
from ..serve.decode import make_serve_step
from ..train.data import batch_spec
from ..train.optimizer import AdamWConfig, AdamWState
from ..train.train_step import TrainState, init_train_state, make_train_step
from .mesh import make_production_mesh

# H100 SXM constants (roofline), from NVIDIA's H100 data sheet
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12             # HBM3 B/s per GPU
# B/s per GPU for a collective: one InfiniBand NDR 400 Gb/s port per GPU
# (NVIDIA DGX H100 data sheet); a 16×16 mesh spans 32 eight-GPU nodes, so
# its collectives cross them (NVLink 4's 450 GB/s a direction holds
# inside a node only)
LINK_BW = 50e9

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def fake_world(world_size: int) -> None:
    """Make the default process group a ``fake`` one of ``world_size``
    ranks with this process as rank 0 (replacing an existing fake one)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry-run needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input of this cell."""
    b = shape.global_batch
    if shape.kind == "train":
        return batch_spec(cfg, shape)
    if shape.kind == "prefill":
        spec = batch_spec(cfg, shape)
        spec.pop("labels")
        return spec

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    # decode: one new token against a seq_len cache
    spec = {"tokens": meta((b, 1), torch.int32)}
    if cfg.rope == "mrope":
        spec["mrope_positions"] = meta((b, 1, 3), torch.int32)
    if cfg.enc_dec:
        spec["encoder_frames"] = meta((b, cfg.encoder_seq, cfg.d_model),
                                      torch.bfloat16)
    return spec


def abstract_model(cfg: ModelConfig, mesh=None) -> Transformer:
    """The model on ``meta`` in ``cfg.param_dtype``, placed on ``mesh``."""
    model = Transformer(cfg, device="meta")
    if cfg.param_dtype == "bfloat16":
        model.to(torch.bfloat16)
    if mesh is not None:
        tree_shardings(model, mesh)
    return model


def abstract_state(cfg: ModelConfig, mesh=None):
    """(TrainState, defs) on ``meta`` tensors, allocating nothing: the
    parameters in ``cfg.param_dtype`` (placed on ``mesh``), the optimizer
    moments float32 regardless, placed like them."""
    return init_train_state(abstract_model(cfg, mesh)), model_defs(cfg)


def state_shardings(model, mesh):
    """The state's placements: the parameters' and, like them, ``m`` and
    ``v``; the step counter replicated."""
    ps = param_placements(model, mesh)
    return TrainState(params=ps,
                      opt=AdamWState(step=replicated(mesh), m=ps, v=ps),
                      error_fb=None)


# ---------------------------------------------------------------------------
# HLO collective parsing (the reference's measure, kept for its text form)
# ---------------------------------------------------------------------------

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s8": 1,
                "u8": 1, "pred": 1, "f64": 8, "s64": 8, "u64": 8, "f8e4m3": 1,
                "f8e5m2": 1, "s16": 2, "u16": 2}


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes moved by collectives: sum of result-shape bytes of
    every collective instruction in an HLO module's text."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    n = {op: 0 for op in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = re.match(r"(?:ROOT )?[%\w.-]+ = (.*?) (\S+)\(", stripped)
        if not m:
            continue
        result_shape, opname = m.groups()
        for op in COLLECTIVE_OPS:
            if opname.startswith(op):
                out[op] += _shape_bytes(result_shape)
                n[op] += 1
    return {"bytes": out, "counts": n,
            "total_bytes": sum(out.values())}


# ---------------------------------------------------------------------------
# Counting a step as it runs
# ---------------------------------------------------------------------------

# (op-name fragment, kind), for the ops of the ``_c10d_functional`` and
# ``c10d`` namespaces
_COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_NOT_MOVED = {"_unsafe_view", "empty", "empty_like", "empty_strided",
              "new_empty", "new_empty_strided", "detach", "lift_fresh",
              "_local_scalar_dense"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d"):
        return None
    name = func._overloadpacket.__name__
    for frag, kind in _COLLECTIVE_KINDS:
        if frag in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and collectives of what this rank
    executes.  An op on DTensors is handed back (``NotImplemented``) so
    DTensor lowers it first: the counter then sees the local ops on each
    rank's shards and the collectives the placements imply, as
    ``CommDebugMode`` does."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = {op: 0 for op in COLLECTIVE_OPS}
        self.coll_counts = {op: 0 for op in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            # c10d's in-place ops take their outputs first; the functional
            # ones return them
            res = args[0] if func.namespace == "c10d" else out
            self.coll_bytes[kind] += _nbytes(res)
            self.coll_counts[kind] += 1
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or packet.__name__ in _NOT_MOVED):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out

    def stats(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {"bytes": dict(self.coll_bytes),
                                "counts": dict(self.coll_counts),
                                "total_bytes": sum(self.coll_bytes.values())}}


def count_step(run) -> tuple:
    """``run()``'s result and the :class:`StepCounter` statistics of it."""
    counter = StepCounter()
    with counter:
        out = run()
    return out, counter.stats()


def _local_bytes(tree) -> int:
    """Bytes of each rank's blocks of the tensors (and DTensors) of a
    state, model, batch or cache tree."""
    from ..distributed.checkpoint import state_leaves
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in state_leaves(tree).values())


# ---------------------------------------------------------------------------
# Scan-trip-count correction probe
# ---------------------------------------------------------------------------
# XLA's cost analysis counts a while-loop (lax.scan) body ONCE regardless of
# trip count, so the reference probes the per-layer cost with 1- and
# 2-layer stacks and adds it for the other layers.  The port's layer loop is
# Python: the counter sees every layer's ops, so the stats need no
# correction.  The probe is kept — it measures the per-layer cost, which
# the tests hold linear in depth — and the correction returns the stats
# unchanged.

@_ft.lru_cache(maxsize=None)
def _probe_layer_cost(cfg: ModelConfig,
                      shape_name: str) -> tuple[float, float, int]:
    """(flops, bytes) added per extra layer (global, probe-batch, one
    device), and the probe batch size."""
    shape = SHAPES[shape_name]
    probe_batch = 2
    pshape = _dc.replace(shape, global_batch=probe_batch)
    base = 6 if cfg.family == "hybrid" else 1   # keep the shared-attn cadence
    costs = {}
    for mult in (1, 2):
        n = base * mult
        kw = dict(n_layers=n, scan_layers=False)
        if cfg.layer_pattern:
            kw["layer_pattern"] = ("ssm",) * n
        if cfg.enc_dec:
            kw["n_encoder_layers"] = n
        pcfg = _dc.replace(cfg, **kw)
        stats = _lower_with(pcfg, cfg.name, pshape, None, shape_name)
        costs[mult] = (stats["flops_per_device"], stats["bytes_per_device"])
    d_flops = (costs[2][0] - costs[1][0]) / base
    d_bytes = (costs[2][1] - costs[1][1]) / base
    return d_flops, d_bytes, probe_batch


def scan_corrected(cfg: ModelConfig, shape: ShapeConfig, arch: str,
                   shape_name: str, stats: dict, n_dev: int) -> dict:
    """The reference's corrected fields, equal to the counted ones: the
    port's count already holds every layer (module comment above)."""
    return {
        "flops_per_device_corrected": stats["flops_per_device"],
        "bytes_per_device_corrected": stats["bytes_per_device"],
    }


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------

def _lower_with(cfg, arch: str, shape, mesh, shape_name: str) -> dict:
    """Run one step of the cell on meta tensors placed on ``mesh`` (None:
    one device) and count it.  Shared by real cells and probes."""
    from .train import sharded_step
    specs = input_specs(cfg, shape)

    def place_batch(batch):
        return batch if mesh is None else batch_shardings(mesh, batch)

    if shape.kind == "train":
        state, _ = abstract_state(cfg, mesh)
        args = _local_bytes(state) + _local_bytes(place_batch(specs))
        step = make_train_step(cfg, AdamWConfig(), loss_chunk=cfg.loss_chunk)
        if mesh is not None:
            step = sharded_step(step, mesh)
        out, stats = count_step(lambda: step(state, specs)[1])
    else:
        model = abstract_model(cfg, mesh)
        batch = place_batch(specs)
        args = _local_bytes(model) + _local_bytes(batch)
        if shape.kind == "prefill":
            def run():
                return model(batch)[0]
        else:
            caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
            if mesh is not None:
                caches = cache_shardings(mesh, caches)
            args += _local_bytes(caches)
            step = make_serve_step(cfg)

            def run():
                return step(model, caches, batch)[0]
        with torch.no_grad(), implicit_replication():
            out, stats = count_step(run)
    out_bytes = _nbytes([t.to_local() if isinstance(t, DTensor) else t
                         for t in _tensors(out)])
    ca = cost_analysis_dict(stats)
    return {"flops_per_device": ca["flops"],
            "bytes_per_device": ca["bytes accessed"],
            "collectives": stats["collectives"],
            "memory": {"argument_bytes": args, "output_bytes": out_bytes,
                       "temp_bytes": None, "generated_code_bytes": None}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               compile_: bool = True, cfg_override=None):
    """Count one (arch × shape × mesh) cell; returns stats.  Makes the
    fake world the mesh needs (256 or 512 ranks).  ``compile_=False``
    builds the inputs only; ``compile_s`` is the counted run's seconds
    (nothing compiles)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long-context needs sub-quadratic mixer "
                          "(full-attention arch; see DESIGN.md)"}
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    stats = {"arch": arch, "shape": shape_name,
             "mesh": "2x16x16" if multi_pod else "16x16",
             "n_devices": mesh.size(), "skipped": False}
    if not compile_:
        input_specs(cfg, shape)
        stats["lower_s"] = round(time.time() - t0, 1)
        return stats
    low = _lower_with(cfg, arch, shape, mesh, shape_name)
    stats["flops_per_device"] = low["flops_per_device"]
    stats["bytes_per_device"] = low["bytes_per_device"]
    stats["compile_s"] = round(time.time() - t0, 1)
    stats["memory"] = low["memory"]
    stats["collectives"] = low["collectives"]
    if cfg.scan_layers:
        stats.update(scan_corrected(cfg, shape, arch, shape_name, stats,
                                    mesh.size()))
    stats.update(roofline_terms(cfg, shape, stats, mesh.size()))
    return stats


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, stats: dict,
                   n_dev: int) -> dict:
    flops = (stats.get("flops_per_device_corrected")
             or stats.get("flops_per_device") or 0.0)
    byts = (stats.get("bytes_per_device_corrected")
            or stats.get("bytes_per_device") or 0.0)
    coll = stats.get("collectives", {}).get("total_bytes", 0)
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    tokens = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    n_active = cfg.active_param_count()
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    hlo_total = flops * n_dev
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / hlo_total) if hlo_total else None,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def iter_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args(argv)
    fake_world(512 if args.multi_pod else 256)

    cells = (list(iter_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if (args.both_meshes or args.multi_pod is False
                               and args.all) else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                r = lower_cell(arch, shape, multi_pod=mp,
                               compile_=not args.no_compile)
            except Exception as e:  # noqa: BLE001 — cell result records error
                r = {"arch": arch, "shape": shape,
                     "mesh": "2x16x16" if mp else "16x16",
                     "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            print(json.dumps(r), flush=True)
            if not r.get("skipped") and "error" not in r:
                print(f"  [{r['arch']} × {r['shape']} × {r['mesh']}] "
                      f"counted={r.get('compile_s')}s "
                      f"dominant={r.get('dominant')}", file=sys.stderr)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if "error" in r]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
