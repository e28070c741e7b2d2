"""Sharding placements (``repro_torch.distributed.sharding``) against the
reference's ``PartitionSpec``s (``repro.distributed.sharding``) under one
translation, ``to_placements``: every parameter leaf of every one of the
ten configs, their decode caches and batches, on the meshes (1, 1),
(4, 2), (8, 1), (16, 16) and (2, 16, 16) — the reference's on a device-free
``AbstractMesh``, the port's on a ``DeviceMesh`` over a fake process group
of as many ranks.  Exact.  Also the divisibility fallbacks by name and
the placing of a model's parameters as DTensors.
"""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sh
import repro.models.transformer as ref_tf
import repro_torch.configs as port_configs
import repro_torch.distributed.sharding as port_sh
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import (Transformer, init_cache_shapes,
                                            model_defs)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """{name: (reference AbstractMesh, port DeviceMesh)}; each DeviceMesh
    is built in a fake world of its size (resolving reads only its names
    and shape, which outlive that world)."""
    out = {}
    try:
        for name, (shape, axes) in MESHES.items():
            fake_world(int(torch.tensor(shape).prod()))
            out[name] = (AbstractMesh(shape, axes),
                         make_mesh(shape, axes, "cpu"))
    finally:
        dist.destroy_process_group()
    return out


def ref_leaf(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", port_configs.ARCHS)
def test_parameter_placements_equal_the_reference(meshes, arch, mesh):
    ref_mesh, port_mesh = meshes[mesh]
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    ref_specs = ref_sh.tree_pspecs(ref_tf.model_defs(rcfg), ref_mesh)
    stacked = port_sh.tree_pspecs(model_defs(pcfg), port_mesh)
    model = Transformer(pcfg, device="meta")
    placements = port_sh.param_placements(model, port_mesh)
    assert [p for p, _ in tree_leaves(stacked)] == sorted(
        ".".join(str(k.key) for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(ref_specs)[0])
    names = []
    for path, got in tree_leaves(stacked):
        spec = ref_leaf(ref_specs, path)
        assert got == port_sh.to_placements(spec, port_mesh), path
        per_layer = model._names(path)
        if per_layer != [path]:            # stacked: drop the layers axis
            assert spec == () or spec[0] is None
            spec = tuple(spec)[1:]
        for n in per_layer:
            assert placements[n] == port_sh.to_placements(spec, port_mesh), n
        names += per_layer
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", port_configs.ARCHS)
def test_cache_and_batch_placements_equal_the_reference(meshes, arch, mesh):
    ref_mesh, port_mesh = meshes[mesh]
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    for batch in (32, 3):
        ref = {".".join(str(k.key) for k in p): sds for p, sds in
               jax.tree_util.tree_flatten_with_path(
                   ref_tf.init_cache_shapes(rcfg, batch, 64))[0]}
        got = dict(tree_leaves(init_cache_shapes(pcfg, batch, 64)))
        assert ref.keys() == got.keys()
        for path, sds in ref.items():
            shape = tuple(got[path][0])
            assert tuple(sds.shape) == shape, path
            assert port_sh.cache_pspec(shape, port_mesh) == \
                port_sh.to_placements(ref_sh.cache_pspec(sds, ref_mesh),
                                      port_mesh), (path, batch)
    for gb in (1, 3, 8, 32, 256, 512):
        for extra in (1, 2):
            assert port_sh.data_pspec(port_mesh, gb, extra) == \
                port_sh.to_placements(ref_sh.data_pspec(ref_mesh, gb, extra),
                                      port_mesh), (gb, extra)
    assert port_sh.batch_axes(port_mesh) == ref_sh.batch_axes(ref_mesh)
    assert port_sh.replicated(port_mesh) == (Replicate(),) * len(
        MESHES[mesh][0])


def test_divisibility_fallbacks(meshes):
    """granite's single KV head and qwen2-vl's 12 heads on a 16-way model
    axis replicate; a divisible head count shards."""
    _, m16 = meshes["16x16"]
    granite = Transformer(port_configs.get_config("granite_34b"), "meta")
    pl = port_sh.param_placements(granite, m16)
    assert pl["blocks.0.attn.wk"] == (Replicate(), Replicate())   # 1 KV head
    assert pl["blocks.0.attn.wq"] == (Replicate(), Shard(1))
    qwen2vl = Transformer(port_configs.get_config("qwen2_vl_2b"), "meta")
    pl = port_sh.param_placements(qwen2vl, m16)
    assert pl["blocks.0.attn.wq"] == (Replicate(), Replicate())   # 12 heads
    assert port_sh.resolve_pspec(("vocab", "embed"), (151936, 1024),
                                 m16) == (Replicate(), Shard(0))
    _, m8 = meshes["8x1"]
    assert port_sh.resolve_pspec(("embed", "mlp"), (64, 128), m8) == \
        (Replicate(), Replicate())
    _, pod = meshes["2x16x16"]
    assert port_sh.data_pspec(pod, 64) == (Shard(0), Shard(0), Replicate())


def test_to_placements_refuses_an_unknown_axis(meshes):
    with pytest.raises(ValueError, match="pipe"):
        port_sh.to_placements(("pipe",), meshes["4x2"][1])


def test_tree_shardings_places_every_parameter():
    cfg = port_configs.get_reduced("olmoe_1b_7b")
    fake_world(8)
    try:
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        model = Transformer(cfg, device="meta")
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        placements = port_sh.tree_shardings(model, mesh)
        for name, p in model.named_parameters():
            assert isinstance(p, DTensor) and p.requires_grad
            assert tuple(p.placements) == placements[name]
            assert tuple(p.shape) == shapes[name]
            local = list(shapes[name])
            for dim, pl in enumerate(p.placements):
                if pl.is_shard():
                    local[pl.dim] //= mesh.size(dim)
            assert tuple(p.to_local().shape) == tuple(local), name
    finally:
        dist.destroy_process_group()


def test_manual_group_spans_the_data_axes():
    """``compat.ManualGroup`` over ("pod", "data") flattens them in mesh
    order; ``shard_map_compat`` hands each rank its block of the batch."""
    from repro_torch.distributed.compat import ManualGroup, shard_map_compat
    fake_world(8)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        group = ManualGroup(mesh, {"data", "pod"})
        assert group.names == ("pod", "data")
        assert (group.size, group.rank) == (4, 0)
        with pytest.raises(ValueError, match="pipe"):
            ManualGroup(mesh, ("pipe",))
        step = shard_map_compat(lambda s, b: (s, b), mesh, {"pod", "data"},
                                in_specs=(None, {"tokens": (("pod", "data"),),
                                                 "other": None}))
        tokens = torch.arange(8).reshape(8, 1)
        state, batch = step("state", {"tokens": tokens, "other": tokens})
        assert state == "state" and step.group.size == 4
        assert batch["tokens"].tolist() == [[0], [1]]
        assert batch["other"] is tokens
    finally:
        dist.destroy_process_group()
