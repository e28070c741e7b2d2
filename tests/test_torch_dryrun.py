"""The dry-run and the hillclimb (``repro_torch.launch.{dryrun,hillclimb}``)
on a fake process group, against the reference's where the two compute
the same thing:

* the cell grid (32 applicable cells) and ``input_specs`` of every cell
  (shapes and dtypes equal the reference's ``ShapeDtypeStruct``s);
* the HLO collective parser, ported verbatim, on the reference test's
  text; ``roofline_terms`` is the reference's arithmetic under the H100
  constants;
* the counting: a reduced train cell on a fake (4, 4) group has FLOPs and
  collective bytes, its FLOPs counted on the local shards; the count is
  linear in depth, so it needs no scan correction; a cell on the
  production mesh reports the reference's fields and allocates nothing;
* the hillclimb's cells and variants equal the reference's, and its
  two-phase exchange moves fewer bytes than the all-gather on 256 ranks.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.distributed as dist

import repro_torch
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import make_mesh

SRC = Path(repro_torch.__file__).resolve().parents[1]


def reference_module(name: str):
    """The reference's dry-run and hillclimb modules set XLA_FLAGS to 512
    host devices when imported; keep this process's flags."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        module = __import__(f"repro.launch.{name}", fromlist=["_"])
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return module


@pytest.fixture
def fake16():
    dryrun.fake_world(16)
    try:
        yield make_mesh((4, 4), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def small(shape_name: str, seq: int = 64, batch: int = 8):
    return dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                               global_batch=batch)


def test_cell_grid_is_complete():
    cells = [(a, s) for a, s in dryrun.iter_cells()
             if shape_applicable(get_config(a), s)]
    assert len(cells) == 10 * 4 - 8 == 32
    ref = reference_module("dryrun")
    assert list(dryrun.iter_cells()) == list(ref.iter_cells())


def test_input_specs_cover_all_model_inputs():
    ref = reference_module("dryrun")
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import SHAPES as REF_SHAPES
    for arch in ARCHS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, name):
                continue
            spec = dryrun.input_specs(cfg, shape)
            want = ref.input_specs(ref_get_config(arch), REF_SHAPES[name])
            assert spec.keys() == want.keys(), (arch, name)
            assert "tokens" in spec
            assert ("encoder_frames" in spec) == cfg.enc_dec
            assert ("mrope_positions" in spec) == (cfg.rope == "mrope")
            for k, t in spec.items():
                assert t.is_meta
                assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


def test_collective_parser_equals_the_reference():
    ref = reference_module("dryrun")
    hlo = '''
      %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={}
      %ag = bf16[512]{0} all-gather(bf16[256]{0} %y), dimensions={0}
      %z = f32[2,2]{1,0} add(f32[2,2]{1,0} %a, f32[2,2]{1,0} %b)
      ROOT %cp = (s32[4]{0}, u8[3,3]{1,0}) collective-permute-start(s32[4]{0} %q)
    '''
    stats = dryrun.collective_bytes(hlo)
    assert stats == ref.collective_bytes(hlo)
    assert stats["bytes"]["all-reduce"] == 128 * 256 * 4
    assert stats["bytes"]["all-gather"] == 512 * 2
    assert stats["counts"]["all-reduce"] == 1
    assert dryrun._shape_bytes("(f32[2,3], pred[5], x9[4])") == \
        ref._shape_bytes("(f32[2,3], pred[5], x9[4])") == 29


def test_roofline_terms_are_the_reference_arithmetic_on_h100(monkeypatch):
    ref = reference_module("dryrun")
    monkeypatch.setattr(ref, "PEAK_FLOPS", dryrun.PEAK_FLOPS)
    monkeypatch.setattr(ref, "HBM_BW", dryrun.HBM_BW)
    monkeypatch.setattr(ref, "ICI_BW", dryrun.LINK_BW)
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import SHAPES as REF_SHAPES
    for arch, shape in (("qwen1.5-0.5b", "train_4k"),
                        ("olmoe-1b-7b", "decode_32k")):
        for stats in ({"flops_per_device": 3e12, "bytes_per_device": 2e10,
                       "collectives": {"total_bytes": 5e8}},
                      {"flops_per_device_corrected": 1e9,
                       "bytes_per_device": 4e12}):
            got = dryrun.roofline_terms(get_config(arch), SHAPES[shape],
                                        stats, 256)
            assert got == ref.roofline_terms(ref_get_config(arch),
                                             REF_SHAPES[shape], stats, 256)


@pytest.mark.parametrize("arch,batch", [("qwen1_5_0_5b", 8),
                                        ("olmoe_1b_7b", 64)])
def test_reduced_train_cell_on_a_fake_4x4_group(fake16, arch, batch):
    """(MoE: 16 routing groups, whole groups on each of 4 data ranks.)"""
    cfg = get_reduced(arch)
    shape = small("train_4k", batch=batch)
    out = dryrun._lower_with(cfg, arch, shape, fake16, "train_4k")
    one = dryrun._lower_with(cfg, arch, shape, None, "train_4k")
    assert out["flops_per_device"] > 0
    assert out["collectives"]["total_bytes"] > 0
    assert out["collectives"]["counts"]["all-reduce"] > 0
    assert one["collectives"]["total_bytes"] == 0
    # counted on each rank's shards: below one device's (DTensor's global
    # shapes would count more), no less than a 16th (replicated work runs
    # on every rank)
    assert one["flops_per_device"] / 16 <= out["flops_per_device"] \
        < one["flops_per_device"]
    mem = out["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] is None


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_the_count_is_linear_in_depth(kind):
    """The layer loop is Python: every layer's ops are counted, so
    count(L) − count(1) = (L − 1) · (count(2) − count(1)) and the
    reference's scan correction has nothing to add."""
    cfg = get_reduced("qwen1_5_0_5b")
    shape = small(kind, seq=32, batch=2)
    counts = {}
    for n in (1, 2, 4):
        c = dataclasses.replace(cfg, n_layers=n)
        s = dryrun._lower_with(c, "q", shape, None, kind)
        counts[n] = (s["flops_per_device"], s["bytes_per_device"])
    for i in (0, 1):
        assert counts[4][i] - counts[1][i] == 3 * (counts[2][i]
                                                  - counts[1][i]) > 0
    d_flops, d_bytes, probe = dryrun._probe_layer_cost(cfg, kind)
    assert probe == 2 and d_flops > 0 and d_bytes > 0
    stats = {"flops_per_device": 5.0, "bytes_per_device": 7.0}
    assert dryrun.scan_corrected(cfg, SHAPES[kind], "q", kind, stats, 256) \
        == {"flops_per_device_corrected": 5.0,
            "bytes_per_device_corrected": 7.0}


def test_lower_cell_on_the_production_mesh_reports_the_fields():
    """Reduced Qwen's decode and prefill, and Mamba2-130m's decode at full
    width (24 SSM heads: the recurrence over a cache placed by the
    reference's rule)."""
    try:
        for arch, shape, cfg in (
                ("qwen1.5-0.5b", "decode_32k", get_reduced("qwen1_5_0_5b")),
                ("qwen1.5-0.5b", "prefill_32k", get_reduced("qwen1_5_0_5b")),
                ("mamba2-130m", "decode_32k", None)):
            r = dryrun.lower_cell(arch, shape, cfg_override=cfg)
            assert r["mesh"] == "16x16" and r["n_devices"] == 256
            for k in ("flops_per_device", "bytes_per_device", "compile_s",
                      "memory", "collectives", "t_compute_s", "t_memory_s",
                      "t_collective_s", "dominant", "model_flops",
                      "useful_flops_ratio", "flops_per_device_corrected"):
                assert k in r, k
            assert r["memory"]["generated_code_bytes"] is None
        r = dryrun.lower_cell("qwen1.5-0.5b", "long_500k")
        assert r["skipped"]
    finally:
        dist.destroy_process_group()


def test_dryrun_main_runs_a_full_width_cell_in_its_own_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--out",
         str(tmp_path / "r.json")], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    (r,) = json.loads((tmp_path / "r.json").read_text())
    assert r["flops_per_device"] > 0 and r["collectives"]["total_bytes"] > 0
    # the parameters (1.86 GB) and the bf16 KV caches (412 GB) are placed,
    # not whole: every large tensor is split 16 or 256 ways
    assert 0 < r["memory"]["argument_bytes"] < (1.86e9 + 412e9) / 128


def test_hillclimb_cells_and_variants_equal_the_reference():
    ref = reference_module("hillclimb")
    assert hillclimb.CELLS == ref.CELLS
    assert hillclimb.VARIANTS == ref.VARIANTS
    for cell, i in hillclimb.UNMEASURED:
        assert "chunked" in hillclimb.VARIANTS[cell][i][0]


def test_two_phase_exchange_moves_fewer_bytes_on_256_ranks():
    """Result bytes, the reference's measure: the packed all-gather's
    result holds R · n/32 words, 8× a float32 all-reduce's at R = 256;
    the two-phase exchange's all-to-all and all-gather hold ~2 · n/32."""
    cfg = get_reduced("qwen1_5_0_5b")
    try:
        gather = hillclimb.lower_compressed_cell(
            "qwen1.5-0.5b", "train_4k", cfg, dp_only=True)
        two = hillclimb.lower_compressed_cell(
            "qwen1.5-0.5b", "train_4k", cfg, dp_only=True, two_phase=True)
        plain = hillclimb.lower_dp_baseline("qwen1.5-0.5b", "train_4k", cfg)
    finally:
        dist.destroy_process_group()
    assert two["collectives"]["counts"]["all-to-all"] == 1
    assert two["collectives"]["total_bytes"] \
        < plain["collectives"]["total_bytes"] \
        < gather["collectives"]["total_bytes"]
    assert gather["flops_per_device"] == two["flops_per_device"] > 0
