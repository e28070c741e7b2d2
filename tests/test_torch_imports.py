"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor any module of the reference package ``repro`` and
initialises no process group, no source file of the port names either
package in an import, and every module of the reference has its
counterpart, down to each public name."""
import ast
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
import repro_torch.ops as port_ops
from repro_torch.simdram import machine as port_machine

PORT = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        "repro_torch."))


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group at import'\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] "
        "in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(port_modules()) >= 69
    # the serving slice: configs, server, sampler and launcher
    assert {"repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.serve", "repro_torch.serve.batching",
            "repro_torch.serve.server", "repro_torch.serve.decode",
            "repro_torch.launch", "repro_torch.launch.serve"} \
        <= set(port_modules())
    # the LM serving slice: models, tools, reliability and the example
    assert {"repro_torch.models", "repro_torch.models.params",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.tools", "repro_torch.tools.tracelint",
            "repro_torch.simdram.reliability", "repro_torch.examples",
            "repro_torch.examples.serve_decode",
            "repro_torch.device"} <= set(port_modules())
    # the training slice: optimizer, data, step, checkpoint, failover,
    # launcher and example
    assert {"repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.data", "repro_torch.train.train_step",
            "repro_torch.distributed", "repro_torch.distributed.checkpoint",
            "repro_torch.distributed.failover", "repro_torch.launch.train",
            "repro_torch.examples.train_100m"} <= set(port_modules())
    # the distributed and launch slice
    assert {"repro_torch.distributed.compat",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb"} \
        <= set(port_modules())
    # the last slice: the quickstart and serving-traffic examples
    assert {"repro_torch.examples.quickstart",
            "repro_torch.examples.serve_traffic"} <= set(port_modules())


def test_port_sources_import_no_jax_and_no_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert offenders == []


def test_every_sliced_reference_module_has_a_counterpart():
    ref = PORT.parent / "repro"
    for rel in ("core/uprogram.py", "core/graph.py", "core/synthesis.py",
                "core/compiler.py", "core/circuits.py", "core/trace.py",
                "core/tracelint.py", "core/executor.py", "core/backends.py",
                "simdram/timing.py", "simdram/scheduler.py",
                "simdram/layout.py", "simdram/machine.py", "ops/bbops.py",
                "ops/__init__.py", "kernels/uprog_executor.py",
                "kernels/bitplane_transpose.py", "kernels/ops.py",
                "kernels/ref.py", "core/unrolled.py",
                "kernels/bitserial_matmul.py", "configs/__init__.py",
                "configs/base.py", "serve/__init__.py", "serve/batching.py",
                "serve/server.py", "serve/decode.py", "launch/__init__.py",
                "launch/serve.py", "simdram/reliability.py",
                "tools/__init__.py", "tools/tracelint.py",
                "models/__init__.py", "models/params.py",
                "models/layers.py", "models/transformer.py",
                "train/__init__.py", "train/optimizer.py", "train/data.py",
                "train/train_step.py", "distributed/__init__.py",
                "distributed/checkpoint.py", "distributed/failover.py",
                "launch/train.py", "distributed/compat.py",
                "distributed/pipeline.py", "distributed/sharding.py",
                "launch/mesh.py", "launch/dryrun.py", "launch/hillclimb.py"):
        assert (ref / rel).exists(), rel
        assert (PORT / rel).exists(), rel
    # the applications example becomes a module of the port
    assert (PORT.parents[1] / "examples" / "simdram_apps.py").exists()
    assert (PORT / "apps.py").exists()
    # and so does the serving example
    assert (PORT.parents[1] / "examples" / "serve_decode.py").exists()
    assert (PORT / "examples" / "serve_decode.py").exists()
    # and the training, quickstart and serving-traffic examples: every
    # example of the reference has its counterpart
    for path in (PORT.parents[1] / "examples").glob("*.py"):
        assert (PORT / "examples" / path.name).exists() \
            or path.name == "simdram_apps.py", path.name
    # every architecture config is copied
    for path in (ref / "configs").glob("*.py"):
        assert (PORT / "configs" / path.name).exists(), path.name


# reference module → the public names it has and its counterpart
# deliberately lacks, each with its reason
NAME_EXCEPTIONS = {
    "core/unrolled.py": {
        "FULL": "a jnp constant (all-ones uint32 word); the port's int32 "
                "words write -1"},
    "launch/dryrun.py": {
        "ICI_BW": "a TPU interconnect constant, replaced by the H100 "
                  "constants (HBM_BW, LINK_BW)"},
    "kernels/uprog_executor.py": {
        "LANE_BLOCK": "the Pallas kernel's TPU lane tile; the CUDA kernel "
                      "tiles its own way",
        "SUBLANE": "the TPU sublane count of the Pallas kernel's tile"},
    "kernels/bitplane_transpose.py": {
        "LANE_BLOCK": "the Pallas kernel's TPU lane tile; the CUDA kernels "
                      "tile their own way"},
    "models/layers.py": {
        name: f"became the nn.Module {cls}" for name, cls in (
            ("attention", "Attention"), ("mla_attention", "MLAttention"),
            ("mlp", "MLP"), ("moe", "MoE"), ("pum_mlp", "PumMLP"),
            ("ssm_mixer", "SSMMixer"))},
    "models/transformer.py": {
        "forward": "became Transformer.forward (an nn.Module)",
        "attn_block": "became the nn.Module AttnBlock",
        "ssm_block": "became the nn.Module SSMBlock"},
    "simdram/layout.py": {
        "BitplaneArray.tree_flatten": "a JAX pytree hook",
        "BitplaneArray.tree_unflatten": "a JAX pytree hook"},
}


def reference_public_names(path: Path) -> set[str]:
    """The names in ``__all__``, the public top-level functions, classes
    and constants, and each public class's public methods (``Class.name``)
    of a reference source file, read without importing it."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not m.name.startswith("_")}
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if not isinstance(t, ast.Name) or t.id.startswith("_"):
                continue
            if t.id == "__all__":
                names |= set(ast.literal_eval(node.value))
            else:
                names.add(t.id)
    return names


def test_every_reference_name_has_a_counterpart():
    ref = PORT.parent / "repro"
    missing, stale = [], []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        mod = importlib.import_module(
            ".".join(("repro_torch", *Path(rel).with_suffix("").parts))
            .removesuffix(".__init__"))
        exceptions = NAME_EXCEPTIONS.get(rel, {})
        names = reference_public_names(path)
        for name in sorted(names):
            obj = mod
            for part in name.split("."):
                obj = getattr(obj, part, missing)
            if obj is missing and name not in exceptions:
                missing.append(f"{rel}: {name}")
            if obj is not missing and name in exceptions:
                stale.append(f"{rel}: {name}")
        stale += [f"{rel}: {name} (not in the reference)"
                  for name in exceptions if name not in names]
    assert missing == []
    assert stale == []
    assert set(NAME_EXCEPTIONS) <= {p.relative_to(ref).as_posix()
                                    for p in ref.rglob("*.py")}


def test_default_machine_runs_on_cuda_and_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_machine, "_DEFAULT_MACHINE", None)
    m = port_ops.default_machine()          # constructing it needs no card
    assert "cuda" in repr(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ops.bbop_add([1, 2], [3, 4], 8)     # no session: default machine
