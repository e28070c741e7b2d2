"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor any module of the reference package ``repro``, and no
source file of the port names either in an import."""
import ast
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
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] "
        "in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(port_modules()) >= 19


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
                "kernels/ref.py"):
        assert (ref / rel).exists(), rel
        assert (PORT / rel).exists(), rel


def test_default_machine_runs_on_cuda_and_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_machine, "_DEFAULT_MACHINE", None)
    m = port_ops.default_machine()          # constructing it needs no card
    assert "cuda" in repr(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.device
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ops.bbop_add([1, 2], [3, 4], 8)     # no session: default machine
