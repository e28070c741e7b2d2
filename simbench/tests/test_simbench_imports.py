"""The import guard, and what the benchmark's modules load."""
import subprocess
import sys
from pathlib import Path

import pytest

from simbench.harness.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names,want", [
    (["repro_torch", "repro_torch.ops", "reprox", "numpy"], []),
    (["repro", "repro.core"], ["repro", "repro.core"]),
    (["jax", "jax.numpy", "jaxlib", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib"]),
    (["benchmarks.common", "benchmarks_x"], ["benchmarks.common"]),
])
def test_top_level_names_compared_whole(names, want):
    assert forbidden_modules(names) == want


def _loaded(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return out.stdout.split()


def test_the_harness_and_the_port_load_nothing_of_the_jax_side():
    names = _loaded(
        "import sys\n"
        "import simbench.harness.main, simbench.drivers.bbop_stream\n"
        "import simbench.drivers.lm_decode\n"
        "import repro_torch.ops, repro_torch.serve.decode\n"
        "import repro_torch.models.transformer\n"
        "print(*sys.modules)")
    assert "repro_torch" in names
    assert forbidden_modules(names) == []


def test_the_references_load_nothing_of_the_port():
    names = _loaded(
        "import sys\n"
        "import simbench.reference.bbop_numpy, simbench.reference.moe_lm\n"
        "import simbench.reference.dram_meters\n"
        "print(*sys.modules)")
    assert not [n for n in names if n.partition(".")[0] == "repro_torch"]
    assert forbidden_modules(names) == []
