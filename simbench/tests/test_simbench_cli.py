"""The command line: no result without a card or without the program."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "simdram16.ops16-w32", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "simbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, "simbench/run.py", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
