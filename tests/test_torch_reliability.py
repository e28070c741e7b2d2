"""Reliability Monte-Carlo and the TraceLint CLI: ``repro_torch.simdram.
reliability`` and ``repro_torch.tools.tracelint`` held against ``repro``'s.

Both are numpy and Python only, so every observation must be equal, with
tolerance 0: the failure rates come from the same seeded draws, and the
sweep compiles the same traces with each package's own compiler.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.simdram.reliability as ref_rel
import repro.tools.tracelint as ref_lint
import repro_torch.simdram.reliability as port_rel
import repro_torch.tools.tracelint as port_lint

SRC = Path(port_rel.__file__).resolve().parents[2]


def test_nodes_and_constants_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in port_rel.NODES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_rel.NODES.items()}
    assert (port_rel.VDD, port_rel.SA_VAR_SLOPE) \
        == (ref_rel.VDD, ref_rel.SA_VAR_SLOPE)


@pytest.mark.parametrize("seed", [0, 7])
def test_reliability_table_equals_reference(seed):
    got = port_rel.reliability_table(iters=400, seed=seed)
    assert got == ref_rel.reliability_table(iters=400, seed=seed)
    assert got["22nm"][0.0]["QRA"] == "error"


@pytest.mark.parametrize("node,k,var,b2b", [
    ("45nm", 3, 0.2, False), ("32nm", 5, 0.1, False),
    ("22nm", 3, 0.05, True), ("22nm", 5, 0.2, True)])
def test_simulate_multi_row_activation_equals_reference(node, k, var, b2b):
    kw = dict(iters=1500, back_to_back=b2b, seed=11)
    got = port_rel.simulate_multi_row_activation(port_rel.NODES[node], k,
                                                 var, **kw)
    assert got == ref_rel.simulate_multi_row_activation(ref_rel.NODES[node],
                                                        k, var, **kw)


# -- tests/test_substrate.py's reliability cases, on the port ----------------

def test_tra_reliable_at_low_variation():
    """Paper Table 3: TRA has zero failures at ≤5% variation, all nodes."""
    for node in port_rel.NODES.values():
        assert port_rel.simulate_multi_row_activation(node, 3, 0.05,
                                                      4000) == 0.0


def test_qra_worse_than_tra():
    node = port_rel.NODES["32nm"]
    tra = port_rel.simulate_multi_row_activation(node, 3, 0.20, 4000)
    qra = port_rel.simulate_multi_row_activation(node, 5, 0.20, 4000)
    assert qra > tra


def test_qra_collapses_at_22nm():
    assert port_rel.qra_margin_collapsed(port_rel.NODES["22nm"])
    assert not port_rel.qra_margin_collapsed(port_rel.NODES["45nm"])


def test_failure_rate_grows_with_scaling():
    rates = [port_rel.simulate_multi_row_activation(port_rel.NODES[n], 3,
                                                    0.20, 6000)
             for n in ("45nm", "32nm", "22nm")]
    assert rates[0] <= rates[1] <= rates[2] + 0.01


# -- the TraceLint CLI ----------------------------------------------------------

def untimed(text: str) -> list[str]:
    return [re.sub(r"checked in [0-9.]+s", "checked in ?s", line)
            for line in text.splitlines()]


@pytest.mark.parametrize("argv,rc", [
    (["--optimize", "both", "--chains"], 0),
    # bitcount at 5 bits exhausts the row allocator in both packages
    # (AllocationError: no spill victim available, ROADMAP C.2)
    (["--ops", "bitcount", "--bits", "5"], 1),
    # ... only with MIG optimization on: the Ambit lowering compiles
    (["--ops", "addition,bitcount", "--bits", "5,8", "--optimize", "off",
      "-v"], 0),
    (["--ops", "addition,bitcount", "--bits", "5,8", "--optimize", "both",
      "-v"], 1)])
def test_tracelint_cli_equals_reference(argv, rc, capsys):
    assert ref_lint.main(argv) == rc
    want = untimed(capsys.readouterr().out)
    assert port_lint.main(argv) == rc
    assert untimed(capsys.readouterr().out) == want
    if rc:
        assert any("compile error: no spill victim available" in line
                   for line in want)


def test_tracelint_sweep_counts_equal_reference(capsys):
    ops, bits = ("addition", "bitcount", "relu"), (5, 8)
    assert port_lint.sweep(ops, bits, (True,)) \
        == ref_lint.sweep(ops, bits, (True,)) == 1
    assert port_lint.sweep_chains((4,), (True, False)) \
        == ref_lint.sweep_chains((4,), (True, False)) == 0
    capsys.readouterr()


def test_tracelint_runs_as_a_module_and_names_the_port():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.tracelint", "--ops",
         "addition", "--bits", "8", "-v"], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0].startswith("ok    addition/8b")
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.tracelint", "--ops",
         "nope"], env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2
    assert "python -m repro_torch.tools.tracelint" in bad.stderr
