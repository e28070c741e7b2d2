"""The port's quickstart and serving-traffic examples against the
reference's ``examples/quickstart.py`` and ``examples/serve_traffic.py``
(loaded by path as fresh modules).

``python -m repro_torch.examples.quickstart --device cpu`` must print the
reference example's stdout line for line: every number, plane and modeled
ns/nJ is the reference's.  Two lines name what differs by design, and are
compared after the substitutions listed in ``RENAMED``: the backend the
reference calls ``pallas`` is the port's ``kernel``, and the port's machine
names its device.  ``serve_traffic``'s ``ServingStats`` snapshot must equal
the reference's exactly.  Without ``--device`` both examples run on
``cuda`` and refuse a missing card.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.examples import quickstart, serve_traffic

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# (reference text, port text) swapped in the reference's lines
RENAMED = (("reference/unrolled/pallas", "reference/unrolled/kernel"),
           ("backend='unrolled', ops=", "backend='unrolled', device='cpu', "
                                        "ops="))


def load_reference(name: str):
    """Run the reference example ``name`` by path as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_reference_examples_lines(capsys):
    load_reference("quickstart").main()
    want = capsys.readouterr().out
    for ref_text, port_text in RENAMED:
        assert want.count(ref_text) == 1, ref_text
        want = want.replace(ref_text, port_text)
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()


def test_serve_traffic_snapshot_equals_the_reference_examples(capsys):
    ref = load_reference("serve_traffic")
    want = capsys.readouterr().out
    assert serve_traffic.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert serve_traffic.serve("cpu").snapshot() == ref.stats.snapshot()


@pytest.mark.parametrize("example", [quickstart, serve_traffic])
def test_examples_run_on_cuda_by_default_and_refuse_a_missing_card(
        monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main([])
