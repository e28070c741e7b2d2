"""The applications slice: ``repro_torch.apps`` on the CPU against the
reference's ``examples/simdram_apps.py``, at the example's sizes and on the
example's seed.

Brightness on a 16×16 image, a BitWeaving scan over 4,096 values, the
128×256 · 256×128 XNOR layer and the masked darken through the
user-defined ``gated_sub`` must give the reference's results exactly, and
the machine's μProgram Memory counters must equal the reference machine's.
The port runs on its ``unrolled`` backend (as the example does), on its
default ``kernel`` backend and across banks.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import apps as port_apps
from repro_torch.core import backends as TB

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "simdram_apps.py"


def run_apps(mod) -> dict:
    """The example's flow on either package's four functions; returns every
    result.  ``mod`` has brightness/bitweaving_scan/xnor_layer/
    masked_darken."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 16))
    vals = rng.integers(0, 256, 4096)
    x = rng.choice([-1.0, 1.0], (128, 256)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], (128, 256)).astype(np.float32)
    return {
        "brightness": np.asarray(mod.brightness(img, 64)),
        "scan": mod.bitweaving_scan(vals, 50, 180),
        "xnor": np.asarray(mod.xnor_layer(x, w)),
        "darken": np.asarray(mod.masked_darken(img, img > 128, 40)),
        "expected": {
            "brightness": np.minimum(img + 64, 255),
            "scan": int(((vals >= 50) & (vals <= 180)).sum()),
            "xnor": (x @ w.T).astype(np.int32),
            "darken": np.where(img > 128, (img - 40) & 255, img)},
    }


@pytest.fixture(scope="module")
def reference():
    """The reference example, loaded by path as a fresh module (its machine
    is built at import), run once."""
    spec = importlib.util.spec_from_file_location("_ref_simdram_apps", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = run_apps(mod)
    out["cache_stats"] = mod.MACHINE.cache_stats()
    return out


@pytest.mark.parametrize("backend,banks", [("unrolled", 1), ("unrolled", 4),
                                           (None, 1), ("reference", 2)])
def test_apps_match_reference_example(reference, backend, banks):
    apps = port_apps.make_apps("cpu", banks=banks, backend=backend)
    got = run_apps(apps)
    for key, want in reference["expected"].items():
        np.testing.assert_array_equal(reference[key], want, err_msg=key)
        np.testing.assert_array_equal(got[key], reference[key], err_msg=key)
        assert np.shape(got[key]) == np.shape(reference[key]), key
    assert apps.machine.cache_stats() == reference["cache_stats"]


def test_passes_cut_inputs_across_banks(reference):
    """Several ``[banks, lanes]`` passes with a padded tail: the padding
    never leaks into a result or the scan's count."""
    apps = port_apps.make_apps("cpu", banks=3, lanes=100)
    assert [tuple(p.shape) for p in apps._passes(np.arange(700))] == \
        [(3, 100)] * 3
    got = run_apps(apps)
    for key in ("brightness", "scan", "darken"):
        np.testing.assert_array_equal(got[key], reference[key], err_msg=key)
    # 16×16 image in passes of 300: one pass; 4,096 values: 14 passes
    assert apps.machine.cache_stats()["misses"] == \
        reference["cache_stats"]["misses"]


def test_backends_and_devices():
    apps = port_apps.make_apps("cpu")
    assert apps.machine.backend == "unrolled" and "unrolled" in TB.list_backends()
    assert apps.machine.device == torch.device("cpu")
    assert port_apps.make_apps("cpu", backend=None).machine.backend is None
    assert "gated_sub" in apps.machine.ops()


def test_no_machine_at_import_and_cuda_by_default(monkeypatch):
    assert not [v for v in vars(port_apps).values()
                if isinstance(v, (port_apps.SimdramMachine,
                                  port_apps.SimdramApps))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_apps.make_apps()


def test_main_runs_on_the_cpu(capsys):
    assert port_apps.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK") == 4
    assert "5 entries" in out
