"""Each cell's control, put in the program's place by ``run_cell``, comes
out not correct, and the sound program does not.

The control is the reference at the nearest precision below the one the
configuration states: for ``simdram16`` the operations computed one bit
narrower, for ``olmoe-1b-7b`` (bf16 compute) the reference's weight
products in float8 e4m3.  These runs are at a small size on the CPU,
through ``tools/readings.py`` as on the card.  The bbop cell keeps its
own limits (exact); the LM's limits are set at the cell's size, where the
readings behind them were taken on the card, so the small model is held
to limits set the same way from its own readings.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from readings import readings  # noqa: E402

from simbench.harness import spec  # noqa: E402

SEEDS = (101, 102, 103)
BBOP_CELL = "simdram16.ops16-w32"
LM_CELL = "olmoe-1b-7b.decode-host"
SMALL_LM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
            "head_dim": 16, "d_ff": 64, "vocab": 256, "n_experts": 8,
            "experts_per_tok": 2, "d_expert": 32}
SMALL_REQUESTS = [[16, 6], [32, 4], [48, 8], [16, 3]]
# the small model's readings (these seeds): sound mean ≤ 0.00017 σ, widest
# ≤ 0.015 σ; control mean ≥ 0.0037 σ; one altered token widest ≥ 2.7 σ
SMALL_LIMITS = {"mean_gap_sigma": 0.0015, "widest_gap_sigma": 1.0}


def _cell(workload):
    return spec.find_cell(spec.load_benchmark(), workload)[1:]


def _bbop(control: bool):
    config, traffic = _cell(BBOP_CELL)
    return readings(BBOP_CELL, SEEDS, "cpu", 0.2, control,
                    config=dict(config, banks=2, lanes=256), traffic=traffic)


def _lm(control: bool, fault=None):
    config, traffic = _cell(LM_CELL)
    return readings(LM_CELL, SEEDS, "cpu", 0.1, control, fault,
                    config=dict(config, **SMALL_LM),
                    traffic=dict(traffic, requests=SMALL_REQUESTS,
                                 trace_steps=2, checks=SMALL_LIMITS))


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_bbop_control_fails_and_the_program_passes(control):
    for row in _bbop(control):
        assert row["correct"] is not control, row


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_lm_control_fails_and_the_program_passes(control):
    for row in _lm(control):
        assert row["correct"] is not control, row
        if control:
            assert not row["checks"]["mean_gap_sigma"]["value"] <= \
                SMALL_LIMITS["mean_gap_sigma"], row


def test_lm_one_altered_token_fails_the_widest_gap():
    for row in _lm(False, "one_token"):
        assert not row["correct"], row
        widest = row["checks"]["widest_gap_sigma"]
        assert widest["value"] > widest["limit"], row
