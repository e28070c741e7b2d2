"""A run with the timed path broken underneath comes out not correct.

Each test skips only the harness's look for a card: it drives the rest of
a run (set-up, window, check) on the CPU at a small size through
``run_cell``, with one fault planted in the port, and reads ``correct``.
The bbop cell keeps its own limits; the LM is held to limits set from the
small model's readings (``test_simbench_control.py``).
"""
import time

import pytest
import torch

from simbench.harness import faults, spec
from simbench.harness.main import run_cell
from test_simbench_control import (BBOP_CELL, LM_CELL, SMALL_LIMITS,
                                   SMALL_LM, SMALL_REQUESTS)

BENCH = spec.load_benchmark()


def bbop_run(seed: int = 5) -> dict:
    _, config, traffic = spec.find_cell(BENCH, BBOP_CELL)
    return run_cell(BENCH, BBOP_CELL, seed, 0.2, False, "cpu",
                    time.perf_counter(), dict(config, banks=2, lanes=256),
                    traffic)


def lm_run(seed: int = 9) -> dict:
    _, config, traffic = spec.find_cell(BENCH, LM_CELL)
    return run_cell(BENCH, LM_CELL, seed, 0.1, False, "cpu",
                    time.perf_counter(), dict(config, **SMALL_LM),
                    dict(traffic, requests=SMALL_REQUESTS, trace_steps=2,
                         checks=SMALL_LIMITS))


def test_sound_small_runs_are_correct():
    assert bbop_run()["correct"]
    assert lm_run()["correct"]


def _wrap(monkeypatch, module, name, after):
    inner = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: after(inner(*a, **kw), a))


def test_bbop_answer_altered(monkeypatch):
    from repro_torch.ops import bbops

    def flip(out, _):
        out = out.clone()
        out.view(-1)[7] ^= 1
        return out
    _wrap(monkeypatch, bbops, "bbop_add", flip)
    r = bbop_run()
    assert not r["correct"] and r["checks"]["mismatched_values"]["value"] > 0


def test_bbop_half_the_banks_left_out(monkeypatch):
    from repro_torch.ops import bbops

    def half(out, _):
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out
    _wrap(monkeypatch, bbops, "bbop_mul", half)
    assert not bbop_run()["correct"]


def test_bbop_state_returned_unchanged(monkeypatch):
    from repro_torch.ops import bbops
    _wrap(monkeypatch, bbops, "bbop_sub",
          lambda out, args: torch.as_tensor(args[0]).clone())
    assert not bbop_run()["correct"]


def test_bbop_cost_left_uncharged(monkeypatch):
    """Every value right, but the division's modeled DRAM cost never
    reaches the machine's meters."""
    from repro_torch.core.backends import PerfStats
    inner = PerfStats.charge_program

    def charge(self, prog, *a, **kw):
        if prog.name != "division":
            inner(self, prog, *a, **kw)
    monkeypatch.setattr(PerfStats, "charge_program", charge)
    r = bbop_run()
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] == 0
    assert r["checks"]["exec_ns_off"]["value"] > 0


def _patch_logits(monkeypatch, fn):
    from repro_torch.models.transformer import Transformer
    inner = Transformer.forward

    def forward(self, batch, caches=None, **kw):
        logits, aux, new = inner(self, batch, caches, **kw)
        return fn(logits), aux, new
    monkeypatch.setattr(Transformer, "forward", forward)


def test_lm_token_altered_where_produced(monkeypatch):
    def boost(logits):
        logits = logits.clone()
        logits[0, -1, 3] += 1e3
        return logits
    _patch_logits(monkeypatch, boost)
    assert not lm_run()["correct"]


def test_lm_one_token_of_one_step_altered():
    with faults.one_token(max(n for _, n in SMALL_REQUESTS)):
        r = lm_run()
    assert not r["correct"]
    assert r["checks"]["widest_gap_sigma"]["value"] > SMALL_LIMITS[
        "widest_gap_sigma"]


def test_lm_half_the_batch_left_out(monkeypatch):
    def half(logits):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits
    _patch_logits(monkeypatch, half)
    assert not lm_run()["correct"]


def test_lm_cache_left_unchanged(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_write", lambda cache, update, pos: cache)
    assert not lm_run()["correct"]
