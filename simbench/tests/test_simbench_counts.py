"""The benchmark's work counts against hand-worked cases."""
import numpy as np
import pytest

from simbench.counts import peaks
from simbench.counts.decode_flops import (active_params, head_flops,
                                          request_flops, token_flops)
from simbench.counts.uprog import (bound_s, fsm_ops_per_word, k1_work,
                                   k2_work, op_bounds)
from simbench.harness import lm_weights, spec

# MAJ (1, 2, 3); MAJ writing a complement; COPY plain; COPY inverting
CMDS = np.array([[1, 1, 2, 3], [1, -1, 2, 3], [0, 4, 5, 0], [0, 4, -5, 0]],
                dtype=np.int32)


def test_fsm_ops_per_word_hand_stream():
    # 1 + (1 + 1 NOT) + 0 + 1 NOT
    assert fsm_ops_per_word(CMDS) == 4


def test_k1_work_counts_row_file_once_each_way():
    ops, nbytes = k1_work(CMDS, n_rows=6, elements=64)
    assert ops == 4 * 2                       # two words of 32 lanes
    assert nbytes == 2 * 6 * 2 * 4 + CMDS.size * 4


def test_k2_work_values_and_planes():
    assert k2_work(8, 1024) == (8 * 1024, 1024 * 4 + 8 * 1024 // 8)
    assert k2_work(1, 32) == (32, 32 * 4 + 4)


def test_peaks_derive_the_int32_rate():
    p = peaks()
    assert p["int32_ops_per_s"] == pytest.approx(132 * 64 * 1980e6)
    assert p["int32_ops_per_s"] == pytest.approx(16.73e12, rel=1e-3)


def test_bound_is_the_larger_of_bytes_and_operations():
    p = {"hbm_bytes_per_s": 10.0, "int32_ops_per_s": 100.0}
    assert bound_s(50, 20, p) == 2.0
    assert bound_s(500, 20, p) == 5.0


def test_op_bounds_sum_the_passes():
    p = {"hbm_bytes_per_s": 1e9, "int32_ops_per_s": 1e12}
    b = op_bounds(CMDS, 6, [8, 8], 1, 1024, p)
    k1_ops, k1_bytes = k1_work(CMDS, 6, 1024)
    assert b["k1"] == bound_s(k1_ops, k1_bytes, p)
    assert b["k2"] == pytest.approx(sum(bound_s(*k2_work(n, 1024), p)
                                        for n in (8, 8, 1)))
    assert b["op"] == bound_s(k1_ops, 3 * 1024 * 4, p)


TINY = {"n_layers": 2, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
        "vocab": 10, "n_experts": 4, "experts_per_tok": 2, "d_expert": 3}


def test_token_flops_by_hand():
    # head_dim 2: projections 2·4·2·(2·2 + 2·1) = 96; router 2·4·4 = 32;
    # experts 2·3·2·4·3 = 144; attention over 5 keys 4·2·2·5 = 80
    assert token_flops(TINY, 5) == 2 * (96 + 32 + 144 + 80)
    assert head_flops(TINY) == 80


def test_request_flops_by_hand():
    want = 3 * (token_flops(TINY, 1) + token_flops(TINY, 2)
                + token_flops(TINY, 3) + 2 * head_flops(TINY))
    assert request_flops(TINY, batch=3, prompt=2, new_tokens=2) == want


def test_olmoe_counts_match_the_published_sizes():
    cfg = spec.load_json(spec.config_path("olmoe-1b-7b"))
    assert lm_weights.n_params(cfg) == 6_919_096_320
    assert active_params(cfg) == 1_178_861_568
    # 2·N_active a token plus attention: within 1 % at a short context
    assert token_flops(cfg, 1) + head_flops(cfg) == pytest.approx(
        2 * active_params(cfg), rel=0.01)
