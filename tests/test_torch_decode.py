"""The LM serving path: ``repro_torch.serve.decode``'s ``make_prefill``,
``make_serve_step`` and ``greedy_decode`` held against
``repro.serve.decode`` on the CPU, with the reference's parameters carried
across by ``params_from_reference``.

Compute is float32 here, so both packages' logits agree to ~1e-6 relative
and every greedy id must be equal (tolerance 0 on ids).  With
``sampler="simdram"`` the tokens come from the bank-batched tournament on a
``device="cpu"`` machine (the plain versions of the kernels), and the
sampler's ``PerfStats`` snapshot must equal the reference's exactly: every
modeled ns and nJ comes from identical code.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.params as ref_params
import repro.models.transformer as ref_tf
import repro.ops as ref_ops
import repro.serve.decode as ref_decode
import repro_torch.configs as port_configs
import repro_torch.models.transformer as port_tf
import repro_torch.ops as port_ops
import repro_torch.serve.decode as port_decode
from repro_torch.interop import params_from_reference

SRC = Path(port_decode.__file__).resolve().parents[2]
F32_REL = 1e-4      # logits: ≤ 1e-4 × max|reference logit|


def setup(arch: str, seed: int = 1, **over):
    over.setdefault("compute_dtype", "float32")
    rcfg = dataclasses.replace(ref_configs.get_reduced(arch), **over)
    pcfg = dataclasses.replace(port_configs.get_reduced(arch), **over)
    params = ref_params.init_params(ref_tf.model_defs(rcfg),
                                    jax.random.key(seed))
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                  "cpu")
    return rcfg, params, pcfg, model


def prompt(cfg, b: int, s: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_vl_2b",
                                  "stablelm_12b"])
def test_greedy_decode_host_matches_reference(arch):
    rcfg, params, pcfg, model = setup(arch)
    p = prompt(rcfg, 2, 8)
    want = np.asarray(ref_decode.greedy_decode(params, rcfg, jnp.asarray(p),
                                               steps=6))
    got = port_decode.greedy_decode(model, pcfg, torch.from_numpy(p).long(),
                                    steps=6)
    assert got.shape == (2, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_decode_simdram_matches_reference():
    rcfg, params, pcfg, model = setup("qwen1_5_0_5b")
    p = prompt(rcfg, 2, 6, seed=4)
    ref_st, st = ref_ops.PerfStats(), port_ops.PerfStats()
    want = np.asarray(ref_decode.greedy_decode(
        params, rcfg, jnp.asarray(p), steps=3, sampler="simdram",
        sampler_perf=ref_st))
    machine = port_ops.SimdramMachine(device="cpu", banks=2)
    got = port_decode.greedy_decode(
        model, pcfg, torch.from_numpy(p).long(), steps=3, sampler="simdram",
        sampler_perf=st, machine=machine)
    np.testing.assert_array_equal(got.numpy(), want)
    # 256-token vocabulary: 3 halving rounds + 5 SWAR strides, each a
    # (greater + 2 if_else) triple, and 3 transposition passes a token
    assert st.n_programs == 3 * 24 and st.n_transposes == 3 * 3
    assert st.snapshot() == ref_st.snapshot()


FAMILY_CASES = [("olmoe_1b_7b", True), ("deepseek_v2_236b", True),
                ("mamba2_130m", True), ("zamba2_7b", True),
                ("whisper_large_v3", True), ("whisper_large_v3", False)]


def encoder_frames(cfg, b: int, seed: int = 6) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("arch,frames", FAMILY_CASES)
def test_greedy_decode_host_matches_reference_for_every_family(arch, frames):
    """The MoE, MLA, SSM, hybrid and enc-dec families through
    ``greedy_decode``: the prompt prefilled through the zeroed bf16 caches
    (for the SSM layers, the reference's one-token recurrence broadcast
    over the prompt, ROADMAP C), then one-token steps.  Whisper's caches
    are primed from ``extra_batch``'s encoder frames, or stay zero without
    them, as in the reference."""
    rcfg, params, pcfg, model = setup(arch)
    p = prompt(rcfg, 2, 8)
    ref_extra, port_extra = None, None
    if frames:
        fr = encoder_frames(rcfg, 2) if rcfg.enc_dec else None
        if fr is not None:
            ref_extra = {"encoder_frames": jnp.asarray(fr)}
            port_extra = {"encoder_frames": torch.from_numpy(fr)}
    want = np.asarray(ref_decode.greedy_decode(
        params, rcfg, jnp.asarray(p), steps=6, extra_batch=ref_extra))
    got = port_decode.greedy_decode(model, pcfg, torch.from_numpy(p).long(),
                                    steps=6, extra_batch=port_extra)
    assert got.shape == (2, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_decode_simdram_moe_matches_reference():
    """OLMoE (reduced) with the in-DRAM sampler: ids and the sampler's
    ``PerfStats`` snapshot equal the reference's exactly."""
    rcfg, params, pcfg, model = setup("olmoe_1b_7b")
    p = prompt(rcfg, 2, 6, seed=4)
    ref_st, st = ref_ops.PerfStats(), port_ops.PerfStats()
    want = np.asarray(ref_decode.greedy_decode(
        params, rcfg, jnp.asarray(p), steps=3, sampler="simdram",
        sampler_perf=ref_st))
    machine = port_ops.SimdramMachine(device="cpu", banks=2)
    got = port_decode.greedy_decode(
        model, pcfg, torch.from_numpy(p).long(), steps=3, sampler="simdram",
        sampler_perf=st, machine=machine)
    np.testing.assert_array_equal(got.numpy(), want)
    assert st.n_programs == 3 * 24 and st.n_transposes == 3 * 3
    assert st.snapshot() == ref_st.snapshot()


def test_prefill_and_serve_step_match_reference():
    rcfg, params, pcfg, model = setup("qwen1_5_0_5b")
    b, s, t = 2, 7, 12
    p = prompt(rcfg, b, s, seed=5)
    rc = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                      ref_tf.init_cache_shapes(rcfg, b, t))
    want, rc = ref_decode.make_prefill(rcfg)(params,
                                             {"tokens": jnp.asarray(p)}, rc)
    caches = port_tf.init_caches(pcfg, b, t, device="cpu")
    got, caches = port_decode.make_prefill(pcfg)(
        model, {"tokens": torch.from_numpy(p).long()}, caches)
    assert got.shape == (b, 1, pcfg.vocab)
    tol = F32_REL * float(jnp.max(jnp.abs(want)))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= tol
    nxt = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    want2, rc = ref_decode.make_serve_step(rcfg)(
        params, rc, {"tokens": jnp.asarray(nxt)})
    got2, caches = port_decode.make_serve_step(pcfg)(
        model, caches, {"tokens": torch.from_numpy(nxt).long()})
    tol = F32_REL * float(jnp.max(jnp.abs(want2)))
    assert float(np.abs(got2.numpy() - np.asarray(want2)).max()) <= tol
    assert int(caches["pos"]) == int(rc["pos"]) == s + 1


def test_greedy_decode_refuses_a_bad_sampler_and_a_missing_card(monkeypatch):
    _, _, pcfg, model = setup("qwen1_5_0_5b")
    p = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="sampler"):
        port_decode.greedy_decode(model, pcfg, p, steps=2, sampler="nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        # the default machine lives on "cuda"
        port_decode.greedy_decode(model, pcfg, p, steps=2,
                                  sampler="simdram")


def test_decode_refuses_a_config_other_than_the_models():
    _, _, pcfg, model = setup("qwen1_5_0_5b")
    other = dataclasses.replace(pcfg, rope="mrope")
    p = torch.zeros((1, 4), dtype=torch.int64)
    caches = port_tf.init_caches(pcfg, 1, 6, device="cpu")
    with pytest.raises(ValueError, match="config"):
        port_decode.greedy_decode(model, other, p, steps=2)
    with pytest.raises(ValueError, match="config"):
        port_decode.make_prefill(other)(model, {"tokens": p}, caches)
    with pytest.raises(ValueError, match="config"):
        port_decode.make_serve_step(other)(model, caches,
                                           {"tokens": p[:, :1]})
    # an equal configuration built apart is the same configuration
    same = dataclasses.replace(pcfg)
    assert port_decode.greedy_decode(model, same, p, steps=2).shape == (1, 2)


def test_serve_decode_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "device=cpu" in lines[0]
    assert "decode OK (greedy, KV-cached)" in lines
    assert lines[-1].startswith("PuM sampler OK: modeled ")
    assert "24 μPrograms/token, banks=4" in lines[-1]
