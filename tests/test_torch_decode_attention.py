"""One-token GQA attention over a KV cache (``kernels.decode_attention``)
and its dispatch from the models layer's attention core (``layers._sdpa``).

On the CPU: ``_sdpa`` on CPU tensors is bit for bit the plain path
(``_sdpa_naive``), one query included; the kernel's plain version equals
``_sdpa_naive`` at one query with a host and with a device-tensor offset;
the plan (warps, splits) covers every query and fits the kernel's limits;
a model of the kernel's split-and-combine arithmetic (float64, one float32
partial a warp's share of the keys, empty shares included) equals plain
attention; the wrapper's checks refuse what the kernel does not take; and
the counters of one-token calls.

On the card (``gpu``): the kernel against its plain version at both decode
cells' shapes and small ones, with garbage past the length; that limit
failing two planted faults at both cells' shapes; the device length
changed between replays of one CUDA graph; the refusals; greedy decoding
through the graph against the eager decode.

Tolerance.  The kernel takes the scores, the softmax and the weighted sum
in float32 from the bf16 inputs and rounds once, at the output.  Against
the plain version on the same bf16 values upcast to float32 it differs by
that rounding, at most half a bf16 ulp, 2^-8 × |out|, and by float32
summation order (~1e-6 of |out|): the limit is twice the rounding, 2^-7 ×
max|want|.  On unit-normal inputs that is ~1e-3 at decode-host's shape
and ~5e-4 at Nemotron's (outputs of std ~sqrt(e/T)), against measured
errors of 3.6e-4 and 1.2e-4; a softmax scale 10 % off moves the outputs
by ~10 %, and one of Nemotron's 66 partials dropped by ~1/66 of them.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain, plan)
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import Transformer
from repro_torch.serve.decode import greedy_decode

TOL = 2.0 ** -7             # × max|want|: twice the output's bf16 rounding
GARBAGE = 1e4               # written past the length: never read


def qkv(b, t, kv, g, hd, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    q = torch.randn(b, 1, kv * g, hd, generator=gen, device=device)
    k = torch.randn(b, t, kv, hd, generator=gen, device=device)
    v = torch.randn(b, t, kv, hd, generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,offset", [(1, 0), (1, 9), (1, "device"),
                                      (4, 3), (4, "device")])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_on_cpu_tensors_is_the_plain_path(dtype, s, offset, causal):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, s, 8, 16, generator=gen).to(dtype)
    k, v = (torch.randn(2, 14, 2, 16, generator=gen).to(dtype)
            for _ in range(2))
    off = torch.tensor([6]) if offset == "device" else offset
    assert torch.equal(layers._sdpa(q, k, v, causal, off),
                       layers._sdpa_naive(q, k, v, causal, off))


@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("offset", [0, 5, 12, "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_is_the_plain_path_at_one_query(g, offset, dtype):
    q, k, v = qkv(3, 13, 2, g, 32, dtype, seed=g)
    off = torch.tensor([7]) if offset == "device" else offset
    for causal in (True, False):
        want = layers._sdpa_naive(q, k, v, causal, off)
        assert torch.equal(decode_attention_plain(q, k, v, causal, off), want)
        # a CPU call of the wrapper is its plain version
        assert torch.equal(decode_attention(q, k, v, causal, off), want)


def test_the_plan_at_the_decode_cells_shapes():
    # olmoe-1b-7b.decode-host: 16 sequences x 16 KV heads of one query
    p = plan(16, 16, 1, 3138, 128, 132)
    assert (p.lanes_per_key, p.q_slices, p.k_slices, p.q_per_warp,
            p.q_groups, p.splits, p.n_parts) == (16, 1, 4, 1, 1, 5, 20)
    # nemotron-3-nano-30b-a3b: 8 sequences x 2 KV heads of 16 queries
    p = plan(8, 2, 16, 14433, 128, 132)
    assert (p.lanes_per_key, p.q_slices, p.k_slices, p.q_per_warp,
            p.q_groups, p.splits, p.n_parts) == (16, 4, 1, 4, 1, 66, 66)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 12, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("hd", [8, 16, 64, 96, 112, 128, 160, 256])
def test_the_plan_covers_every_query_within_the_kernels_limits(g, hd):
    for b, kv, t in ((1, 1, 1), (2, 4, 40), (16, 16, 3138), (8, 2, 14433)):
        p = plan(b, kv, g, t, hd, 132)
        assert p.q_slices * p.k_slices == da.WARPS
        assert p.q_per_warp in (1, 2, 4, 8)
        assert p.q_slices * p.q_groups * p.q_per_warp >= g
        assert hd <= 8 * p.lanes_per_key <= 32 * 8
        assert p.lanes_per_key & (p.lanes_per_key - 1) == 0
        assert 1 <= p.splits <= max(1, -(-t // (da.MIN_KEYS_PER_WARP
                                                * p.k_slices)))


def kernel_model(q, k, v, length: int, p) -> np.ndarray:
    """The kernel's arithmetic in float64: each of a head's ``p.n_parts``
    warps takes its ceil(length / n_parts) share of the keys and leaves
    (m, l, acc) in the log2 domain, m = -inf for an empty share; the
    combine merges them under their common max."""
    q, k, v = (np.asarray(x, dtype=np.float64) for x in (q, k, v))
    b, _, h, hd = q.shape
    g = h // k.shape[2]
    share = -(-length // p.n_parts)
    scale = 1.0 / math.sqrt(hd) * math.log2(math.e)
    out = np.zeros((b, 1, h, hd))
    for bi in range(b):
        for hi in range(h):
            kk, vv = k[bi, :, hi // g], v[bi, :, hi // g]
            parts = []
            for w in range(p.n_parts):
                lo, hi_ = w * share, min(length, (w + 1) * share)
                if lo >= hi_:
                    parts.append((-math.inf, 0.0, np.zeros(hd)))
                    continue
                s = kk[lo:hi_] @ q[bi, 0, hi] * scale
                m = s.max()
                e = np.exp2(s - m)
                parts.append((m, e.sum(), e @ vv[lo:hi_]))
            mx = max(m for m, _, _ in parts)
            w = [0.0 if m == -math.inf else 2.0 ** (m - mx)
                 for m, _, _ in parts]
            l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
            acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
            out[bi, 0, hi] = acc / l
    return out


@pytest.mark.parametrize("b,t,kv,g,hd,length", [
    (2, 40, 2, 1, 16, 40), (2, 40, 2, 1, 16, 3), (1, 300, 1, 4, 32, 257),
    (2, 64, 2, 2, 8, 1), (1, 500, 2, 16, 16, 499)])
def test_the_split_and_combine_arithmetic_is_attention(b, t, kv, g, hd,
                                                        length):
    q, k, v = qkv(b, t, kv, g, hd, seed=length)
    p = plan(b, kv, g, t, hd, 132)
    got = kernel_model(q, k, v, length, p)
    # plain attention over the first ``length`` keys, in float64
    kk = k.double()[:, :length].repeat_interleave(g, 2)
    vv = v.double()[:, :length].repeat_interleave(g, 2)
    w = torch.softmax(torch.einsum("bhd,bthd->bht", q.double()[:, 0], kk)
                      / math.sqrt(hd), -1)
    want = torch.einsum("bht,bthd->bhd", w, vv)[:, None]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bad,error", [
    ("float32", TypeError), ("float16", TypeError), ("head dim", ValueError),
    ("hd 12", ValueError), ("heads", ValueError), ("two queries", ValueError),
    ("position dtype", ValueError), ("q grad", RuntimeError),
    ("cache grad", RuntimeError)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    q, k, v = qkv(2, 16, 2, 2, 16, torch.bfloat16)
    off = 3
    if bad == "float32":
        k = k.float()
    elif bad == "float16":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "q grad":
        q.requires_grad_()
    elif bad == "cache grad":
        v.requires_grad_()
    elif bad == "head dim":                  # every other element of 32
        k = torch.randn(2, 16, 2, 32).to(torch.bfloat16)[..., ::2]
    elif bad == "hd 12":
        q, k, v = qkv(2, 16, 2, 2, 12, torch.bfloat16)
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "two queries":
        q = torch.cat([q, q], 1)
    else:
        off = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(error):
        da._check(q, k, v, off)


def test_without_grad_the_checks_take_inputs_that_require_grad():
    # a model's q and caches under torch.no_grad(), as decoding calls it
    q, k, v = (x.requires_grad_() for x in qkv(2, 16, 2, 2, 16,
                                                 torch.bfloat16))
    with torch.no_grad():
        da._check(q, k, v, 3)
    with pytest.raises(RuntimeError):
        da._check(q, k, v, 3)


def test_the_checks_take_a_cache_layers_view():
    # layer i of stacked (L, B, T, KV, hd) caches, as the model passes it
    q, _, _ = qkv(2, 16, 2, 2, 16, torch.bfloat16)
    caches = torch.zeros(3, 2, 16, 2, 16, dtype=torch.bfloat16)
    da._check(q, caches[1], caches[2], torch.tensor([5]))


def test_one_token_calls_are_counted():
    q, k, v = qkv(2, 10, 2, 2, 16)
    telemetry.reset("models.attn.one_token", "kernels.decode_attn")
    layers._sdpa(q, k, v, True, 4)
    layers._sdpa(torch.cat([q, q], 1), k, v, True, 4)
    layers._sdpa(q, k, v, False)
    assert telemetry.counter("models.attn.one_token") == 2
    assert telemetry.counter("kernels.decode_attn") == 0   # the CPU: plain


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def limit(want) -> float:
    return TOL * float(want.abs().max())


def want32(q, k, v, causal, q_offset):
    """The plain version on the bf16 values upcast to float32."""
    return decode_attention_plain(q.float(), k.float(), v.float(), causal,
                                  q_offset)


CARD_SHAPES = [  # (B, T, KV, g, hd): both decode cells', then small ones
    (16, 3138, 16, 1, 128), (8, 14433, 2, 16, 128), (3, 700, 4, 1, 64),
    (3, 700, 4, 2, 64), (3, 700, 2, 4, 64), (2, 96, 1, 48, 160)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_the_kernel_equals_its_plain_version(shape, causal):
    dev = cuda_or_skip()
    b, t, kv, g, hd = shape
    q, k, v = qkv(b, t, kv, g, hd, torch.bfloat16, dev, seed=t + g)
    # longest first: each shorter length writes garbage past itself
    lengths = (t, t // 3, 1) if causal else (t,)
    for length in lengths:
        if length < t:                   # the kernel must not read these
            k[:, length:] = GARBAGE
            v[:, length:] = GARBAGE
        before = decode_attention.launches
        got = decode_attention(q, k, v, causal, length - 1)
        assert decode_attention.launches == before + 1
        want = want32(q, k, v, causal, length - 1)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert max_err(got, want) <= limit(want), length


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES[:2], ids=str)
def test_the_limit_fails_a_planted_fault(shape):
    """Two faults the limit must see, at both decode cells' shapes: a
    softmax scale 10 % off (the kernel run on 1.1 × q) and one warp's
    partial dropped by the combine (the plain version without that
    partial's keys, which such a kernel would return)."""
    dev = cuda_or_skip()
    b, t, kv, g, hd = shape
    q, k, v = qkv(b, t, kv, g, hd, torch.bfloat16, dev, seed=t + g)
    want = want32(q, k, v, True, t - 1)
    assert max_err(decode_attention(q, k, v, True, t - 1), want) \
        <= limit(want)
    scaled = decode_attention((q.float() * 1.1).to(q.dtype), k, v, True,
                              t - 1)
    assert max_err(scaled, want) > 2 * limit(want)
    p = plan(b, kv, g, t, hd,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    share = -(-t // p.n_parts)
    lo = p.n_parts // 2 * share                  # a middle warp's keys
    keep = torch.cat([torch.arange(lo), torch.arange(lo + share, t)]).to(dev)
    dropped = want32(q, k[:, keep], v[:, keep], True, len(keep) - 1)
    assert max_err(dropped, want) > 2 * limit(want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 3138, 16, 1, 128),
                                   (8, 2000, 2, 16, 128)], ids=str)
def test_one_graph_serves_every_device_length(shape):
    dev = cuda_or_skip()
    b, t, kv, g, hd = shape
    q, k, v = qkv(b, t, kv, g, hd, torch.bfloat16, dev, seed=5)
    pos = torch.zeros(1, dtype=torch.long, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        decode_attention(q, k, v, True, pos)             # warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = decode_attention(q, k, v, True, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    for p in (0, 1, 37, t // 2, t - 1):
        pos.fill_(p)
        graph.replay()
        eager = decode_attention(q, k, v, True, p)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), p
        want = want32(q, k, v, True, p)
        assert max_err(out, want) <= limit(want), p


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["float32", "head dim", "grad"])
def test_the_kernel_refuses_a_float32_cache_and_a_strided_head_dim(bad):
    dev = cuda_or_skip()
    q, k, v = qkv(2, 64, 2, 2, 64, torch.bfloat16, dev)
    if bad == "float32":
        k, v = k.float(), v.float()
        error = TypeError
    elif bad == "head dim":
        k = torch.randn(2, 64, 2, 128, device=dev).to(torch.bfloat16)[..., ::2]
        error = ValueError
    else:                 # under grad: its output would carry no gradient
        q.requires_grad_()
        error = RuntimeError
    before = decode_attention.launches
    with pytest.raises(error):
        decode_attention(q, k, v, True, 10)
    assert decode_attention.launches == before


def small_model(arch: str, dev) -> Transformer:
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype="bfloat16")
    return Transformer(cfg, dev).draw_params(
        torch.Generator(dev).manual_seed(31))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "nemotron-3-nano-30b-a3b"])
def test_greedy_decode_by_graph_equals_the_eager_decode(arch, monkeypatch):
    dev = cuda_or_skip()
    m = small_model(arch, dev)
    prompt = torch.randint(0, 256, (4, 20), device=dev,
                           generator=torch.Generator(dev).manual_seed(7))
    steps = 12
    telemetry.reset("models.attn.one_token", "kernels.decode_attn",
                    "models.graph.replays")
    got = greedy_decode(m, m.cfg, prompt, steps=steps)
    one = telemetry.counter("models.attn.one_token")
    assert telemetry.counter("models.graph.replays") == steps - 2
    assert one > 0 and telemetry.counter("kernels.decode_attn") == one
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)   # eager
    before = decode_attention.launches
    want = greedy_decode(m, m.cfg, prompt, steps=steps)
    assert decode_attention.launches > before
    assert torch.equal(got, want)
