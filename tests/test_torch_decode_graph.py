"""The one-token decode step a CUDA graph records (``DecodeGraph``, which
records ``Transformer._forward``).  On the CPU: the forward at a
device-side position against the forward at the host position, every
position to the cache's last slot; where the graph
engages (``Transformer.in_graph`` through the forward, the card's test
``transformer._cuda`` stood in for); the counters a replay adds; the
overflow check; the drop of a graph by a forward on other caches; and
a replay refilling the weight copies of parameters changed in place
before it launches.  On the card (``gpu``): greedy decoding through the
graph against the eager decode, its captures and replays, no
synchronisation in a replay, a second request dropping the first
request's graph, and the weight copies: cast once, outside the graph's
pool, and refilled for a replay after a parameter changed.

Tolerances are the port's prefill/decode rules: 1e-4 × max|logit| in
float32 and 5e-2 in bf16 (at a device position MLA attends over the whole
cache with the keys past the position masked, so only zero weights and
the reduction length differ from the host position's step).
"""
import dataclasses
import weakref

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_reduced
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import DecodeGraph, Transformer, init_caches
from repro_torch.serve.decode import greedy_decode

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STEPS = [("deepseek-v2-lite", "float32"), ("deepseek-v2-lite", "bfloat16"),
         ("olmoe-1b-7b", "bfloat16"), ("qwen1.5-0.5b", "bfloat16")]


def model_of(arch: str, dtype: str = "bfloat16", device="cpu", seed: int = 29,
             **fields) -> Transformer:
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype=dtype,
                              **fields)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, param_dtype="float32")
    return Transformer(cfg, device).draw_params(
        torch.Generator(device).manual_seed(seed))


def tokens(b: int, t: int, device="cpu", seed: int = 7):
    return torch.randint(0, 256, (b, t), device=device,
                         generator=torch.Generator(device).manual_seed(seed))


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("arch,dtype", STEPS)
def test_the_step_at_a_device_position_equals_the_eager_step(arch, dtype):
    m = model_of(arch, dtype)
    cfg = m.cfg
    t, prompt = 14, 9
    tok = tokens(2, t)
    eager, graphed = (init_caches(cfg, 2, t, dtype=layers._dt(cfg),
                                  device="cpu") for _ in range(2))
    with torch.no_grad():
        _, _, eager = m({"tokens": tok[:, :prompt]}, eager)
        _, _, graphed = m({"tokens": tok[:, :prompt]}, graphed)
        for p in range(prompt, t):           # up to the cache's last slot
            want, _, eager = m({"tokens": tok[:, p:p + 1]}, eager)
            # the position a graph records with (a CPU tensor stands in)
            got, _, new = m({"tokens": tok[:, p:p + 1]},
                            dict(graphed, pos=torch.tensor([p])))
            assert got.shape == want.shape == (2, 1, cfg.vocab)
            assert rel_err(got, want) <= TOL[dtype], p
            assert torch.equal(new["layers"]["pos"], eager["layers"]["pos"])
            graphed = dict(new, pos=eager["pos"])
    for k, c in eager["layers"].items():
        if k != "pos":
            assert rel_err(graphed["layers"][k], c) <= TOL[dtype], k


class Taken(Exception):
    """Raised by the stand-in capture: the forward took the graph's path."""


def _forward_takes(monkeypatch, m, batch, caches, card=True, grad=False):
    """Whether ``m``'s forward of ``batch`` on ``caches`` goes to the graph
    (``DecodeGraph.capture``), with ``card`` standing in for a CUDA
    device; an eager forward must return logits."""
    monkeypatch.setattr(transformer, "_cuda", lambda t: card)

    def capture(*a, **kw):
        raise Taken
    monkeypatch.setattr(DecodeGraph, "capture", capture)
    try:
        with torch.set_grad_enabled(grad):
            logits = m(batch, caches)[0]
    except Taken:
        return True
    assert logits.shape[:2] == batch["tokens"].shape
    return False


def _prefilled(m, b: int = 2, t: int = 12, prompt: int = 6):
    caches = init_caches(m.cfg, b, t, device="cpu")
    with torch.no_grad():
        caches = m({"tokens": tokens(b, prompt)}, caches)[2]
    return caches


ALLOWED = ["deepseek-v2-lite", "olmoe-1b-7b", "qwen1.5-0.5b"]


@pytest.mark.parametrize("arch", ALLOWED)
def test_a_one_token_step_on_the_card_takes_the_graph(arch, monkeypatch):
    m = model_of(arch)
    caches = _prefilled(m)
    assert _forward_takes(monkeypatch, m, {"tokens": tokens(2, 1)}, caches)


# why → (arch, config fields, forward: tokens a sequence "t", cache length
# "t_cache", grad "grad", extra batch keys "batch")
EXCLUSIONS = {
    "cpu": ("olmoe-1b-7b", {}, {"card": False}),
    "multi_token": ("deepseek-v2-lite", {}, {"t": 2}),
    "int8_cache": ("qwen1.5-0.5b", {"kv_cache_dtype": "int8"}, {}),
    "mrope": ("qwen2-vl-2b", {}, {}),
    "enc_dec": ("whisper-large-v3", {}, {}),
    "grad_on": ("deepseek-v2-lite", {}, {"grad": True}),
    "extra_batch_key": ("olmoe-1b-7b", {}, {
        "batch": {"positions": torch.full((1, 1), 6)}}),
    "gqa_cache_past_flash_keys": ("olmoe-1b-7b", {}, {
        "t_cache": layers.FLASH_DECODE_KEYS + 1}),
}


@pytest.mark.parametrize("why", list(EXCLUSIONS))
def test_every_other_forward_takes_the_eager_path(why, monkeypatch):
    arch, fields, opts = EXCLUSIONS[why]
    m = model_of(arch, **fields)
    caches = _prefilled(m, t=opts.get("t_cache", 12))
    batch = {"tokens": tokens(2, opts.get("t", 1)), **opts.get("batch", {})}
    assert not _forward_takes(monkeypatch, m, batch, caches,
                              card=opts.get("card", True),
                              grad=opts.get("grad", False))


def test_the_graphs_overflow_check_raises_on_the_host(monkeypatch):
    m = model_of("deepseek-v2-lite")
    caches = _prefilled(m, t=6, prompt=6)            # the cache is full
    with pytest.raises(ValueError, match="cache overflow: writing positions "
                       "6..6 into a cache of 6"):
        _forward_takes(monkeypatch, m, {"tokens": tokens(2, 1)}, caches)
    # the eager step raises the same
    monkeypatch.undo()
    with pytest.raises(ValueError, match="cache overflow"):
        with torch.no_grad():
            m({"tokens": tokens(2, 1)}, caches)


def test_a_replay_adds_the_counts_the_recorded_step_added():
    """The recorded step's counters are taken back out of the registry
    (``_uncounted``) and each replay adds exactly them (``_recount``): the
    whole cache's latent bytes of every layer and the MoE layers' pairs."""
    m = model_of("deepseek-v2-lite")
    cfg = m.cfg
    caches = _prefilled(m, b=2, t=12)
    telemetry.count("models.mla.latent_bytes", 5)    # counts already there
    before = telemetry.snapshot()["counters"]
    with torch.no_grad():
        (logits, _, _), counts = transformer._uncounted(
            lambda: m._forward({"tokens": tokens(2, 1)},
                               dict(caches, pos=torch.tensor([6])), False))
    assert logits.shape == (2, 1, cfg.vocab)
    assert telemetry.snapshot()["counters"] == before
    assert counts == {
        "models.mla.latent_bytes": cfg.n_layers * 2 * 12
        * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2,
        "models.moe.pairs": (cfg.n_layers - cfg.first_k_dense) * 2
        * cfg.experts_per_tok}
    for _ in range(3):
        transformer._recount(counts)
    after = telemetry.snapshot()["counters"]
    assert after == {k: n + 3 * counts.get(k, 0) for k, n in before.items()}


def test_a_forward_on_other_caches_drops_the_graph():
    m = model_of("deepseek-v2-lite")
    held = _prefilled(m)
    graph = DecodeGraph()
    graph.layers = {k: t for k, t in held["layers"].items() if k != "pos"}
    m._graph = graph
    with torch.no_grad():
        m({"tokens": tokens(2, 2)}, held)        # the same caches: kept
        assert m._graph is graph
        m({"tokens": tokens(2, 6)}, init_caches(m.cfg, 2, 12, device="cpu"))
    assert m._graph is None
    m._graph = graph
    with torch.no_grad():
        m({"tokens": tokens(2, 6)})               # no caches: dropped too
    assert m._graph is None


class _Launch:
    """Stands in for a recorded CUDA graph: a replay notes the copy the
    graph would read."""

    def __init__(self, copy):
        self.copy, self.seen = copy, []

    def replay(self):
        self.seen.append(self.copy.out.clone())


def test_a_replay_refills_changed_weights_before_it_launches():
    m = model_of("olmoe-1b-7b", "bfloat16")
    _prefilled(m)                       # casts every weight's copy once
    weights = [(p, c) for p in m.parameters()
               if (c := layers._kept_copy(p)) is not None]
    w = m.get_parameter("blocks.1.ffn.w_down")
    c = layers._kept_copy(w)
    g = DecodeGraph()
    g.weights, g.graph = weights, _Launch(c)
    g.tokens, g.pos = tokens(2, 1), torch.zeros(1, dtype=torch.long)
    g.logits, g.aux, g.counts = torch.zeros(2, 1, 4), torch.zeros(()), {}
    telemetry.reset("models.weight_cache.fills", "models.weight_cast_bytes")
    g.replay(tokens(2, 1), 6)
    assert telemetry.counter("models.weight_cache.fills") == 0
    with torch.no_grad():
        w.mul_(-2)
    ptr = c.out.data_ptr()
    g.replay(tokens(2, 1), 7)
    g.replay(tokens(2, 1), 8)
    assert torch.equal(g.graph.seen[1], w.detach().to(torch.bfloat16))
    assert torch.equal(g.graph.seen[2], g.graph.seen[1])
    assert not torch.equal(g.graph.seen[1], g.graph.seen[0])
    assert c.out.data_ptr() == ptr
    assert telemetry.counter("models.weight_cache.fills") == 1
    assert telemetry.counter("models.weight_cast_bytes") == 6 * w.numel()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


CARD = ["deepseek-v2-lite", "olmoe-1b-7b"]


def _decode(m, prompt, steps: int):
    """``greedy_decode``'s tokens and every forward's logits."""
    logits = []
    h = m.register_forward_hook(lambda mod, a, out: logits.append(
        out[0][:, -1].float().clone()))
    try:
        out = greedy_decode(m, m.cfg, prompt, steps=steps)
    finally:
        h.remove()
    return out, torch.stack(logits[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", CARD)
def test_greedy_decode_through_the_graph_equals_the_eager_decode(
        arch, monkeypatch):
    dev = cuda_or_skip()
    m = model_of(arch, device=dev)
    prompt, steps = tokens(4, 20, dev), 12
    telemetry.reset("models.graph.captures", "models.graph.replays")
    got, got_logits = _decode(m, prompt, steps)
    counters = telemetry.snapshot()["counters"]
    assert counters["models.graph.captures"] == 1
    assert counters["models.graph.replays"] == steps - 2
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)
    want, want_logits = _decode(m, prompt, steps)
    assert torch.equal(got, want)
    print(f"{arch}: logits bit-equal {torch.equal(got_logits, want_logits)},"
          f" largest difference {rel_err(got_logits, want_logits):.3g}"
          " × max|logit|")
    assert rel_err(got_logits, want_logits) <= TOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", CARD)
def test_a_replayed_step_does_not_synchronise(arch):
    """From the first replay (the third forward) on, decoding raises
    nothing under the sync-debug mode "error"."""
    dev = cuda_or_skip()
    m = model_of(arch, device=dev)
    seen = [0]
    mode = torch.cuda.get_sync_debug_mode()

    def strict(*_):
        seen[0] += 1
        if seen[0] == 3:
            torch.cuda.set_sync_debug_mode("error")
    h = m.register_forward_pre_hook(strict)
    try:
        greedy_decode(m, m.cfg, tokens(4, 20, dev), steps=8)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        h.remove()
    assert seen[0] == 8


@pytest.mark.gpu
def test_a_second_request_drops_the_first_requests_graph():
    dev = cuda_or_skip()
    m = model_of("deepseek-v2-lite", device=dev)
    greedy_decode(m, m.cfg, tokens(4, 20, dev), steps=4)
    first = weakref.ref(m._graph)
    alive = []
    h = m.blocks[0].register_forward_pre_hook(
        lambda *_: alive.append(first() is not None))
    try:
        greedy_decode(m, m.cfg, tokens(4, 24, dev, seed=8), steps=4)
    finally:
        h.remove()
    # gone before the second request's prefill ran its first layer
    assert alive[0] is False
    assert m._graph is not None and first() is None


def _default_pool(t: torch.Tensor) -> bool:
    """Whether ``t`` lies in a segment of the allocator's own pool, not a
    CUDA graph's private one."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["address"] <= ptr < seg["address"] + seg["total_size"]:
            return tuple(seg["segment_pool_id"]) == (0, 0)
    raise AssertionError(f"no segment holds {ptr:#x}")


def _one_token_steps(m, toks, steps: int):
    """``steps`` one-token forwards from empty caches (no prefill): the
    first is the graph's capture.  Returns the tokens fed and every
    step's logits."""
    caches = init_caches(m.cfg, toks.shape[0], steps, device=toks.device)
    logits = []
    with torch.no_grad():
        for p in range(steps):
            out, _, caches = m({"tokens": toks[:, p:p + 1]}, caches)
            logits.append(out[:, -1].float())
    return toks[:, :steps], torch.stack(logits)


@pytest.mark.gpu
@pytest.mark.parametrize("first_cast", ["prefill", "capture"])
def test_decoding_with_the_weight_copies_is_bit_equal_to_the_eager_decode(
        first_cast, monkeypatch):
    """Reduced OLMoE (float32 parameters, bf16 compute): every weight is
    cast once, by greedy decoding's prefill on the caller's stream or by
    a graph's first step on the capture's side stream, outside the
    graph's pool; the graph and the eager decode read the copies alike,
    logits bit-equal."""
    dev = cuda_or_skip()
    m = model_of("olmoe-1b-7b", device=dev)
    n_cast = sum(p.dtype == torch.float32 and not n.endswith(".router")
                 and n != "embed" for n, p in m.named_parameters())
    steps = 12

    def run():
        if first_cast == "prefill":
            return _decode(m, tokens(4, 20, dev), steps)
        return _one_token_steps(m, tokens(4, steps, dev), steps)
    telemetry.reset("models.weight_cache.fills", "models.weight_cache.hits",
                    "models.graph.captures")
    got, got_logits = run()
    counters = telemetry.snapshot()["counters"]
    assert counters["models.graph.captures"] == 1
    assert counters["models.weight_cache.fills"] == n_cast
    assert counters["models.weight_cache.hits"] == (steps - 1) * n_cast
    assert len(m._graph.weights) == n_cast
    assert all(_default_pool(c.out) for _, c in m._graph.weights)
    monkeypatch.setattr(transformer, "_cuda", lambda t: False)
    want, want_logits = run()
    assert telemetry.counter("models.weight_cache.fills") == n_cast
    assert torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)


@pytest.mark.gpu
def test_a_replay_after_a_weight_changed_serves_the_new_weights(
        monkeypatch):
    """Weights changed in place between two replays: the next replay,
    under the sync-debug mode "error", equals an eager step of a model
    that held the changed weights from the start, bit for bit."""
    dev = cuda_or_skip()
    m = model_of("olmoe-1b-7b", device=dev)
    cfg = m.cfg
    toks = tokens(4, 24, dev)
    caches = init_caches(cfg, 4, 24, device=dev)
    telemetry.reset("models.graph.replays")
    with torch.no_grad():
        caches = m({"tokens": toks[:, :20]}, caches)[2]
        for p in (20, 21):                       # capture, then a replay
            caches = m({"tokens": toks[:, p:p + 1]}, caches)[2]
        assert telemetry.counter("models.graph.replays") == 1
        changed = ("blocks.0.attn.wq", "blocks.1.ffn.w_up", "lm_head")
        for name in changed:
            m.get_parameter(name).mul_(-1.5)
        saved = {k: t.clone() for k, t in caches["layers"].items()}
        telemetry.reset("models.weight_cache.fills")
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = m({"tokens": toks[:, 22:23]}, caches)[0]
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        assert telemetry.counter("models.weight_cache.fills") == len(changed)
        for k, t in saved.items():
            caches["layers"][k].copy_(t)
        fresh = model_of("olmoe-1b-7b", device=dev)
        fresh.load_state_dict(m.state_dict())
        monkeypatch.setattr(transformer, "_cuda", lambda t: False)
        want = fresh({"tokens": toks[:, 22:23]}, caches)[0]
    assert torch.equal(got, want)
