"""The compute-dtype weight copies (``models.layers._cast``, ``_Copy``), on
the CPU at reduced sizes.

Without grad a float32 parameter is cast to the compute dtype once and
the copy serves its later uses, bit for bit the cast's own values; under
grad every use casts, so gradients reach the float32 parameter.  A
parameter changed in place, given new data (``.data =``) or replaced by
another object is never served its old values; bf16 parameters make no
copy.  A decode graph's replay refills a changed parameter's copy before
it launches (``tests/test_torch_decode_graph.py``).
"""
import dataclasses
import pickle

import pytest
import torch
from torch import nn

from repro_torch import telemetry
from repro_torch.configs import get_reduced
from repro_torch.models.layers import _dt, _kept_copy
from repro_torch.models.transformer import Transformer

FILLS, HITS = "models.weight_cache.fills", "models.weight_cache.hits"
CAST = "models.weight_cast_bytes"


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset()
    yield
    telemetry.reset()


def model_of(arch: str = "olmoe-1b-7b", seed: int = 31, **fields):
    cfg = dataclasses.replace(get_reduced(arch), **fields)
    return Transformer(cfg, "cpu").draw_params(
        torch.Generator().manual_seed(seed))


def batch_of(m, seed: int = 5):
    return {"tokens": torch.randint(
        0, m.cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(seed))}


def cast_params(m) -> dict:
    """The parameters a forward casts: every one held in another dtype
    than the compute dtype but the embedding table (its gathered rows are
    cast; a tied head casts the table itself) and the routers (float32)."""
    dt = _dt(m.cfg)
    return {n: p for n, p in m.named_parameters()
            if p.dtype != dt and not n.endswith(".router")
            and (n != "embed" or m.cfg.tie_embeddings)}


def counts() -> dict:
    c = telemetry.snapshot()["counters"]
    return {k: c.get(k, 0) for k in (CAST, FILLS, HITS)}


def no_grad_logits(m, batch):
    with torch.no_grad():
        return m(batch)[0]


# olmoe: the cell's model; qwen: a tied head (the table's copy,
# transposed)
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen1.5-0.5b"])
def test_a_second_no_grad_forward_is_served_the_first_ones_casts(arch):
    m = model_of(arch)
    batch = batch_of(m)
    params = cast_params(m)
    cast_bytes = sum(6 * p.numel() for p in params.values())
    first = no_grad_logits(m, batch)
    assert counts() == {CAST: cast_bytes, FILLS: len(params), HITS: 0}
    assert all(_kept_copy(p) is not None for p in params.values())
    second = no_grad_logits(m, batch)
    assert counts() == {CAST: cast_bytes, FILLS: len(params),
                        HITS: len(params)}
    assert torch.equal(first, second)
    # a forward under grad casts at each use, to the same values
    with_grad = m(batch)[0]
    assert with_grad.requires_grad
    assert torch.equal(with_grad.detach(), first)
    assert counts() == {CAST: 2 * cast_bytes, FILLS: len(params),
                        HITS: len(params)}


def test_under_grad_every_use_casts_and_the_gradient_reaches_float32():
    """A model whose copies were cast gets the same float32 gradients as
    one that never ran without grad, and a forward under grad makes no
    copy."""
    used, fresh = model_of(), model_of()
    batch = batch_of(used)
    no_grad_logits(used, batch)
    grads = []
    for m in (used, fresh):
        m(batch)[0].float().square().mean().backward()
        grads.append({n: p.grad for n, p in cast_params(m).items()})
    assert all(_kept_copy(p) is None for p in fresh.parameters())
    for n, g in grads[0].items():
        assert g is not None and g.dtype == torch.float32, n
        assert torch.equal(g, grads[1][n]), n


def _add(m, name):
    with torch.no_grad():
        m.get_parameter(name).add_(0.25)


def _copy(m, name):
    p = m.get_parameter(name)
    with torch.no_grad():
        p.copy_(p * 3)


def _load_state_dict(m, name):
    p = m.get_parameter(name)
    m.load_state_dict({name: -p.detach()}, strict=False)


def _set_data(m, name):
    p = m.get_parameter(name)
    p.data = p.detach() * 2 + 1          # new storage, same version counter


def _replace(m, name):
    mod, _, leaf = name.rpartition(".")
    p = m.get_parameter(name)
    setattr(m.get_submodule(mod) if mod else m, leaf,
            nn.Parameter(p.detach() - 0.5))


def _pickle(m, name):
    """The parameter's pickled round trip: the object that comes back
    keeps no copy."""
    mod, _, leaf = name.rpartition(".")
    back = pickle.loads(pickle.dumps(m.get_parameter(name)))
    assert _kept_copy(back) is None
    with torch.no_grad():
        back.mul_(0.5)
    setattr(m.get_submodule(mod) if mod else m, leaf, back)


# how → refilled in place (the copy's storage kept)
CHANGES = {"add_": (_add, True), "copy_": (_copy, True),
           "load_state_dict": (_load_state_dict, True),
           "data_assigned": (_set_data, True),
           "replaced": (_replace, False), "pickled": (_pickle, False)}


@pytest.mark.parametrize("how", list(CHANGES))
@pytest.mark.parametrize("name", ["blocks.1.ffn.w_down", "lm_head",
                                  "final_norm.scale"])
def test_a_changed_parameter_is_never_served_its_old_values(how, name):
    change, in_place = CHANGES[how]
    m = model_of()
    batch = batch_of(m)
    no_grad_logits(m, batch)
    old = _kept_copy(m.get_parameter(name))
    old_ptr = old.out.data_ptr()
    change(m, name)
    before = counts()
    got = no_grad_logits(m, batch)
    after = counts()
    p = m.get_parameter(name)
    assert after[FILLS] - before[FILLS] == 1
    assert after[CAST] - before[CAST] == 6 * p.numel()
    assert after[HITS] - before[HITS] == len(cast_params(m)) - 1
    c = _kept_copy(p)
    assert (c is old and c.out.data_ptr() == old_ptr) == in_place
    # a model holding the changed weights from the start, never cached
    fresh = model_of()
    fresh.load_state_dict(m.state_dict())
    assert torch.equal(got, no_grad_logits(fresh, batch))
    assert torch.equal(c.out, p.detach().to(c.out.dtype))


def test_new_data_at_the_old_address_is_refilled():
    """``.data =`` a new storage that lies where the old one did, as an
    allocator may place it: the data pointer and the version counter are
    the old ones, the storage is not (two storages over one numpy buffer
    stand in for the reused address)."""
    m = model_of()
    batch = batch_of(m)
    p = m.get_parameter("lm_head")
    buf = p.detach().numpy().copy()
    p.data = torch.from_numpy(buf)
    no_grad_logits(m, batch)
    ptr, version = p.data_ptr(), p._version
    buf *= 2
    p.data = torch.from_numpy(buf)
    assert (p.data_ptr(), p._version) == (ptr, version)
    got = no_grad_logits(m, batch)
    assert counts()[FILLS] == len(cast_params(m)) + 1
    fresh = model_of()
    fresh.load_state_dict(m.state_dict())
    assert torch.equal(got, no_grad_logits(fresh, batch))


def test_bf16_parameters_make_no_copies():
    """DeepSeek-V2-Lite holds its parameters in bf16, its compute dtype:
    no cast, no copy, no counter."""
    m = model_of("deepseek-v2-lite")
    assert m.cfg.param_dtype == m.cfg.compute_dtype == "bfloat16"
    batch = batch_of(m)
    no_grad_logits(m, batch)
    no_grad_logits(m, batch)
    assert all(_kept_copy(p) is None for p in m.parameters())
    assert not {CAST, FILLS, HITS} & set(telemetry.snapshot()["counters"])


def test_tensors_made_from_a_parameter_are_cast_at_each_use():
    """The binarized MLP casts ``sign_ste(w)``, not a parameter: its gate
    and up projections are cast at every use, its down projection once."""
    m = model_of("qwen1.5-0.5b", pum_mlp=True)
    batch = batch_of(m)
    no_grad_logits(m, batch)
    before = counts()
    no_grad_logits(m, batch)
    after = counts()
    signed = [p for n, p in m.named_parameters()
              if n.endswith(("ffn.w_gate", "ffn.w_up"))]
    assert signed and all(_kept_copy(p) is None for p in signed)
    assert _kept_copy(m.get_parameter("blocks.0.ffn.w_down")) is not None
    assert after[CAST] - before[CAST] == sum(6 * p.numel() for p in signed)
    assert after[FILLS] == before[FILLS]
    assert after[HITS] - before[HITS] == len(cast_params(m)) - len(signed)
