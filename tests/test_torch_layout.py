"""The port's vertical layout (``repro_torch.simdram.layout``) and the plain
version of its transposition kernel, held bit for bit against
``repro.simdram.layout`` and ``repro.kernels``.

Inputs are made with numpy from a seed and handed to both packages; plane
words cross as uint32 numpy arrays (the port's int32 words viewed as
uint32).  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitplane_transpose import bitplane_transpose as jax_transpose
from repro.kernels.ref import bitplane_transpose_ref
from repro.simdram import layout as R
from repro_torch.interop import bitplanes_from_numpy, bitplanes_to_numpy
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.bitplane_transpose import (bitplane_transpose,
                                                    from_planes,
                                                    from_planes_plain,
                                                    to_planes, to_planes_plain)
from repro_torch.kernels.ops import transpose_to_planes
from repro_torch.simdram import layout as T

RNG = np.random.default_rng(0x1A70)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def values(n_bits: int, shape, signed: bool) -> np.ndarray:
    lo, hi = (-(1 << (n_bits - 1)), 1 << (n_bits - 1)) if signed \
        else (0, 1 << n_bits)
    if n_bits == 32:
        lo, hi = -(1 << 31), 1 << 31       # every int32 bit pattern
    return RNG.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("n_bits", [1, 5, 8, 16, 32])
def test_to_and_from_bitplanes_match_reference(n_bits, signed):
    v = values(n_bits, 160, signed)
    want = np.asarray(R.to_bitplanes(jnp.asarray(v), n_bits))
    got = T.to_bitplanes(torch.from_numpy(v), n_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    back_ref = np.asarray(R.from_bitplanes(jnp.asarray(want), signed=signed))
    back = T.from_bitplanes(got, signed=signed)
    np.testing.assert_array_equal(back.numpy(), back_ref)
    planes = RNG.integers(0, 1 << 32, (n_bits, 7), dtype=np.uint64) \
        .astype(np.uint32)
    np.testing.assert_array_equal(
        T.from_bitplanes(torch.from_numpy(planes.view(np.int32)),
                         signed=signed).numpy(),
        np.asarray(R.from_bitplanes(jnp.asarray(planes), signed=signed)))


def test_from_bitplanes_wide_dtype_sees_unsigned_words():
    planes = np.full((32, 1), 0xFFFFFFFF, np.uint32)
    t = torch.from_numpy(planes.view(np.int32))
    assert (T.from_bitplanes(t, dtype=torch.int64) == 0xFFFFFFFF).all()
    assert (T.from_bitplanes(t[:8], signed=True, dtype=torch.int64) == -1).all()


@pytest.mark.parametrize("n_bits,signed", [(8, False), (8, True), (13, True),
                                           (32, False)])
@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("length", [45, 64, 100])
def test_bitplane_array_round_trip_matches_reference(length, banked, n_bits,
                                                     signed):
    shape = (3, length) if banked else (length,)
    v = values(n_bits, shape, signed)
    ref = R.BitplaneArray.from_values(jnp.asarray(v), n_bits, signed=signed)
    got = T.BitplaneArray.from_values(torch.from_numpy(v), n_bits,
                                      signed=signed)
    assert (got.banked, got.n_banks, got.words, got.length) == \
        (ref.banked, ref.n_banks, ref.words, ref.length)
    np.testing.assert_array_equal(u32(got.planes), np.asarray(ref.planes))
    np.testing.assert_array_equal(got.to_values().numpy(),
                                  np.asarray(ref.to_values()))
    np.testing.assert_array_equal(got.to_values().numpy(), v)


def test_pack_and_unpack_mask_match_reference():
    mask = RNG.integers(0, 2, 96).astype(bool)
    packed = T.pack_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(u32(packed[None])[0],
                                  np.asarray(R.pack_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(T.unpack_mask(packed).numpy(), mask)


@pytest.mark.parametrize("banked", [False, True])
def test_plane_rewrites_match_reference(banked):
    shape = (2, 128) if banked else (128,)
    v = values(8, shape, signed=False)
    ref = R.BitplaneArray.from_values(jnp.asarray(v), 8)
    got = T.BitplaneArray.from_values(torch.from_numpy(v), 8)
    pairs = [(ref.flip_msb(), got.flip_msb()),
             (ref.astype_bits(4), got.astype_bits(4)),
             (ref.astype_bits(12), got.astype_bits(12))]
    pairs += list(zip(ref.split_lanes(), got.split_lanes()))
    pairs += [(ref.shift_lanes(k), got.shift_lanes(k)) for k in (1, 5, 31)]
    for r, g in pairs:
        assert (g.n_bits, g.length, g.signed) == (r.n_bits, r.length, r.signed)
        np.testing.assert_array_equal(u32(g.planes), np.asarray(r.planes))
    # the source planes are untouched by every rewrite
    np.testing.assert_array_equal(u32(got.planes), np.asarray(ref.planes))


def test_rebank_and_hooks_match_reference():
    """Scatter/gather planes, TRANSPOSE_STATS deltas and the transpose and
    movement hook event sequences agree with the reference."""
    events = {"ref": [], "port": []}

    def hooks(key):
        return (lambda kind, n_bits, lanes: events[key].append(
                    ("t", kind, n_bits, lanes)),
                lambda kind, n_rows, banks, planes: events[key].append(
                    ("m", kind, n_rows, banks, planes is not None)))

    v = values(8, 256, signed=False)
    outs = {}
    for key, mod, arr in (("ref", R, jnp.asarray(v)),
                          ("port", T, torch.from_numpy(v))):
        th, mh = hooks(key)
        mod.register_transpose_hook(th)
        mod.register_movement_hook(mh)
        before = mod.transpose_counts()
        try:
            x = mod.BitplaneArray.from_values(arr, 8)
            scattered = x.rebank(4)
            again = scattered.rebank(2)
            gathered = again.rebank(None)
            vals = gathered.to_values()
            mod.note_elided_movement(8)
        finally:
            mod.unregister_transpose_hook(th)
            mod.unregister_movement_hook(mh)
        after = mod.transpose_counts()
        outs[key] = (scattered, again, gathered, np.asarray(vals),
                     (after[0] - before[0], after[1] - before[1]))
    assert events["port"] == events["ref"]
    assert events["port"][0] == ("t", "to", 8, 256)
    for r, g in zip(outs["ref"][:3], outs["port"][:3]):
        np.testing.assert_array_equal(u32(g.planes), np.asarray(r.planes))
        assert (g.length, g.n_banks) == (r.length, r.n_banks)
    np.testing.assert_array_equal(outs["port"][3], v)
    assert outs["port"][4] == outs["ref"][4] == (1, 1)


@pytest.mark.parametrize("g", [128, 256])
def test_transpose_plain_matches_pallas_kernel_and_ref(g):
    groups = RNG.integers(0, 1 << 32, (g, 32), dtype=np.uint64) \
        .astype(np.uint32)
    want = np.asarray(jax_transpose(jnp.asarray(groups), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(bitplane_transpose_ref(jnp.asarray(groups))))
    t = torch.from_numpy(groups.view(np.int32))
    np.testing.assert_array_equal(u32(bitplane_transpose(t)), want)
    np.testing.assert_array_equal(u32(port_ref.bitplane_transpose_ref(t)), want)
    np.testing.assert_array_equal(
        u32(transpose_to_planes(t.reshape(-1).to(torch.int64), 8)), want[:8])
    # the transpose is its own inverse; from_planes undoes to_planes
    flat = t.reshape(-1)
    np.testing.assert_array_equal(
        from_planes_plain(to_planes_plain(flat, 32)).numpy(), flat.numpy())


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    v = torch.from_numpy(values(16, 64, signed=True))
    n_to, n_from = to_planes.launches, from_planes.launches
    planes = to_planes(v, 16)
    assert torch.equal(planes, to_planes_plain(v, 16))
    assert torch.equal(from_planes(planes, signed=True), v)
    assert (to_planes.launches, from_planes.launches) == (n_to, n_from)
    with pytest.raises(TypeError):
        to_planes(v.to(torch.int64), 16)
    with pytest.raises(ValueError):
        to_planes(v[:40], 16)


@pytest.mark.parametrize("banked", [False, True])
def test_interop_carries_reference_state_into_the_port(banked):
    shape = (2, 70) if banked else (70,)
    v = values(12, shape, signed=True)
    ref = R.BitplaneArray.from_values(jnp.asarray(v), 12, signed=True)
    got = bitplanes_from_numpy(np.asarray(ref.planes), ref.n_bits, ref.length,
                               ref.signed, device="cpu")
    np.testing.assert_array_equal(got.to_values().numpy(), v)
    planes, n_bits, length, signed = bitplanes_to_numpy(got)
    assert planes.dtype == np.uint32
    back = R.BitplaneArray(jnp.asarray(planes), n_bits, length, signed)
    np.testing.assert_array_equal(np.asarray(back.to_values()), v)
    assert (n_bits, length, signed) == (12, 70, True)
