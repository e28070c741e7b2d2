"""The port's XNOR-popcount matmul (``repro_torch.kernels.bitserial_matmul``)
and its oracles against the reference package.

On the CPU the wrapper runs its plain PyTorch version, held here against
the reference's Pallas kernel (``interpret=True``), its jnp oracle
(``repro.kernels.ref.bitserial_matmul_ref``) and the float product of the
±1 operands.  The ``gpu``-marked test holds the CUDA kernel against its
plain version on the card; without a CUDA device it skips with the reason
"no CUDA device".  JAX and the reference package are imported inside the
CPU tests only.  Every comparison is exact: the values are integers.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitserial_matmul as K3
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_plain,
                                                  pack_signs)
from repro_torch.kernels.ref import bitserial_matmul_ref, popcount_ref

# tests/test_kernels.py's sweep plus an M = 33 edge (the reference tiles
# bm = min(128, m), so 33 rows are one block)
SHAPES = [(128, 128, 32), (128, 256, 64), (256, 128, 128), (33, 128, 96)]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def signs(rng, shape) -> np.ndarray:
    return rng.choice([-1.0, 1.0], shape).astype(np.float32)


def test_pack_signs_matches_reference():
    import jax.numpy as jnp

    from repro.kernels.bitserial_matmul import pack_signs as ref_pack_signs
    rng = np.random.default_rng(0x5167)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    x[0, 0, :32] = 0.0                      # a whole word of zeros
    x[1, 2, 31] = -0.0                      # −0.0 at bit 31
    x[2, 4, 7] = 0.0
    x[2, 4, 31] = -1.5                      # bit 31 clear
    x[0, 1, :] = np.where(np.arange(128) % 2, -0.0, 0.0)
    x[1, 1, :] = -1.0                       # every bit clear
    x[1, 3, :] = 1.0                        # every bit set (word −1)
    want = np.asarray(ref_pack_signs(jnp.asarray(x)))
    got = pack_signs(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 4)
    np.testing.assert_array_equal(u32(got), want)
    ints = rng.integers(-3, 3, (4, 64))
    np.testing.assert_array_equal(
        u32(pack_signs(torch.from_numpy(ints))),
        np.asarray(ref_pack_signs(jnp.asarray(ints))))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_bitserial_matmul_matches_reference(m, n, k):
    import jax.numpy as jnp

    from repro.kernels.bitserial_matmul import (
        bitserial_matmul as ref_bitserial_matmul, pack_signs as ref_pack_signs)
    from repro.kernels.ref import bitserial_matmul_ref as jax_matmul_ref
    rng = np.random.default_rng(m * 1000 + n + k)
    af, bf = signs(rng, (m, k)), signs(rng, (n, k))
    ap, bp = ref_pack_signs(jnp.asarray(af)), ref_pack_signs(jnp.asarray(bf))
    pa, pb = pack_signs(torch.from_numpy(af)), pack_signs(torch.from_numpy(bf))
    np.testing.assert_array_equal(u32(pa), np.asarray(ap))
    got = bitserial_matmul(pa, pb, k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_bitserial_matmul(ap, bp, k, bk=1, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_matmul_ref(ap, bp, k)))
    np.testing.assert_array_equal(got, (af @ bf.T).astype(np.int32))
    np.testing.assert_array_equal(bitserial_matmul_ref(pa, pb, k).numpy(), got)


def test_popcount_ref_counts_bit_31():
    import jax.numpy as jnp

    from repro.kernels.ref import popcount_ref as jax_popcount_ref
    rng = np.random.default_rng(0xB17)
    words = rng.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    words[:4] = (0x80000000, 0xFFFFFFFF, 0x80000001, 0)
    words[4:512] |= np.uint32(0x80000000)          # half with bit 31 set
    want = np.array([bin(w).count("1") for w in words.tolist()])
    got = popcount_ref(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_popcount_ref(jnp.asarray(words))))


def test_plain_version_chunks_rows(monkeypatch):
    """Chunked over rows of a (a chunk smaller than one row included), the
    plain version equals the unchunked oracle."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (37, 5)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (11, 5)).astype(np.int32))
    want = bitserial_matmul_ref(a, b, 160)
    for chunk in (1, 7 * 55, 1 << 25):
        monkeypatch.setattr(K3, "_PLAIN_CHUNK", chunk)
        np.testing.assert_array_equal(bitserial_matmul_plain(a, b, 160).numpy(),
                                      want.numpy())


def test_wrapper_keeps_the_reference_checks():
    a = torch.zeros((128, 2), dtype=torch.int32)
    with pytest.raises(AssertionError):
        bitserial_matmul(a, a, 32)                      # k_bits != 32·Kw
    with pytest.raises(AssertionError):                 # 200 % min(128, 200)
        bitserial_matmul(a, torch.zeros((200, 2), dtype=torch.int32), 64)
    with pytest.raises(AssertionError):
        bitserial_matmul(a, torch.zeros((128, 3), dtype=torch.int32), 64)
    with pytest.raises(AssertionError):                 # 10 % min(8, 10)
        bitserial_matmul(torch.zeros((4, 10), dtype=torch.int32),
                         torch.zeros((4, 10), dtype=torch.int32), 320)
    with pytest.raises(TypeError):
        bitserial_matmul(a.to(torch.int64), a, 64)
    launches = bitserial_matmul.launches
    bitserial_matmul(a, a, 64)
    assert bitserial_matmul.launches == launches       # the CPU launches nothing


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel ≡ its plain version: tile-aligned shapes, ragged
    M/N/Kw edges (M 33, N 100, Kw 5), every bit pattern of the words, a
    non-contiguous operand and a side stream."""
    device = cuda_or_skip()
    g = torch.Generator(device=device).manual_seed(0xC3)

    def words(rows, kw):
        return torch.randint(-2**31, 2**31, (rows, kw), dtype=torch.int32,
                             device=device, generator=g)

    for m, n, kw in ((128, 128, 8), (256, 512, 784), (33, 100, 5),
                     (64, 64, 40), (1, 1, 1)):
        a, b = words(m, kw), words(n, kw)
        before = bitserial_matmul.launches
        got = bitserial_matmul(a, b, 32 * kw)
        assert bitserial_matmul.launches == before + 1
        want = bitserial_matmul_plain(a, b, 32 * kw)
        assert torch.equal(got, want), (m, n, kw)
    a = words(64, 16)
    b = words(32, 64)[:, ::4]                       # [32, 16], not contiguous
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        got = bitserial_matmul(a, b, 512)
    stream.synchronize()
    assert torch.equal(got, bitserial_matmul_plain(a, b.contiguous(), 512))
