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
from repro_torch.kernels.bitserial_matmul import (BLOCKS_PER_SM,
                                                  K_TILE_WORDS, MAX_SPLIT,
                                                  TILE, bitserial_matmul,
                                                  bitserial_matmul_plain,
                                                  launch_plan, pack_signs,
                                                  unpack_signs)
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


def word_pattern(rng, pattern: str, shape) -> np.ndarray:
    """uint32 words: random, all zeros (every value −1), all ones (every
    value +1) or only bit 31 set."""
    if pattern == "random":
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)
    fill = {"zeros": 0, "ones": 0xFFFFFFFF, "bit31": 0x80000000}[pattern]
    return np.full(shape, fill, dtype=np.uint32)


def pm1_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's formulation on the CPU: Σ_k s_a·s_b over ±1 values
    unpacked with the port's helper, in int64, with K zero-padded (int8
    zeros, not zero words) to a whole number of the kernel's k-tiles."""
    k = a.shape[1] * 32
    pad = -k % (K_TILE_WORDS * 32)
    ua = torch.nn.functional.pad(unpack_signs(a), (0, pad)).to(torch.int64)
    ub = torch.nn.functional.pad(unpack_signs(b), (0, pad)).to(torch.int64)
    return ua @ ub.T


@pytest.mark.parametrize("pattern", ["random", "zeros", "ones", "bit31"])
@pytest.mark.parametrize("m,n,kw", [(1, 1, 1), (33, 100, 5), (128, 128, 8)])
def test_pm1_formulation_matches_plain_and_reference(m, n, kw, pattern):
    """K − 2·popcount(a ⊕ b) ≡ Σ s_a·s_b (the INT8 tensor-core form) ≡
    the plain version ≡ the reference's Pallas kernel (interpret mode)."""
    import jax.numpy as jnp

    from repro.kernels.bitserial_matmul import (
        bitserial_matmul as ref_bitserial_matmul)
    rng = np.random.default_rng(m * 7919 + n * 31 + kw)
    wa = word_pattern(rng, pattern, (m, kw))
    wb = word_pattern(rng, pattern, (n, kw))
    if pattern != "random":         # the other side random: every product
        wb = word_pattern(rng, "random", (n, kw))
    a = torch.from_numpy(wa.view(np.int32))
    b = torch.from_numpy(wb.view(np.int32))
    got = pm1_product(a, b)
    plain = bitserial_matmul_plain(a, b, 32 * kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    ref = ref_bitserial_matmul(jnp.asarray(wa), jnp.asarray(wb), 32 * kw,
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if pattern == "zeros":          # every a value −1: out = −Σ s_b
        col = -unpack_signs(b).to(torch.int64).sum(1).numpy()
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(col, (m, n)))


def test_zero_word_padding_adds_32_a_word():
    """The trap the kernel avoids: a word of zeros is 32 × (−1), so padding
    K with zero words adds 32 per padded word to every output."""
    rng = np.random.default_rng(0x7A11)
    a = torch.from_numpy(word_pattern(rng, "random", (9, 5)).view(np.int32))
    b = torch.from_numpy(word_pattern(rng, "random", (7, 5)).view(np.int32))
    out = bitserial_matmul_plain(a, b, 160)
    for pad in (1, 3):
        zeros = torch.zeros((1, pad), dtype=torch.int32)
        ap = torch.cat([a, zeros.expand(9, pad)], 1)
        bp = torch.cat([b, zeros.expand(7, pad)], 1)
        padded = bitserial_matmul_plain(ap, bp, 32 * (5 + pad))
        np.testing.assert_array_equal(padded.numpy(), (out + 32 * pad).numpy())
        np.testing.assert_array_equal(pm1_product(ap, bp).numpy(),
                                      padded.numpy())


def test_unpack_signs_inverts_pack_signs():
    rng = np.random.default_rng(0x1B)
    x = torch.from_numpy(rng.choice([-1, 1], (3, 4, 96)).astype(np.int8))
    words = pack_signs(x)
    assert torch.equal(unpack_signs(words), x)
    top = unpack_signs(torch.tensor([[-2**31]], dtype=torch.int32))
    assert top[0, 31] == 1 and (top[0, :31] == -1).all()


@pytest.mark.parametrize("m,n,kw,want", [
    (256, 4096, 784, (2, 32, 2, 49)),       # VGG-16 FC6, batch 256
    (256, 4096, 128, (2, 32, 2, 8)),        # FC7
    (128, 128, 8, (1, 1, 1, 1)),            # the applications example
    (33, 100, 5, (1, 1, 1, 1)),             # Kw below one k-tile
    (17, 9, 33, (1, 1, 5, 1)),              # a K tail after whole k-tiles
    (1, 4096, 1, (1, 32, 1, 1)),
])
def test_launch_plan(m, n, kw, want):
    assert tuple(launch_plan(m, n, kw, sms=132)) == want


def test_launch_plan_covers_k_exactly():
    """Every split has at least one k-tile, the splits cover the K axis
    once, a tile has at most MAX_SPLIT splits (one cluster), and the grid
    stays near BLOCKS_PER_SM blocks an SM."""
    for m in (1, 33, 128, 129, 256, 1000):
        for n in (1, 100, 4096):
            for kw in (1, 5, 8, 9, 33, 128, 784, 5000):
                for sms in (1, 132):
                    p = launch_plan(m, n, kw, sms)
                    k_tiles = -(-kw // K_TILE_WORDS)
                    assert p.tiles_m * TILE >= m > (p.tiles_m - 1) * TILE
                    assert p.tiles_n * TILE >= n > (p.tiles_n - 1) * TILE
                    assert 1 <= p.split <= min(k_tiles, MAX_SPLIT)
                    assert (p.split - 1) * p.tiles_per_split < k_tiles \
                        <= p.split * p.tiles_per_split
                    assert p.split == 1 or p.blocks <= BLOCKS_PER_SM * sms


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel ≡ its plain version: tile-aligned shapes, ragged
    M/N/Kw edges (M 33, N 100, Kw 5), the full FC6 (split K), a K tail
    after a whole k-tile (17, 9, 33), one row (1, 4096, 1), every bit
    pattern of the words, a non-contiguous operand, a side stream and a
    repeated split-K run that must give identical outputs."""
    device = cuda_or_skip()
    g = torch.Generator(device=device).manual_seed(0xC3)

    def words(rows, kw):
        return torch.randint(-2**31, 2**31, (rows, kw), dtype=torch.int32,
                             device=device, generator=g)

    for m, n, kw in ((128, 128, 8), (256, 512, 784), (33, 100, 5),
                     (64, 64, 40), (1, 1, 1), (256, 4096, 784), (17, 9, 33),
                     (1, 4096, 1)):
        a, b = words(m, kw), words(n, kw)
        before = bitserial_matmul.launches
        # bk=1: the reference's K block must divide Kw (33)
        got = bitserial_matmul(a, b, 32 * kw, bk=1)
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
    # split K adds its partial tiles across a cluster: the same inputs give
    # the same bits on every run
    a, b = words(256, 784), words(4096, 784)
    assert launch_plan(256, 4096, 784, torch.cuda.get_device_properties(
        device).multi_processor_count).split > 1
    first = bitserial_matmul(a, b, 32 * 784)
    assert torch.equal(bitserial_matmul(a, b, 32 * 784), first)
