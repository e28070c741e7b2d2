"""XNOR-NET binarized matmul: the compute hot-spot of the paper's
application suite (XNOR-NET VGG/LeNet, kNN distances, BitWeaving scans).

Both operands are sign-packed, 32 values a word (bit 1 = +1, bit 0 = −1),
and the inner product of two packed rows is ``K − 2·popcount(a ⊕ b)``.
:func:`pack_signs` packs; :func:`bitserial_matmul` contracts int32[M, K/32]
with int32[N, K/32] into int32[M, N].  On a CUDA tensor it launches the
hand-written kernel in ``csrc/bitserial_matmul.cu`` (the same sum as a
u8 product of 0/1 bytes on the INT8 tensor cores, ``wgmma``, corrected by
row popcounts; K split across a cluster of blocks where the output tiles
do not fill the card); on a CPU tensor it runs
:func:`bitserial_matmul_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import bitserial_matmul_ref

WORD = 32           # packed values per word
# elements of the [rows, N, K/32] intermediate the plain version builds at
# once (int64 popcounts: ~0.25 GB a chunk)
_PLAIN_CHUNK = 1 << 25
# the kernel's tiling (csrc/bitserial_matmul.cu: kTile, kBk) and its
# resident blocks an SM (__launch_bounds__(kThreads, 1))
TILE = 128
K_TILE_WORDS = 8
BLOCKS_PER_SM = 1
MAX_SPLIT = 8       # the splits of a tile are one cluster (portable size)

_LIB: list = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load("bitserial_matmul")
        lib.bitserial_matmul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.bitserial_matmul_launch.restype = ctypes.c_int
        lib.bitserial_error_string.argtypes = [ctypes.c_int]
        lib.bitserial_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """float/int (..., K) → int32 (..., K/32): bit = 1 ⇔ x ≥ 0 (+1; zero and
    −0.0 pack as +1, NaN as −1).  Bit ``e`` of word ``w`` is element
    ``32·w + e``."""
    *lead, k = x.shape
    assert k % WORD == 0
    bits = (x >= 0).to(torch.int64).reshape(*lead, k // WORD, WORD)
    lane = torch.arange(WORD, dtype=torch.int64, device=x.device)
    # distinct powers of two: the int64 sum is the OR; wrap bit 31 to int32
    words = (bits << lane).sum(-1)
    return (((words + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def unpack_signs(words: torch.Tensor) -> torch.Tensor:
    """int32 (..., K/32) sign-packed → int8 (..., K) of ±1 (the inverse of
    :func:`pack_signs` on ±1 inputs): bit ``e`` of word ``w`` is element
    ``32·w + e``, +1 where it is set."""
    *lead, kw = words.shape
    lane = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> lane) & 1
    return (bits.reshape(*lead, kw * WORD) * 2 - 1).to(torch.int8)


class LaunchPlan(NamedTuple):
    """The kernel's grid: ``tiles_n × tiles_m`` output tiles of TILE²,
    ``split`` blocks along K for each, ``tiles_per_split`` k-tiles of
    K_TILE_WORDS words each (the last split may have fewer)."""
    tiles_m: int
    tiles_n: int
    split: int
    tiles_per_split: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.split


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, kw: int, sms: int) -> LaunchPlan:
    """Split K only as far as needed to give every SM of ``sms`` about
    BLOCKS_PER_SM blocks, and at most MAX_SPLIT ways; every split has at
    least one k-tile.  The splits of a tile add their partial tiles in
    shared memory (one cluster a tile)."""
    tiles_m, tiles_n = -(-m // TILE), -(-n // TILE)
    k_tiles = -(-kw // K_TILE_WORDS)
    split = max(1, min(k_tiles, MAX_SPLIT,
                       BLOCKS_PER_SM * sms // (tiles_m * tiles_n)))
    per = -(-k_tiles // split)
    return LaunchPlan(tiles_m, tiles_n, -(-k_tiles // per), per)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(a: torch.Tensor, b: torch.Tensor, k_bits: int, bm: int, bn: int,
           bk: int) -> tuple[int, int, int, int]:
    """The operands' checks (written for a short host path: the kernel's
    call is host-bound at small shapes); returns (M, Kw, N, device index),
    the index −1 off CUDA."""
    if a.dtype is not torch.int32 or b.dtype is not torch.int32:
        raise TypeError(f"packed operands must be int32, got {a.dtype} and "
                        f"{b.dtype}")
    sa, sb = a.shape, b.shape
    if len(sa) != 2 or len(sb) != 2:
        raise ValueError(f"packed operands must be 2-D, got "
                         f"{tuple(sa)} and {tuple(sb)}")
    index = a.get_device()
    if index != b.get_device():
        raise ValueError(f"a on {a.device}, b on {b.device}")
    m, kw = sa
    n, kw2 = sb
    # the reference's assertions, with its TPU block shapes: each, capped
    # at its dimension (min), must divide it
    assert kw == kw2 and k_bits == kw * WORD
    assert (m % (bm if bm < m else m) == 0 and n % (bn if bn < n else n) == 0
            and kw % (bk if bk < kw else kw) == 0)
    # |out| <= K: int32 accumulation cannot overflow below 2**31
    assert k_bits < 2 ** 31
    return m, kw, n, index


def bitserial_matmul_plain(a_packed: torch.Tensor, b_packed: torch.Tensor,
                           k_bits: int) -> torch.Tensor:
    """Plain PyTorch version: :func:`~.ref.bitserial_matmul_ref` (a port of
    ``repro.kernels.ref.bitserial_matmul_ref``) over chunks of rows of
    ``a``, so the [rows, N, K/32] intermediate stays near a quarter of a GB
    (unchunked it is 3.3 GB at VGG-16 FC6)."""
    m, kw = a_packed.shape
    n = b_packed.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    step = max(1, _PLAIN_CHUNK // max(1, n * kw))
    for r in range(0, m, step):
        out[r:r + step] = bitserial_matmul_ref(a_packed[r:r + step], b_packed,
                                               k_bits)
    return out


def bitserial_matmul(a_packed: torch.Tensor, b_packed: torch.Tensor,
                     k_bits: int, bm: int = 128, bn: int = 128,
                     bk: int = 8) -> torch.Tensor:
    """a: int32[M, K/32] sign-packed; b: int32[N, K/32]; → int32[M, N]
    = K − 2·Σ popcount(a ⊕ b).

    ``bm``/``bn``/``bk`` are the reference's TPU block shapes: they are
    checked as the reference checks them (each, capped at its dimension,
    must divide it), but the CUDA kernel tiles as it chooses.  Each kernel
    launch adds one to ``bitserial_matmul.launches``.
    """
    m, kw, n, index = _check(a_packed, b_packed, k_bits, bm, bn, bk)
    if index < 0 or not a_packed.is_cuda:
        if a_packed.device.type == "cpu":
            return bitserial_matmul_plain(a_packed, b_packed, k_bits)
        raise ValueError(f"no XNOR-popcount kernel for device "
                         f"{a_packed.device}")
    a = a_packed.contiguous()
    b = b_packed.contiguous()
    out = a.new_empty((m, n))          # int32 on a's device
    if m == 0 or n == 0:
        return out
    split, per = launch_plan(m, n, kw, _sm_count(index))[2:]
    pa, pb = a.data_ptr(), b.data_ptr()
    # 16-byte copies where every row starts 16-byte aligned
    vec = 4 if kw % 4 == 0 and (pa | pb) % 16 == 0 else 1
    lib = _LIB[0] if _LIB else _lib()
    err = lib.bitserial_matmul_launch(
        pa, pb, out.data_ptr(), m, n, kw, split, per, vec, index,
        torch._C._cuda_getCurrentRawStream(index))   # the current stream
    if err:
        raise RuntimeError(f"bitserial_matmul launch failed: "
                           f"{lib.bitserial_error_string(err).decode()}")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0
