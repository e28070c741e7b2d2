"""XNOR-NET binarized matmul: the compute hot-spot of the paper's
application suite (XNOR-NET VGG/LeNet, kNN distances, BitWeaving scans).

Both operands are sign-packed, 32 values a word (bit 1 = +1, bit 0 = −1),
and the inner product of two packed rows is ``K − 2·popcount(a ⊕ b)``.
:func:`pack_signs` packs; :func:`bitserial_matmul` contracts int32[M, K/32]
with int32[N, K/32] into int32[M, N].  On a CUDA tensor it launches the
hand-written kernel in ``csrc/bitserial_matmul.cu`` (a 64 × 64 output tile
a block, ``__popc`` over shared-memory chunks of K); on a CPU tensor it
runs :func:`bitserial_matmul_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import bitserial_matmul_ref

WORD = 32           # packed values per word
# elements of the [rows, N, K/32] intermediate the plain version builds at
# once (int64 popcounts: ~0.25 GB a chunk)
_PLAIN_CHUNK = 1 << 25

_LIB: list = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load("bitserial_matmul")
        lib.bitserial_matmul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
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


def _check(a: torch.Tensor, b: torch.Tensor, k_bits: int, bm: int, bn: int,
           bk: int) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"packed operands must be int32, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"packed operands must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    m, kw = a.shape
    n, kw2 = b.shape
    # the reference's assertions, with its TPU block shapes
    assert kw == kw2 and k_bits == kw * WORD
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, kw)
    assert m % bm == 0 and n % bn == 0 and kw % bk == 0
    # |out| <= K: int32 accumulation cannot overflow below 2**31
    assert k_bits < 2 ** 31


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
    _check(a_packed, b_packed, k_bits, bm, bn, bk)
    if a_packed.device.type == "cpu":
        return bitserial_matmul_plain(a_packed, b_packed, k_bits)
    if a_packed.device.type != "cuda":
        raise ValueError(f"no XNOR-popcount kernel for device "
                         f"{a_packed.device}")
    a = a_packed.contiguous()
    b = b_packed.contiguous()
    m, kw = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(a.device)
    err = lib.bitserial_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, kw, k_bits,
        a.device.index, stream.cuda_stream)
    if err:
        raise RuntimeError(f"bitserial_matmul launch failed: "
                           f"{lib.bitserial_error_string(err).decode()}")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0
