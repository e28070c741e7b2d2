"""The transposition unit (paper §5.1): element words ⇄ vertical bit-planes.

``to_planes`` turns int32[E] element words (E a multiple of 32) into
int32[n_bits, E/32] LSB-first bit-planes: bit ``e`` of plane word
``planes[i, g]`` is bit ``i`` of element ``32·g + e``.  ``from_planes`` is
the inverse, sign-extending from bit ``n_bits − 1`` when asked.  On a CUDA
tensor each launches its hand-written kernel in
``csrc/bitplane_transpose.cu`` (one warp per 32-element group: a 5-stage
shuffle network to planes, n_bits steps a lane from planes); on a CPU
tensor each runs its plain PyTorch version.  :func:`bitplane_transpose` is the 32×32 transpose with the
signature of ``repro.kernels.bitplane_transpose``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

GROUP = 32          # elements per transpose group (= bits per word)

_LIB: list = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load("bitplane_transpose")
        lib.bitplane_to_planes_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.bitplane_to_planes_launch.restype = ctypes.c_int
        lib.bitplane_from_planes_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.bitplane_from_planes_launch.restype = ctypes.c_int
        lib.bitplane_error_string.argtypes = [ctypes.c_int]
        lib.bitplane_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().bitplane_error_string(err).decode()}")


def _check_bits(n_bits: int) -> None:
    if not 0 <= n_bits <= GROUP:
        raise ValueError(f"n_bits must be in [0, {GROUP}], got {n_bits}")


def _cuda_launch_args(t: torch.Tensor) -> tuple[int, int]:
    if t.device.type != "cuda":
        raise ValueError(f"no transposition kernel for device {t.device}")
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


# -- plain versions -----------------------------------------------------------

def to_planes_plain(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`to_planes` (a port of
    ``repro.simdram.layout.to_bitplanes``)."""
    (e,) = values.shape
    shifts = torch.arange(n_bits, dtype=torch.int32, device=values.device)
    bits = (values[None, :] >> shifts[:, None]) & 1
    bits = bits.reshape(n_bits, e // GROUP, GROUP).to(torch.int64)
    lane = torch.arange(GROUP, dtype=torch.int64, device=values.device)
    # distinct powers of two: the int64 sum is the OR; the cast wraps bit 31
    return (bits << lane).sum(-1).to(torch.int32)


def from_planes_plain(planes: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`from_planes` (a port of
    ``repro.simdram.layout.from_bitplanes``)."""
    n_bits, w = planes.shape
    lane = torch.arange(GROUP, dtype=torch.int32, device=planes.device)
    bits = ((planes[:, :, None] >> lane) & 1).reshape(n_bits, w * GROUP)
    weights = torch.arange(n_bits, dtype=torch.int64, device=planes.device)
    val = (bits.to(torch.int64) << weights[:, None]).sum(0)
    if signed and 0 < n_bits < GROUP:
        val = val - (((val >> (n_bits - 1)) & 1) << n_bits)
    return val.to(torch.int32)


# -- wrappers -----------------------------------------------------------------

def to_planes(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32[E] element words → int32[n_bits, E/32] bit-planes (E % 32 == 0).

    Each kernel launch adds one to ``to_planes.launches``."""
    _check_bits(n_bits)
    if values.dtype != torch.int32 or values.dim() != 1:
        raise TypeError(f"values must be int32[E], got {values.dtype} "
                        f"{tuple(values.shape)}")
    (e,) = values.shape
    if e % GROUP:
        raise ValueError(f"element count {e} is not a multiple of {GROUP}")
    if values.device.type == "cpu":
        return to_planes_plain(values, n_bits)
    device, stream = _cuda_launch_args(values)
    values = values.contiguous()
    groups = e // GROUP
    out = torch.empty((n_bits, groups), dtype=torch.int32,
                      device=values.device)
    if groups == 0 or n_bits == 0:
        return out
    _raise_on(_lib().bitplane_to_planes_launch(
        values.data_ptr(), out.data_ptr(), groups, n_bits, device, stream),
        "bitplane_to_planes")
    to_planes.launches += 1
    return out


def from_planes(planes: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """int32[n_bits, W] bit-planes → int32[32·W] element values,
    sign-extended from bit ``n_bits − 1`` when ``signed`` and n_bits < 32.

    Each kernel launch adds one to ``from_planes.launches``."""
    if planes.dtype != torch.int32 or planes.dim() != 2:
        raise TypeError(f"planes must be int32[n_bits, W], got {planes.dtype} "
                        f"{tuple(planes.shape)}")
    n_bits, w = planes.shape
    _check_bits(n_bits)
    if planes.device.type == "cpu":
        return from_planes_plain(planes, signed)
    device, stream = _cuda_launch_args(planes)
    planes = planes.contiguous()
    if w == 0 or n_bits == 0:
        return torch.zeros(w * GROUP, dtype=torch.int32, device=planes.device)
    out = torch.empty(w * GROUP, dtype=torch.int32, device=planes.device)
    _raise_on(_lib().bitplane_from_planes_launch(
        planes.data_ptr(), out.data_ptr(), w, n_bits, int(signed), device,
        stream), "bitplane_from_planes")
    from_planes.launches += 1
    return out


to_planes.launches = 0
from_planes.launches = 0


def bitplane_transpose(groups: torch.Tensor) -> torch.Tensor:
    """int32[G, 32] element words → int32[32, G] bit-planes: bit e of
    ``out[i, g]`` is bit i of ``groups[g, e]`` (its own inverse)."""
    g, e = groups.shape
    if e != GROUP:
        raise ValueError(f"groups must be [G, {GROUP}], got {tuple(groups.shape)}")
    return to_planes(groups.reshape(g * GROUP), GROUP)
