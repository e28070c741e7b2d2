"""Pass plane-resident state between the port and numpy (and through numpy
to the reference package): a :class:`BitplaneArray` is its uint32 plane
words plus ``(n_bits, length, signed)``."""
from __future__ import annotations

import numpy as np
import torch

from .simdram.layout import BitplaneArray


def bitplanes_from_numpy(planes_u32: np.ndarray, n_bits: int, length: int,
                         signed: bool = False,
                         device: str | torch.device = "cuda") -> BitplaneArray:
    """uint32 planes (``[n_bits, W]`` or ``[banks, n_bits, W]``) → the port's
    :class:`BitplaneArray` on ``device`` (int32 words, same bits)."""
    p = np.ascontiguousarray(planes_u32, dtype=np.uint32).view(np.int32)
    return BitplaneArray(torch.from_numpy(p.copy()).to(device), n_bits,
                         length, signed)


def bitplanes_to_numpy(arr: BitplaneArray) -> tuple[np.ndarray, int, int, bool]:
    """Inverse of :func:`bitplanes_from_numpy`: ``(planes_u32, n_bits,
    length, signed)``."""
    planes = arr.planes.detach().cpu().contiguous().numpy().view(np.uint32)
    return planes.copy(), arr.n_bits, arr.length, arr.signed
