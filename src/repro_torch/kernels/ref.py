"""Plain PyTorch oracles of the main-path kernels, under the names of
``repro.kernels.ref``.  Each is the plain version that sits beside its
kernel; this module only gives them the reference's signatures."""
from __future__ import annotations

import torch

from .bitplane_transpose import GROUP, to_planes_plain
from .uprog_executor import uprog_execute_plain


def bitplane_transpose_ref(groups: torch.Tensor) -> torch.Tensor:
    """int32[G, 32] (element words, horizontal) → int32[32, G] bit-planes.

    out[i, g] bit e  ==  bit i of groups[g, e].
    """
    g, e = groups.shape
    assert e == GROUP
    return to_planes_plain(groups.reshape(g * GROUP), GROUP)


def uprog_maj_ref(rows: torch.Tensor, cmds: torch.Tensor) -> torch.Tensor:
    """Oracle for the μProgram executor kernel (rows int32[R, W], cmds
    int32[N, 4]; see :mod:`.uprog_executor`)."""
    return uprog_execute_plain(cmds, rows)
