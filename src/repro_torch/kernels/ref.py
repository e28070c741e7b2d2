"""Plain PyTorch oracles of the kernels, under the names of
``repro.kernels.ref``.  The FSM and transposition oracles are the plain
versions that sit beside their kernels; this module only gives them the
reference's signatures.  The XNOR-popcount oracle lives here, and the
plain version of its kernel runs it chunk by chunk."""
from __future__ import annotations

import torch

from .bitplane_transpose import GROUP, to_planes_plain
from .uprog_executor import uprog_execute_plain


def popcount_ref(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 words read as unsigned (bit 31 counts) →
    int32.  Runs in int64 on the low 32 bits, so no shift fills sign bits
    and no step overflows."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def bitplane_transpose_ref(groups: torch.Tensor) -> torch.Tensor:
    """int32[G, 32] (element words, horizontal) → int32[32, G] bit-planes.

    out[i, g] bit e  ==  bit i of groups[g, e].
    """
    g, e = groups.shape
    assert e == GROUP
    return to_planes_plain(groups.reshape(g * GROUP), GROUP)


def bitserial_matmul_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                         k_bits: int) -> torch.Tensor:
    """XNOR-net matmul oracle over sign-packed operands.

    a_packed: int32[M, K/32], b_packed: int32[N, K/32]; bit=1 encodes +1,
    bit=0 encodes −1.  Returns int32[M, N] = Σ_k a_k·b_k = K − 2·popc(a⊕b).
    """
    x = a_packed[:, None, :] ^ b_packed[None, :, :]
    mismatches = popcount_ref(x).sum(-1)
    return (k_bits - 2 * mismatches).to(torch.int32)


def uprog_maj_ref(rows: torch.Tensor, cmds: torch.Tensor) -> torch.Tensor:
    """Oracle for the μProgram executor kernel (rows int32[R, W], cmds
    int32[N, 4]; see :mod:`.uprog_executor`)."""
    return uprog_execute_plain(cmds, rows)
