"""One-token GQA attention over a KV cache: ``decode_attention``.

q (B, 1, H, hd) attends over k/v (B, T, KV, hd), the cache as the models
layer holds it, H a multiple of KV.  Causal, the query sits at position
``q_offset`` (a host int, or an int64 device tensor of shape (1,), a CUDA
graph's position) and sees the keys up to it; otherwise all T keys.

On a CUDA tensor it launches the hand-written kernel in
``csrc/decode_attention.cu``: a split-KV pass, one float32 partial a warp's
share of the written keys, and a combine pass.  It replaces no Pallas kernel
(the reference attends with ``jnp`` einsums); it was added because the
eager einsums over a (B, T, KV, hd) cache copy K and V over the whole cache
every layer and step (ROADMAP D.6).  Its bound is the bytes of the written
K/V rows, 2·B·len·KV·hd·2 read once.  On a CPU tensor it runs its plain
version, :func:`decode_attention_plain`: the models layer's plain attention
(``layers._sdpa_naive``) itself.  Under autograd it raises: its output has
no gradient.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from .. import telemetry
from . import _build

WARPS = 4                 # warps a block (csrc: kWarps)
MAX_Q_PER_WARP = 8        # queries a warp holds at most
WAVES_BLOCKS_PER_SM = 8   # key splits fill about this many blocks an SM
MIN_KEYS_PER_WARP = 32    # ... but give each warp at least this many keys
DTYPE = torch.bfloat16

_LIB: list = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load("decode_attention")
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclass(frozen=True)
class Plan:
    """How a call's work falls to warps and blocks, from shapes alone (so a
    CUDA graph's one recording serves every position)."""
    lanes_per_key: int    # lanes holding one key row, 8 elements a lane
    q_slices: int         # warps of a block splitting a KV head's queries
    k_slices: int         # warps of a block splitting its keys
    q_per_warp: int       # queries a warp holds (1, 2, 4 or 8)
    q_groups: int         # blocks along a KV head's queries
    splits: int           # blocks along the keys

    @property
    def n_parts(self) -> int:
        """Float32 partials a head: one a warp along the keys."""
        return self.splits * self.k_slices


def plan(b: int, kv: int, g: int, t: int, hd: int, sms: int) -> Plan:
    """The plan for ``b`` sequences of ``kv`` KV heads of ``g`` queries over
    a cache of ``t`` positions of ``hd`` on a card of ``sms`` SMs: warps
    split the queries where there are 4 or more a KV head, else the keys;
    the keys split until about ``WAVES_BLOCKS_PER_SM`` blocks an SM (two
    waves or more at the blocks a Hopper SM holds), each warp keeping
    ``MIN_KEYS_PER_WARP`` keys or more of a full cache."""
    q_slices = 4 if g >= 4 else 2 if g >= 2 else 1
    k_slices = WARPS // q_slices
    per_slice = -(-g // q_slices)
    q_groups = -(-per_slice // MAX_Q_PER_WARP)
    q_per_warp = _pow2(-(-per_slice // q_groups))
    rows = b * kv * q_groups
    splits = max(1, min(-(-WAVES_BLOCKS_PER_SM * sms // rows),
                        -(-t // (MIN_KEYS_PER_WARP * k_slices))))
    return Plan(_pow2(hd // 8), q_slices, k_slices, q_per_warp, q_groups,
                splits)


def decode_attention_plain(q, k, v, causal: bool = True, q_offset=0):
    """Plain PyTorch version of :func:`decode_attention`: the models layer's
    plain attention, ``layers._sdpa_naive`` (its scores rounded to the
    input's type, its softmax in float32)."""
    from ..models.layers import _sdpa_naive    # layers imports this module
    return _sdpa_naive(q, k, v, causal, q_offset)


def _check(q, k, v, q_offset) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, T, KV, hd) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads over {k.shape[2]} KV heads")
    if q.dtype != DTYPE or k.dtype != DTYPE or v.dtype != DTYPE:
        raise TypeError(f"decode attention takes bf16, got q {q.dtype}, k "
                        f"{k.dtype}, v {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("decode attention has no backward: call it under "
                           "torch.no_grad() or on tensors without grad")
    if hd % 8 or hd > 256:
        raise ValueError(f"head size {hd}: a multiple of 8 up to 256")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1 or x.stride(2) != hd:
            raise ValueError(f"{name}'s last two dimensions must be "
                             f"contiguous, strides {x.stride()}")
        # rows start on 16 bytes (q's one position has no stride to keep)
        if x.data_ptr() % 16 or x.stride(0) % 8 or (x is not q
                                                    and x.stride(1) % 8):
            raise ValueError(f"{name}'s rows are not 16-byte aligned")
    if torch.is_tensor(q_offset) and (
            q_offset.device != q.device or q_offset.dtype != torch.int64
            or q_offset.numel() != 1):
        raise ValueError("a device position is an int64 tensor of one "
                         f"element on {q.device}")


def decode_attention(q, k, v, causal: bool = True, q_offset=0):
    """Attention of one query a head over a cache (see the module).  A CPU
    call runs the plain version; a CUDA call launches the kernel or raises
    on what it does not take: another type than bf16, hd not a multiple of
    8 up to 256, H not a multiple of KV, the last two dimensions of q, k or
    v not contiguous, or inputs that require grad while grad is on.  Each
    launch adds one to ``decode_attention.launches`` and to the counter
    ``kernels.decode_attn``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, causal, q_offset)
    _check(q, k, v, q_offset)
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    dev = q.device
    p = plan(b, kv, h // kv, t, hd,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    part_ml = torch.empty((b, h, p.n_parts, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b, h, p.n_parts, hd), dtype=torch.float32,
                           device=dev)
    if not causal:
        pos, base = None, t
    elif torch.is_tensor(q_offset):
        pos, base = q_offset.data_ptr(), 1
    else:
        pos, base = None, int(q_offset) + 1
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), pos, base, t,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), b, h, kv, hd, p.lanes_per_key, p.q_slices, p.k_slices,
        p.q_per_warp, p.q_groups, p.splits, 1.0 / math.sqrt(hd), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = _lib().decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg}")
    decode_attention.launches += 1
    telemetry.count("kernels.decode_attn")
    return out


decode_attention.launches = 0
