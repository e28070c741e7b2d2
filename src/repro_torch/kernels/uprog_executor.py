"""The control-unit FSM (paper Fig. 7): a command stream over a row file.

``uprog_execute`` runs an encoded command stream (int32[N, 4], see
:mod:`repro_torch.core.trace`) over a row file of int32 plane words,
``[R, W]`` or banked ``[banks, R, W]``:

    (op, a, b, c)
    op = 0: COPY  row|a| ← read(b)
    op = 1: MAJ   rows |a|,|b|,|c| ← MAJ(read(a),read(b),read(c))

Rows are 1-based; a negative index reads or writes the complement (the
dual-contact-cell port); the MAJ result is written to a, then b, then c.
On a CUDA tensor it launches the hand-written kernel in
``csrc/uprog_executor.cu`` (banks folded into the word axis, one launch);
on a CPU tensor it runs :func:`uprog_execute_plain`, a Python loop over the
commands.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_MAX_ROWS: dict[int, int] = {}
_LIB: list = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load("uprog_executor")
        lib.uprog_max_rows.argtypes = [ctypes.c_int]
        lib.uprog_max_rows.restype = ctypes.c_int
        lib.uprog_execute_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.uprog_execute_launch.restype = ctypes.c_int
        lib.uprog_error_string.argtypes = [ctypes.c_int]
        lib.uprog_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_cmds(cmds, n_rows: int) -> None:
    """Reject a command stream the FSM cannot run on ``n_rows`` rows: a bad
    shape, an opcode other than 0/1, or a row index of 0 or beyond
    ``n_rows`` (the Pallas kernel would read ``rows[-1]`` for index 0)."""
    c = np.asarray(cmds.cpu() if isinstance(cmds, torch.Tensor) else cmds)
    if c.ndim != 2 or c.shape[1] != 4:
        raise ValueError(f"commands must be int32[N, 4], got {c.shape}")
    if c.size == 0:
        return
    if not np.isin(c[:, 0], (0, 1)).all():
        raise ValueError("command opcodes must be 0 (COPY) or 1 (MAJ)")
    idx = np.abs(c[:, 1:].astype(np.int64))
    if (idx == 0).any():
        t = int(np.argwhere(idx == 0)[0][0])
        raise ValueError(f"command {t} {c[t].tolist()} names row 0; rows are "
                         "1-based and index 0 is reserved")
    if idx.max() > n_rows:
        raise ValueError(f"command row index {int(idx.max())} is beyond the "
                         f"{n_rows}-row file")


def uprog_execute_plain(cmds: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a port of ``repro.kernels.ref.uprog_maj_ref``,
    one Python step per command on a copy of the row file."""
    check_cmds(cmds, rows.shape[-2])
    banked = rows.dim() == 3
    # [R, banks·W]: every row a contiguous vector over all columns
    r = (rows.transpose(0, 1).reshape(rows.shape[1], -1) if banked
         else rows).clone()

    def read(i):
        return ~r[-i - 1] if i < 0 else r[i - 1]

    def write(i, v):
        if i < 0:
            r[-i - 1] = ~v
        else:
            r[i - 1] = v

    for op, a, b, c in cmds.tolist():
        if op == 1:
            va, vb, vc = read(a), read(b), read(c)
            maj = (va & vb) | (va & vc) | (vb & vc)
            write(a, maj)
            write(b, maj)
            write(c, maj)
        else:
            write(a, read(b))
    if banked:
        return r.reshape(rows.shape[1], rows.shape[0], -1).transpose(0, 1) \
            .contiguous()
    return r


def max_rows(device: torch.device) -> int:
    """The largest row file the kernel stages on CUDA ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _MAX_ROWS:
        _MAX_ROWS[index] = _lib().uprog_max_rows(index)
    return _MAX_ROWS[index]


def uprog_execute(cmds: torch.Tensor, rows: torch.Tensor,
                  check: bool = True) -> torch.Tensor:
    """Run ``cmds`` (int32[N, 4]) over ``rows`` (int32[R, W] or
    [banks, R, W]); returns the final row file (a new tensor).

    ``check=False`` skips :func:`check_cmds`, for callers that validated
    this command stream already (it costs a device-to-host copy of the
    commands on a CUDA tensor).  Each kernel launch adds one to
    ``uprog_execute.launches``.
    """
    if rows.dtype != torch.int32 or cmds.dtype != torch.int32:
        raise TypeError(f"rows and cmds must be int32, got {rows.dtype} and "
                        f"{cmds.dtype}")
    if rows.dim() not in (2, 3):
        raise ValueError(f"rows must be [R, W] or [banks, R, W], got "
                         f"{tuple(rows.shape)}")
    if cmds.device != rows.device:
        raise ValueError(f"cmds on {cmds.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return uprog_execute_plain(cmds, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no FSM kernel for device {rows.device}")
    if check:
        check_cmds(cmds, rows.shape[-2])
    if not (rows.is_contiguous() and cmds.is_contiguous()):
        raise ValueError("rows and cmds must be contiguous")
    if cmds.dim() != 2 or cmds.shape[1] != 4 or cmds.data_ptr() % 16:
        raise ValueError("cmds must be a 16-byte aligned int32[N, 4]")
    n_rows, words = rows.shape[-2], rows.shape[-1]
    columns = rows.numel() // max(1, n_rows)
    out = torch.empty_like(rows)
    if columns == 0 or n_rows == 0:
        return out.copy_(rows)
    limit = max_rows(rows.device)
    if n_rows > limit:
        raise ValueError(f"row file of {n_rows} rows exceeds the {limit} rows "
                         "one block of the FSM kernel can stage in shared "
                         "memory")
    lib = _lib()
    stream = torch.cuda.current_stream(rows.device)
    err = lib.uprog_execute_launch(
        cmds.data_ptr(), cmds.shape[0], rows.data_ptr(), out.data_ptr(),
        n_rows, words, columns, rows.device.index, stream.cuda_stream)
    if err:
        raise RuntimeError(f"uprog_execute launch failed: "
                           f"{lib.uprog_error_string(err).decode()}")
    uprog_execute.launches += 1
    return out


uprog_execute.launches = 0
