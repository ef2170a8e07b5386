"""Linked SwiGLU MLP: the CUDA kernel's wrapper and its plain version.

``linked_mlp(x, wg, wu, wd)`` computes ``(silu(x @ wg) * (x @ wu)) @ wd``
for x (..., d), wg and wu (d, ff), wd (ff, d), with the Pallas body's
arithmetic: both up-projections accumulate in fp32, the hidden activation
h is rounded to x's dtype before the down-projection, and the
down-projection accumulates in fp32 and is cast to x's dtype once.  (The
Pallas kernel accumulates y in the output block's dtype, rounding every
ff block's partial sum in bf16; the port accumulates in fp32.)  For CUDA
tensors it launches ``csrc/linked_mlp.cu`` on the current stream, which
keeps h on chip; for CPU tensors it runs :func:`linked_mlp_plain`.
Nothing on the CUDA path falls back to the plain version, and ragged M,
d and ff are masked in the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import check_launch, count_launch, library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def linked_mlp_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor) -> torch.Tensor:
    """The unlinked form: fp32 up-projections, h rounded to x's dtype,
    fp32 down-projection, one cast at the end."""
    xf = x.float()
    h = (F.silu(xf @ wg.float()) * (xf @ wu.float())).to(x.dtype)
    return (h.float() @ wd.float()).to(x.dtype)


def _lib():
    lib = library("linked_mlp")
    if lib.repro_linked_mlp.argtypes is None:
        lib.repro_linked_mlp.argtypes = [ctypes.c_int] + \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_linked_mlp.restype = ctypes.c_int
        lib.repro_linked_mlp_splits.argtypes = [ctypes.c_int] * 4 + \
            [ctypes.c_void_p] * 3
        lib.repro_linked_mlp_splits.restype = ctypes.c_int
    return lib


def linked_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """x (..., d); wg/wu (d, ff); wd (ff, d) -> (..., d) in x's dtype.  On
    CUDA all four must be contiguous, of one dtype (float32 or bfloat16),
    on one device."""
    if not x.is_cuda:
        return linked_mlp_plain(x, wg, wu, wd)
    tensors = (x, wg, wu, wd)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("linked_mlp: x, wg, wu and wd must lie on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("linked_mlp: x, wg, wu and wd must share float32 or "
                         f"bfloat16, got {x.dtype}/{wg.dtype}/{wu.dtype}/"
                         f"{wd.dtype}")
    d = x.shape[-1] if x.dim() else -1
    ff = wg.shape[1] if wg.dim() == 2 else -1
    if x.dim() < 1 or wg.shape != (d, ff) or wu.shape != (d, ff) \
            or wd.shape != (ff, d):
        raise ValueError("linked_mlp: want x (..., d), wg/wu (d, ff), wd "
                         f"(ff, d); got {tuple(x.shape)} {tuple(wg.shape)} "
                         f"{tuple(wu.shape)} {tuple(wd.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linked_mlp: x, wg, wu and wd must be contiguous")
    out = torch.empty_like(x)
    M = x.numel() // d if d > 0 else 0
    if M == 0 or d == 0 or ff == 0:
        return out.zero_()
    lib = _lib()
    code = _DTYPE_CODE[x.dtype]
    S = lib.repro_linked_mlp_splits(code, M, d, ff, wg.data_ptr(),
                                    wu.data_ptr(), wd.data_ptr())
    if S <= 0:
        raise ValueError(f"linked_mlp: d = {d} does not fit one row's x tile "
                         "and partial y in shared memory")
    part = torch.empty((S, M, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_linked_mlp(
        code, x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        part.data_ptr(), out.data_ptr(), M, d, ff, S, stream)
    check_launch(err, "linked_mlp")
    count_launch("linked_mlp")
    return out
