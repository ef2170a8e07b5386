"""Linked CBR-AvgPool: the CUDA kernel's wrapper and its plain version.

``cbr_avgpool(x, w, b)`` computes ``avgpool2x2(relu(x @ w + b))`` for an
NHWC feature map ``x`` (N, H, W, C), a 1x1 conv weight ``w`` (C, OC) or
(1, 1, C, OC) and a bias ``b`` (OC,), giving (N, H // 2, W // 2, OC); an
odd H or W drops the last row or column, as the reference's VALID pooling
does.  For CUDA tensors it launches ``csrc/linked_cbr_pool.cu`` on the
current stream; for CPU tensors it runs :func:`cbr_avgpool_plain`.
Nothing on the CUDA path falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import check_launch, count_launch, library


def _weight_2d(w: torch.Tensor) -> torch.Tensor:
    """(1, 1, C, OC) conv weight -> its (C, OC) matrix."""
    if w.dim() == 4:
        if w.shape[:2] != (1, 1):
            raise ValueError("cbr_avgpool: a 4-d weight must be a 1x1 conv "
                             f"(1, 1, C, OC), got {tuple(w.shape)}")
        return w[0, 0]
    return w


def cbr_avgpool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    """The unlinked form in fp32: einsum, bias, ReLU, then the 2x2 average
    over the materialized pre-pool map."""
    w = _weight_2d(w)
    N, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    y = torch.relu(torch.einsum("nhwc,co->nhwo", x.float(), w.float())
                   + b.float())
    y = y[:, :2 * Ho, :2 * Wo].reshape(N, Ho, 2, Wo, 2, -1)
    return (y.sum(dim=(2, 4)) * 0.25).to(x.dtype)


def _entry():
    fn = library("linked_cbr_pool").repro_cbr_avgpool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cbr_avgpool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x (N,H,W,C); w (C,OC) or (1,1,C,OC); b (OC,) -> (N,H//2,W//2,OC).
    On CUDA all three must be contiguous float32 on one device."""
    if not x.is_cuda:
        return cbr_avgpool_plain(x, w, b)
    w = _weight_2d(w)
    tensors = (x, w, b)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("cbr_avgpool: x, w and b must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("cbr_avgpool: x, w and b must be float32, got "
                         f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != x.shape[3] \
            or b.shape != (w.shape[1],):
        raise ValueError("cbr_avgpool: want x (N,H,W,C), w (C,OC), b (OC,); "
                         f"got {tuple(x.shape)} {tuple(w.shape)} "
                         f"{tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cbr_avgpool: x (NHWC), w and b must be contiguous")
    N, H, W, C = x.shape
    OC = w.shape[1]
    out = torch.empty((N, H // 2, W // 2, OC), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   N, H, W, C, OC, stream)
    check_launch(err, "cbr_avgpool")
    count_launch("cbr_avgpool")
    return out
