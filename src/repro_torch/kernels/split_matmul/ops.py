"""DOS parameter-split matmul: the CUDA kernel's wrapper and its plain
version.

``split_matmul(x, w, b, block_n=..., block_k=...)`` computes ``x @ w + b``
for x (M, K), w (K, N), b (N,) with w cut into (block_k, block_n) tiles,
with the Pallas kernel's arithmetic: N tiles (the paper's output-channel
split) are independent; K tiles (the inC split) accumulate in order, in
fp32, with the bias added to the first tile's product.  For CUDA tensors
it launches ``csrc/split_matmul.cu`` on the current stream; for CPU
tensors it runs :func:`split_matmul_plain`.  Nothing on the CUDA path
falls back to the plain version, and ragged shapes are masked in the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import check_launch, count_launch, library


def split_matmul_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       block_n: int, block_k: int) -> torch.Tensor:
    """Tile by tile in fp32: each N tile's K tiles summed in order, the
    bias added at the first; the N tiles concatenated."""
    xf, wf, bf = x.float(), w.float(), b.float()
    K, N = wf.shape
    cols = []
    for n0 in range(0, N, block_n):
        n1 = min(N, n0 + block_n)
        acc = None
        for k0 in range(0, K, block_k):
            part = xf[:, k0:k0 + block_k] @ wf[k0:k0 + block_k, n0:n1]
            acc = part + bf[n0:n1] if acc is None else acc + part
        cols.append(acc)
    return torch.cat(cols, dim=1).to(x.dtype)


def _entry():
    fn = library("split_matmul").repro_split_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 block_n: int, block_k: int) -> torch.Tensor:
    """x (M, K); w (K, N); b (N,) -> (M, N).  On CUDA all three must be
    contiguous float32 on one device."""
    if block_n < 1 or block_k < 1:
        raise ValueError(f"split_matmul: block_n ({block_n}) and block_k "
                         f"({block_k}) must be positive")
    if not x.is_cuda:
        return split_matmul_plain(x, w, b, block_n, block_k)
    tensors = (x, w, b)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("split_matmul: x, w and b must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("split_matmul: x, w and b must be float32, got "
                         f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or b.shape != (w.shape[1],) or x.shape[1] == 0:
        raise ValueError("split_matmul: want x (M,K), w (K,N), b (N,) with "
                         f"K > 0; got {tuple(x.shape)} {tuple(w.shape)} "
                         f"{tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("split_matmul: x, w and b must be contiguous")
    (M, K), N = x.shape, w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                   M, N, K, block_n, block_k, stream)
    check_launch(err, "split_matmul")
    count_launch("split_matmul")
    return y
