"""Sobel edge losses (``rehrseg_tpu.models.sobel`` in PyTorch; reference
models/losses.py:6-23, which used kornia; dead code in the reference
pipeline but part of its API surface).

:func:`sobel_edges` is kornia.filters.sobel's spatial-gradient magnitude:
reflect padding, normalized kernels by default, on channels-last (B, H, W,
C) tensors as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sobel_kernels(normalized: bool = True):
    gx = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    gy = gx.T
    if normalized:
        gx = gx / np.abs(gx).sum()
        gy = gy / np.abs(gy).sum()
    return gx, gy


def sobel_edges(x: torch.Tensor, eps: float = 1e-6,
                normalized: bool = True) -> torch.Tensor:
    """Edge magnitude of (B, H, W, C) images, the nine taps summed in the
    JAX package's order."""
    gx_k, gy_k = _sobel_kernels(normalized)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="reflect").permute(0, 2, 3, 1)

    def corr(k):
        out = torch.zeros_like(x)
        for i in range(3):
            for j in range(3):
                out = out + float(k[i, j]) * xp[:, i:i + h, j:j + w]
        return out

    gx, gy = corr(gx_k), corr(gy_k)
    return torch.sqrt(gx * gx + gy * gy + eps)


def sobel_l1_loss(pred, target):
    """L1 between edge maps (reference GetSobel semantics)."""
    return torch.mean(torch.abs(sobel_edges(pred) - sobel_edges(target)))


def sobel_mse_loss(pred, target):
    return torch.mean((sobel_edges(pred) - sobel_edges(target)) ** 2)
