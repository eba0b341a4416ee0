"""Linear z-upsampling for the SR head (subset of ``rehrseg_tpu.ops.bspline``).

The SegModel SR head upsamples its features along the through-plane axis
with ``F.interpolate(mode='trilinear', align_corners=True)`` semantics
(reference seg_model.py:204). As in the JAX package this is a precomputed
(m, n) interpolation matrix applied as a matmul along one axis.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=128)
def trilinear_upsample_matrix(n: int, scale: int,
                              align_corners: bool = True) -> np.ndarray:
    """(n*scale, n) linear-interp matrix for upsampling one axis.

    align_corners=True: out coord j maps to j * (n-1) / (m-1).
    """
    m = n * scale
    M = np.zeros((m, n), dtype=np.float64)
    if n == 1:
        M[:, 0] = 1.0
        M.setflags(write=False)
        return M
    for j in range(m):
        if align_corners:
            pos = j * (n - 1) / (m - 1)
        else:
            pos = (j + 0.5) / scale - 0.5
            pos = min(max(pos, 0.0), n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        t = pos - lo
        M[j, lo] += 1.0 - t
        M[j, hi] += t
    M.setflags(write=False)
    return M


def upsample_axis_linear(x: torch.Tensor, scale: int, axis: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Linear upsample of one axis of ``x`` by an integer factor."""
    if scale == 1:
        return x
    n = x.shape[axis]
    M = torch.tensor(trilinear_upsample_matrix(n, scale, align_corners),
                     dtype=x.dtype, device=x.device)
    moved = torch.movedim(x, axis, -1)
    out = torch.matmul(moved, M.t())
    return torch.movedim(out, -1, axis)
