"""B-spline resizes and linear z-upsampling as precomputed matrices (the
port's own copy of ``rehrseg_tpu.ops.bspline``).

A resize along one axis is a dense (m, n) matrix ``M`` built on the host
(cached), so that ``out = M @ x``:

  - :func:`resize_matrix`: the rational B-spline resize of the reference's
    ``resize`` package (output length ``round(n / dx)``, the two sample grids
    sharing the field of view's centre, order 0 nearest or 3 cubic with
    scipy's mirror-boundary prefilter), built by scipy's
    ``map_coordinates`` on unit vectors; :func:`resize_1d` applies it as a
    matmul (WDSR's fractional pre-resize, the stage-1 LR simulation),
    :func:`resize_nd` / :func:`resize_nd_np` along each trailing dim;
  - :func:`trilinear_upsample_matrix`: the SegModel SR head's
    ``F.interpolate(mode='trilinear', align_corners=True)`` along z
    (reference seg_model.py:204).

scipy is imported only where a resize matrix or a zoom is built.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch


def output_size(n: int, dx: float) -> int:
    """Output length for sampling step ``dx`` (``resize``'s round)."""
    return int(round(n / float(dx)))


def sample_coords(n: int, dx: float) -> np.ndarray:
    """Output sample coordinates in input-index units: the m output samples
    have spacing dx and share the field of view's centre (n-1)/2 with the
    input grid 0..n-1."""
    m = output_size(n, dx)
    j = np.arange(m, dtype=np.float64)
    return (n - 1) / 2.0 + (j - (m - 1) / 2.0) * float(dx)


@lru_cache(maxsize=256)
def resize_matrix(n: int, dx_frac: Fraction, order: int = 3) -> np.ndarray:
    """(m, n) matrix of the 1-D resize ``out = M @ x``. ``dx_frac`` is exact
    and hashable (:func:`as_fraction`). order 0 = nearest, 1 / 3 = spline
    with mirror boundary (scipy.ndimage conventions)."""
    from scipy.ndimage import map_coordinates

    coords = sample_coords(n, float(dx_frac))
    M = np.zeros((coords.shape[0], n), dtype=np.float64)
    eye = np.eye(n, dtype=np.float64)
    for k in range(n):
        # the interpolation is linear in the input: column k is the
        # interpolated unit vector k
        M[:, k] = map_coordinates(eye[k], [coords], order=order,
                                  mode="mirror")
    M.setflags(write=False)
    return M


def as_fraction(dx: float, max_den: int = 10000) -> Fraction:
    return Fraction(dx).limit_denominator(max_den)


def resize_1d_np(x: np.ndarray, dx: float, axis: int,
                 order: int = 3) -> np.ndarray:
    """Host resize of ``x`` along ``axis`` (numpy)."""
    if float(dx) == 1.0:
        return x
    M = resize_matrix(x.shape[axis], as_fraction(dx), order)
    return np.moveaxis(np.tensordot(M, np.moveaxis(x, axis, 0),
                                    axes=(1, 0)), 0, axis)


def resize_nd_np(x: np.ndarray, dxyz, order: int = 3) -> np.ndarray:
    """Host resize of the trailing ``len(dxyz)`` dims, one step per dim
    (the ``resize`` package's convention; the reference applies (sep, 1)
    to the last two dims, train_set.py:395)."""
    out = x
    for i, dx in enumerate(dxyz):
        out = resize_1d_np(out, dx, x.ndim - len(dxyz) + i, order)
    return out


def resize_1d(x: torch.Tensor, dx: float, axis: int,
              order: int = 3) -> torch.Tensor:
    """Resize of a tensor along ``axis``: one matmul with the (cached) host
    matrix, in ``x``'s dtype on ``x``'s device."""
    if float(dx) == 1.0:
        return x
    M = torch.tensor(resize_matrix(x.shape[axis], as_fraction(dx), order),
                     dtype=x.dtype, device=x.device)
    out = torch.matmul(torch.movedim(x, axis, -1), M.t())
    return torch.movedim(out, -1, axis)


def resize_nd(x: torch.Tensor, dxyz, order: int = 3) -> torch.Tensor:
    """:func:`resize_nd_np` on a tensor: :func:`resize_1d` along each of
    the trailing ``len(dxyz)`` dims."""
    out = x
    for i, dx in enumerate(dxyz):
        out = resize_1d(out, dx, x.ndim - len(dxyz) + i, order)
    return out


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


def zoom_axis_np(x: np.ndarray, factor: float, axis: int,
                 order: int) -> np.ndarray:
    """``scipy.ndimage.zoom`` along one axis (the pseudo-SR interpolation
    fallback, reference sr_utils.py:263-264)."""
    from scipy.ndimage import zoom

    factors = [1.0] * x.ndim
    factors[axis] = factor
    return zoom(x, factors, order=order)
