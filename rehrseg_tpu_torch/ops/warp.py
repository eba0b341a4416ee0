"""2D spatial warping with exact cubic B-spline interpolation
(``rehrseg_tpu.ops.warp`` in PyTorch), the spatial half of the device
augmentation.

  - the cubic-spline prefilter is a precomputed (n, n) matrix (mirror
    boundary, scipy.ndimage.spline_filter1d to machine precision), applied
    as two matmuls;
  - evaluation at warped coordinates gathers the 4x4 coefficient
    neighbourhood with cubic B-spline weights (map_coordinates order=3,
    mirror boundary), labels bilinear (order 1) with >= 0.5 thresholding.

Batched: images (B, C, H, W) sampled at per-sample coordinates (B, 2, P,
Q); a single (H, W) image with (2, P, Q) coordinates (the JAX functions'
form) works as well.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def prefilter_matrix(n: int) -> np.ndarray:
    """(n, n) cubic-spline prefilter with mirror boundary: P @ x equals
    scipy.ndimage.spline_filter1d(x, order=3, mode='mirror')."""
    from scipy.ndimage import spline_filter1d
    return spline_filter1d(np.eye(n), order=3, axis=0, mode="mirror",
                           output=np.float64).astype(np.float32)


def prefilter_2d(img: torch.Tensor) -> torch.Tensor:
    """Prefilter the trailing two axes of (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    ph = torch.as_tensor(prefilter_matrix(h), dtype=img.dtype,
                         device=img.device)
    pw = torch.as_tensor(prefilter_matrix(w), dtype=img.dtype,
                         device=img.device)
    out = torch.einsum("...hw,Hh->...Hw", img, ph)
    return torch.einsum("...Hw,Ww->...HW", out, pw)


def _cubic_bspline_weights(t):
    """B-spline basis values for taps at offsets (-1, 0, 1, 2) from the
    floor."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1 - 3 * t + 3 * t2 - t3) / 6.0
    w1 = (4 - 6 * t2 + 3 * t3) / 6.0
    w2 = (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0
    w3 = t3 / 6.0
    return w0, w1, w2, w3


def _mirror_index(idx, n: int):
    """scipy 'mirror' boundary: reflect about the first and last sample
    (period 2n-2)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def _batched(fn):
    """Let a (B, C, H, W) x (B, 2, P, Q) function take one (H, W) image
    with (2, P, Q) coordinates."""
    def wrapper(img, coords, *args, **kw):
        if img.ndim == 2:
            return fn(img[None, None], coords[None], *args, **kw)[0, 0]
        return fn(img, coords, *args, **kw)
    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


def _taps(img, iy, ix):
    """img (B, C, H, W) at integer (B, P, Q) indices -> (B, C, P, Q)."""
    b, c, h, w = img.shape
    flat = (iy * w + ix).reshape(b, 1, -1).expand(b, c, -1)
    return torch.gather(img.reshape(b, c, h * w), 2, flat).reshape(
        b, c, *iy.shape[1:])


def _floor_frac(coords, dtype):
    f = torch.floor(coords)
    return f.to(torch.int64), (coords - f).to(dtype)


@_batched
def map_coordinates_cubic_2d(img, coords, prefiltered: bool = False):
    """scipy.ndimage.map_coordinates(order=3, mode='mirror') equivalent.

    img (B, C, H, W) or (H, W); coords (B, 2, P, Q) or (2, P, Q) in
    array-index space. 'constant' borders are the caller's mask."""
    if not prefiltered:
        img = prefilter_2d(img)
    h, w = img.shape[-2:]
    base_y, ty = _floor_frac(coords[:, 0], img.dtype)
    base_x, tx = _floor_frac(coords[:, 1], img.dtype)
    wy = _cubic_bspline_weights(ty[:, None])
    wx = _cubic_bspline_weights(tx[:, None])
    out = torch.zeros((img.shape[0], img.shape[1], *coords.shape[2:]),
                      dtype=img.dtype, device=img.device)
    for dy in range(-1, 3):
        iy = _mirror_index(base_y + dy, h)
        for dx in range(-1, 3):
            ix = _mirror_index(base_x + dx, w)
            out = out + wy[dy + 1] * wx[dx + 1] * _taps(img, iy, ix)
    return out


@_batched
def map_coordinates_linear_2d(img, coords):
    """Bilinear sampling with mirror boundary (order=1)."""
    h, w = img.shape[-2:]
    fy, ty = _floor_frac(coords[:, 0], img.dtype)
    fx, tx = _floor_frac(coords[:, 1], img.dtype)
    ty, tx = ty[:, None], tx[:, None]
    y0, y1 = _mirror_index(fy, h), _mirror_index(fy + 1, h)
    x0, x1 = _mirror_index(fx, w), _mirror_index(fx + 1, w)
    return ((1 - ty) * (1 - tx) * _taps(img, y0, x0)
            + (1 - ty) * tx * _taps(img, y0, x1)
            + ty * (1 - tx) * _taps(img, y1, x0)
            + ty * tx * _taps(img, y1, x1))


def rotate_scale_coords(patch_size, angle, scale, in_shape):
    """Zero-centered mesh -> rotate(angle) -> * scale -> centred in
    in_shape (batchgenerators augment_spatial, centre crop).

    angle, scale: (B,) tensors (or 0-d: one sample). Returns coords (B, 2,
    *patch_size) (or (2, *patch_size)) and the in-bounds mask (B,
    *patch_size) for 'constant' border emulation."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=angle.device)
    one = angle.ndim == 0
    angle, scale = angle.reshape(-1, 1, 1), scale.reshape(-1, 1, 1)
    ph, pw = patch_size
    yy = torch.arange(ph, dtype=torch.float32, device=angle.device) \
        - (ph - 1) / 2.0
    xx = torch.arange(pw, dtype=torch.float32, device=angle.device) \
        - (pw - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    cos, sin = torch.cos(angle), torch.sin(angle)
    # batchgenerators rotate_coords_2d: coords^T @ R, R = [[c, -s], [s, c]]
    ry = gy * cos + gx * sin
    rx = -gy * sin + gx * cos
    ry = ry * scale + (in_shape[0] / 2.0 - 0.5)
    rx = rx * scale + (in_shape[1] / 2.0 - 0.5)
    inb = ((ry >= 0) & (ry <= in_shape[0] - 1)
           & (rx >= 0) & (rx <= in_shape[1] - 1))
    coords = torch.stack([ry, rx], dim=1)
    if one:
        return coords[0], inb[0]
    return coords, inb


def _masked(out, mask, cval):
    m = mask if out.ndim == mask.ndim else mask[:, None]
    return torch.where(m, out, torch.as_tensor(cval, dtype=out.dtype,
                                               device=out.device))


def warp_data_2d(img, coords, mask, cval: float = 0.0):
    """Order-3 warp with a 'constant' border: out of range -> cval."""
    return _masked(map_coordinates_cubic_2d(img, coords), mask, cval)


def warp_seg_2d(seg, coords, mask, cval: float = 0.0):
    """Order-1 warp of a BINARY label map with a >= 0.5 threshold
    (interpolate_img(is_seg=True) for {0, 1} labels)."""
    out = map_coordinates_linear_2d(seg, coords)
    out = torch.where(out >= 0.5, 1.0, 0.0).to(out.dtype)
    return _masked(out, mask, cval)
