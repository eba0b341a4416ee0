"""MRI slice-profile blur: FWHM math, kernel synthesis and the separable
blur (the port's own copy of ``rehrseg_tpu.ops.blur``).

  - ``fwhm_needed(target, thick)``: the blur FWHM that degrades a
    ``target``-mm signal to ``thick``-mm slices, FWHMs adding in
    quadrature;
  - :func:`parse_kernel`: the normalized 1-D slice-profile kernel of
    window ``2*round(fwhm)+1`` (reference blur_kernel_ops.py:7-35);
    'rf-pulse-slr' profiles come from the SLR designer in :mod:`.slr`,
    'gaussian' from the analytic gaussian;
  - :func:`blur_axis` (torch, a 1-D convolution along one axis of a
    tensor) and :func:`blur_axis_np` (numpy), both zero-padded 'same'
    cross-correlations as the reference's ``F.conv2d(img,
    kernel[None, None, :, None], padding='same')`` (train_set.py:325,332).
"""

from __future__ import annotations

from functools import lru_cache
from math import ceil

import numpy as np
import torch
import torch.nn.functional as F


def fwhm_needed(target_thickness: float, slice_thickness: float) -> float:
    """Blur FWHM (physical units) to take target-res -> slice-thickness
    res."""
    return float(np.sqrt(max(slice_thickness ** 2 - target_thickness ** 2,
                             0.0)))


def fwhm_units_to_voxel_space(fwhm: float, voxel_size: float) -> float:
    return float(fwhm / voxel_size)


def blur_fwhm_in_voxels(target_thickness: float,
                        slice_thickness: float) -> float:
    return fwhm_units_to_voxel_space(
        fwhm_needed(target_thickness, slice_thickness), target_thickness)


@lru_cache(maxsize=32)
def _slr_profile_cached(tb: float = 4.0):
    from . import slr

    x, prof = slr.slice_profile(n=128, tb=tb)
    return x, prof, slr.measure_fwhm(x, prof)


def select_kernel(window_size: int, kernel_type: str,
                  fwhm: float) -> np.ndarray:
    """1-D blur kernel of length ``window_size`` with the requested FWHM
    (not normalized: :func:`parse_kernel` does that, blur_kernel_ops.py
    :12-14). Types: 'rf-pulse-slr' (the SLR excitation slice profile) and
    'gaussian'."""
    offsets = (np.arange(window_size, dtype=np.float64)
               - (window_size - 1) / 2.0)
    if kernel_type == "rf-pulse-slr":
        x, prof, meas = _slr_profile_cached()
        # rescale the spatial axis so the profile's FWHM is `fwhm` voxels
        kernel = np.interp(offsets * (meas / fwhm), x, prof, left=0.0,
                           right=0.0)
    elif kernel_type == "gaussian":
        sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        kernel = np.exp(-0.5 * (offsets / sigma) ** 2)
    else:
        raise ValueError(f"Unknown blur kernel type: {kernel_type}")
    return kernel.astype(np.float64)


def parse_kernel(blur_kernel_file, blur_kernel_type: str,
                 blur_fwhm: float) -> np.ndarray:
    """The normalized 1-D kernel as a (L,) float32 array: loaded from
    ``blur_kernel_file`` (a ``.npy``) when given, else
    :func:`select_kernel` at window ``2*round(fwhm)+1``."""
    if blur_kernel_file is not None:
        blur_kernel = np.load(blur_kernel_file)
    else:
        window_size = int(2 * round(blur_fwhm) + 1)
        blur_kernel = select_kernel(window_size, blur_kernel_type,
                                    fwhm=blur_fwhm)
    blur_kernel = np.asarray(blur_kernel, dtype=np.float64)
    blur_kernel = blur_kernel / blur_kernel.sum()
    return blur_kernel.squeeze().astype(np.float32)


def calc_extended_patch_size(blur_kernel: np.ndarray, patch_size):
    """Extended patch and the crop slices that remove the blur's boundary
    effects (blur_kernel_ops.py:21-35)."""
    L = blur_kernel.shape[0]
    ext_patch_size = [p + 2 * ceil(L / 2) if p != 1 else p
                      for p in patch_size]
    ext_patch_crop = [(e - p) // 2 for e, p in zip(ext_patch_size,
                                                   patch_size)]
    ext_patch_crop = tuple(slice(d, -d) for d in ext_patch_crop if d != 0)
    return ext_patch_size, ext_patch_crop


def blur_axis(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Zero-padded 'same' 1-D cross-correlation of ``x`` along ``axis`` in
    ``x``'s dtype on its device; an even-length kernel pads one more on
    the right, as XLA's SAME padding does."""
    axis = axis % x.ndim
    moved = torch.movedim(x, axis, -1)
    n = moved.shape[-1]
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype,
                        device=x.device).reshape(1, 1, -1)
    total = k.shape[-1] - 1
    flat = F.pad(moved.reshape(-1, 1, n), (total // 2, total - total // 2))
    out = F.conv1d(flat, k).reshape(moved.shape)
    return torch.movedim(out, -1, axis)


def blur_axis_np(x: np.ndarray, kernel: np.ndarray,
                 axis: int) -> np.ndarray:
    """Host version of :func:`blur_axis` (zero-padded 'same' 1-D
    cross-correlation along ``axis``)."""
    pad = len(kernel) // 2
    xp = np.moveaxis(x, axis, -1)
    padded = np.pad(xp, [(0, 0)] * (xp.ndim - 1) + [(pad, pad)],
                    mode="constant")
    # cross-correlation (torch conv semantics) is np.convolve with the
    # kernel flipped
    out = np.apply_along_axis(
        lambda v: np.convolve(v, kernel[::-1], mode="valid"), -1, padded)
    if len(kernel) % 2 == 0:
        out = out[..., :xp.shape[-1]]
    return np.moveaxis(out.astype(x.dtype, copy=False), -1, axis)
