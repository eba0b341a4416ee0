"""Slice-profile FWHM math (numpy): the port's own copy of the first part
of ``rehrseg_tpu.ops.blur`` (:30-43).

``fwhm_needed(target, thick)`` is the blur FWHM that degrades a
``target``-mm signal to ``thick``-mm slices, FWHMs adding in quadrature.
The SLR slice profile and the separable blurs are still to be ported with
SR training.
"""

from __future__ import annotations

import numpy as np


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
