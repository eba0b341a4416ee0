"""Symmetric target padding and inverse cropping (numpy).

The port's own copy of ``rehrseg_tpu.utils.pad``: pad each axis up to
``target_dims`` with the extra voxels split low/high (low side gets the
floor), and ``crop`` inverts a recorded pad.
"""

from __future__ import annotations

import numpy as np


def get_pads(target_dim: int, d: int) -> tuple[int, int]:
    """Low/high pad amounts taking axis length ``d`` to ``target_dim``."""
    if target_dim <= d:
        return 0, 0
    p = (target_dim - d) // 2
    return p, target_dim - d - p


def target_pad(img: np.ndarray, target_dims, mode: str = "reflect"):
    """Pad ``img`` so every axis is at least the matching ``target_dims`` entry.

    Returns (padded_img, pads) where ``pads`` is a tuple of (low, high) per axis
    suitable for :func:`crop`.
    """
    pads = tuple(get_pads(t, d) for t, d in zip(target_dims, img.shape))
    if not any(p != (0, 0) for p in pads):
        return img, pads
    kwargs = {}
    if mode == "constant":
        kwargs["constant_values"] = 0
    return np.pad(img, pads, mode=mode, **kwargs), pads


def format_pads(pads) -> slice:
    """Turn a (low, high) pad pair into the slice that removes it."""
    st = pads[0] if pads[0] != 0 else None
    en = -pads[1] if pads[1] != 0 else None
    return slice(st, en)


def crop(img, pads):
    """Invert :func:`target_pad` given its recorded ``pads``."""
    crops = tuple(map(format_pads, pads))
    return img[crops]
