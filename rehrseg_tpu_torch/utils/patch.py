"""Slice-count math for rational SR factors and gradient-weighted patch
sampling: the port's own copy of ``rehrseg_tpu.utils.patch``.

The first functions decide how many slices a volume is padded by so that a
rational SR factor lands on the ideal output slice count
(``projected_size == ideal_size``). The sampling functions (numpy) draw
from the caller's ``np.random.Generator`` in the JAX package's order, so
one seed gives the same patches in both packages.
"""

from __future__ import annotations

from math import floor

import numpy as np


def projected_size(n_slices: int, p: int, scale: float) -> int:
    """Slices produced by pad-by-``p`` -> fractional resize -> integer
    shuffle -> crop."""
    scale_tilde = scale / floor(scale)
    return round((n_slices + p) * scale_tilde) * floor(scale) \
        - round(p * scale)


def calc_slices_to_crop(p: int, scale: float) -> int:
    return round(p * scale)


def ideal_size(n_slices: int, scale: float) -> int:
    """Target slice count after SR."""
    return round(n_slices * scale)


def find_integer_p(n_slices: int, s: float, max_iter: int = 1000) -> int:
    """Smallest pad ``p`` with ``projected_size(n, p, s) == ideal_size(n,
    s)``; 0 when none is found within ``max_iter``."""
    p = 0
    for _ in range(max_iter):
        if projected_size(n_slices, p, s) == ideal_size(n_slices, s):
            return p
        p += 1
    if projected_size(n_slices, p, s) == ideal_size(n_slices, s):
        return p
    return 0


def get_patch(img_rot: np.ndarray, patch_center, patch_size,
              return_idx: bool = False):
    """The patch centered at ``patch_center``; size-1 axes are squeezed
    away (or the index slices with ``return_idx``)."""
    sts = [c - p // 2 if p != 1 else c
           for c, p in zip(patch_center, patch_size)]
    idx = tuple(slice(st, st + p) for st, p in zip(sts, patch_size))
    if return_idx:
        return idx
    return img_rot[idx].squeeze()


def _gradient_probs(img_rot: np.ndarray, patch_size) -> list[np.ndarray]:
    """Per-axis marginal sampling probabilities proportional to
    sqrt|grad(gaussian-smoothed img)|, zero where a patch would not fit."""
    from scipy.ndimage import gaussian_filter

    smooth = gaussian_filter(img_rot, 1.0)
    grads = np.gradient(smooth)
    grad_mag = np.sum([np.sqrt(np.abs(g)) for g in grads], axis=0)
    for p, axis in zip(patch_size, range(grad_mag.ndim)):
        if p > 1:
            grad_mag = np.swapaxes(grad_mag, 0, axis)
            grad_mag[: p // 2 + 1] = 0.0
            grad_mag[-p // 2 - 1:] = 0.0
            grad_mag = np.swapaxes(grad_mag, axis, 0)
    grad_probs_nd = grad_mag / grad_mag.sum()
    probs = [grad_probs_nd.sum(axis=tuple(k for k in range(grad_probs_nd.ndim)
                                          if k != axis))
             for axis in range(grad_probs_nd.ndim)]
    return [p / p.sum() for p in probs]


def get_random_centers(imgs_rot, patch_size, n_patches: int,
                       weighted: bool = True,
                       rng: np.random.Generator | None = None):
    """``n_patches`` (rotation index, center) pairs across the rotated
    copies, gradient-weighted unless ``weighted`` is False."""
    rng = rng or np.random.default_rng()
    rot_choices = rng.integers(0, len(imgs_rot), size=n_patches)
    centers = []
    for i, img_rot in enumerate(imgs_rot):
        n_choices = int(np.sum(rot_choices == i))
        grad_probs = (_gradient_probs(img_rot, patch_size) if weighted
                      else [None] * img_rot.ndim)
        random_indices = [
            rng.choice(np.arange(0, img_dim), size=n_choices,
                       p=grad_probs[axis])
            for axis, img_dim in enumerate(img_rot.shape)]
        centers.extend((i, tuple(coord)) for coord in zip(*random_indices))
    rng.shuffle(centers)
    return centers
