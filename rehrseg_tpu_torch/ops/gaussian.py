"""Gaussian importance map for sliding-window accumulation (numpy).

The port's own copy of ``rehrseg_tpu.ops.gaussian``, itself nnunetv2's
``compute_gaussian``: a delta at the tile center filtered by a gaussian with
sigma = tile_size * sigma_scale per axis, normalized to max 1, scaled by
``value_scaling_factor``, with exact zeros replaced by the smallest nonzero
value. Built separably (product of 1-D filtered deltas), cached per tile
geometry.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def compute_gaussian(tile_size: tuple, sigma_scale: float = 1.0 / 8,
                     value_scaling_factor: float = 10.0,
                     dtype=np.float32) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    axes_1d = []
    for n in tile_size:
        tmp = np.zeros(n)
        tmp[n // 2] = 1.0
        sigma = n * sigma_scale
        axes_1d.append(gaussian_filter(tmp, sigma, 0, mode="constant", cval=0))

    g = axes_1d[0]
    for a in axes_1d[1:]:
        g = np.multiply.outer(g, a)
    g = g / g.max() * value_scaling_factor
    g = g.astype(dtype)
    nz = g[g != 0]
    if nz.size:
        g[g == 0] = nz.min()
    # the cache hands the same array to every caller: keep it read-only
    g.setflags(write=False)
    return g
