"""Intensity normalization (reference utils/seg_utils.py:74-174): the
port's own copy of ``rehrseg_tpu.data.normalize``. The numpy functions
take whole volumes; ``zscore_batch`` (torch) normalizes channel 0 per
sample of a batch."""

from __future__ import annotations

import numpy as np
import torch


def zscore_normalization(image: np.ndarray) -> np.ndarray:
    image = image.astype(np.float32, copy=True)
    mean = image.mean()
    std = image.std()
    image -= mean
    image /= max(std, 1e-8)
    return image


def zeroone_normalization(image: np.ndarray) -> np.ndarray:
    image = image.astype(np.float32, copy=True)
    mn, mx = image.min(), image.max()
    image -= mn
    image /= (mx - mn)
    return image


def percentile_normalization(image: np.ndarray, p_min: float = 0.5,
                             p_max: float = 99.5,
                             strictly_positive: bool = True) -> np.ndarray:
    image = image.astype(np.float32, copy=False)
    v_min, v_max = np.percentile(image, [p_min, p_max])
    if v_min < 0 and strictly_positive:
        v_min = 0
    out = np.clip(image, v_min, v_max)
    return (out - v_min) / (v_max - v_min)


def zscore_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score of channel 0 of a (B, *spatial, C) batch; returns
    only the normalized channel-0 slab (seg_utils.py:137-149). The std is
    the population std, as ``jnp.std``."""
    img = x[..., 0:1]
    dims = tuple(range(1, x.ndim))
    mean = img.mean(dim=dims, keepdim=True)
    std = img.std(dim=dims, keepdim=True, correction=0)
    return (img - mean) / std.clamp(min=1e-8)
