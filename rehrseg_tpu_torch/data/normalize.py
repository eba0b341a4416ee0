"""Intensity normalization: the port's own copy of
``rehrseg_tpu.data.normalize.zscore_normalization`` (numpy) and
``zscore_batch`` (torch, per sample on a batch)."""

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


def zscore_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score of channel 0 of a (B, *spatial, C) batch; returns
    only the normalized channel-0 slab (seg_utils.py:137-149). The std is
    the population std, as ``jnp.std``."""
    img = x[..., 0:1]
    dims = tuple(range(1, x.ndim))
    mean = img.mean(dim=dims, keepdim=True)
    std = img.std(dim=dims, keepdim=True, correction=0)
    return (img - mean) / std.clamp(min=1e-8)
