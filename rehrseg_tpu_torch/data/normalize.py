"""Intensity normalization (numpy): the port's own copy of
``rehrseg_tpu.data.normalize.zscore_normalization``."""

from __future__ import annotations

import numpy as np


def zscore_normalization(image: np.ndarray) -> np.ndarray:
    image = image.astype(np.float32, copy=True)
    mean = image.mean()
    std = image.std()
    image -= mean
    image /= max(std, 1e-8)
    return image
