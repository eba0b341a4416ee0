"""In-plane 90-degree volume rotations (``rehrseg_tpu.utils.rotate`` in
PyTorch; reference utils/rotate.py:5-31)."""

from __future__ import annotations

import numpy as np
import torch

_K = {0: 0, 360: 0, 90: 1, -90: -1, 180: 2, -180: -2, 270: 3, -270: -3}


def rotate_vol_2d(vol, angle: int):
    """Rotate each in-plane slice of an (hr, hr, lr[, c]) volume by a
    multiple of 90 degrees; numpy arrays or tensors."""
    if angle not in _K:
        raise NotImplementedError(
            "Angles other than 90 degree rotations are not supported.")
    k = _K[angle]
    if k == 0:
        return vol
    if isinstance(vol, torch.Tensor):
        return torch.rot90(vol, k=k, dims=(0, 1))
    return np.rot90(vol, k=k, axes=(0, 1))
