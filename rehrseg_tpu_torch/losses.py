"""Evaluation metric (``rehrseg_tpu.losses.calculate_dice`` in numpy).

The training losses of ``rehrseg_tpu.losses`` are still to be ported
(ROADMAP queue 1, item 8)."""

from __future__ import annotations

import numpy as np


def calculate_dice(prediction, ground_truth, smooth: float = 1e-5) -> float:
    prediction = np.asarray(prediction).flatten()
    ground_truth = np.asarray(ground_truth).flatten()
    intersection = np.sum(prediction * ground_truth)
    return float((2.0 * intersection + smooth) /
                 (np.sum(prediction) + np.sum(ground_truth) + smooth))
