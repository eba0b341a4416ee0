"""Segmentation losses and the evaluation metric (``rehrseg_tpu.losses``).

Channels-last like the JAX package: logits (B, *spatial, C), targets
(B, *spatial, 1) float class indices (truncated as ``astype(int32)``) or
(B, *spatial, C) one-hot.

  - ``soft_dice_loss``: nnUNet's MemoryEfficientSoftDiceLoss (softmax,
    batch_dice=False, do_bg=False, smooth=1e-5; the NEGATIVE mean dice);
  - ``robust_cross_entropy``: CE on logits with optional per-voxel
    uncertainty weights, the label's log-prob taken as a masked select-sum
    (a one-hot multiply would turn a ``-inf`` log-prob into NaN);
  - ``dc_and_weighted_ce`` and ``build_seg_loss`` with the deep-supervision
    weights;
  - ``calculate_dice``: the binary evaluation metric (numpy).

The stage-1 SR losses are still to be ported (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch


def _labels(target):
    """Float class indices -> int64, truncated toward zero as
    ``astype(int32)`` does."""
    return target.to(torch.int32).to(torch.int64)


def soft_dice_loss(logits, target, smooth: float = 1e-5, do_bg: bool = False,
                   batch_dice: bool = False):
    """Negative soft dice with softmax nonlinearity."""
    probs = torch.softmax(logits, dim=-1)
    num_classes = logits.shape[-1]
    if target.shape == logits.shape:
        y_onehot = target.to(probs.dtype)
    else:
        # an out-of-range index gives a zero row, as jax.nn.one_hot does
        classes = torch.arange(num_classes, device=logits.device)
        y_onehot = (_labels(target[..., 0])[..., None] == classes).to(
            probs.dtype)
    if not do_bg:
        probs = probs[..., 1:]
        y_onehot = y_onehot[..., 1:]
    spatial = tuple(range(1, probs.ndim - 1))
    intersect = (probs * y_onehot).sum(spatial)
    sum_pred = probs.sum(spatial)
    sum_gt = y_onehot.sum(spatial)
    if batch_dice:
        intersect, sum_pred, sum_gt = (intersect.sum(0), sum_pred.sum(0),
                                       sum_gt.sum(0))
    dc = (2.0 * intersect + smooth) / (sum_gt + sum_pred + smooth).clamp(
        min=1e-8)
    return -dc.mean()


def robust_cross_entropy(logits, target, uncertainty=None):
    """CE on logits with float targets; optional per-voxel weights, then
    the mean."""
    if target.ndim == logits.ndim:
        target = target[..., 0]
    labels = _labels(target)
    logp = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(logp.shape[-1], device=logp.device)
    mask = labels[..., None] == classes
    nll = -torch.where(mask, logp, torch.zeros_like(logp)).sum(-1)
    if uncertainty is not None:
        if uncertainty.ndim == nll.ndim + 1:
            uncertainty = uncertainty[..., 0]
        nll = nll * uncertainty
    return nll.mean()


def dc_and_weighted_ce(logits, target, uncertainty=None,
                       weight_ce: float = 1.0, weight_dice: float = 1.0,
                       smooth: float = 1e-5):
    dc = (soft_dice_loss(logits, target, smooth=smooth)
          if weight_dice != 0 else 0.0)
    ce = (robust_cross_entropy(logits, target, uncertainty)
          if weight_ce != 0 else 0.0)
    return weight_ce * ce + weight_dice * dc


def deep_supervision_weights(n_scales: int) -> np.ndarray:
    """Exponentially decaying weights, the last zeroed, normalized
    (seg_utils.py:363-370)."""
    weights = np.array([1.0 / (2 ** i) for i in range(n_scales)])
    weights[-1] = 0.0
    return weights / weights.sum()


def build_seg_loss(enable_deep_supervision: bool = False,
                   weight_dice: float = 1.0):
    """The reference's ``_build_loss`` factory (seg_utils.py:355-372)."""
    def single(logits, target, uncertainty=None):
        return dc_and_weighted_ce(logits, target, uncertainty,
                                  weight_ce=1.0, weight_dice=weight_dice)

    if not enable_deep_supervision:
        return single

    def ds(logits_list, target_list, uncertainty=None):
        weights = deep_supervision_weights(len(logits_list))
        total = 0.0
        for w, lg, tg in zip(weights, logits_list, target_list):
            if w == 0.0:
                continue
            total = total + float(w) * single(lg, tg, uncertainty)
        return total

    return ds


def calculate_dice(prediction, ground_truth, smooth: float = 1e-5) -> float:
    prediction = np.asarray(prediction).flatten()
    ground_truth = np.asarray(ground_truth).flatten()
    intersection = np.sum(prediction * ground_truth)
    return float((2.0 * intersection + smooth) /
                 (np.sum(prediction) + np.sum(ground_truth) + smooth))
