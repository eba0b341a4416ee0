"""Segmentation and SR losses and the evaluation metrics
(``rehrseg_tpu.losses``).

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
  - the stage-1 SR losses (train_all.py:125-134): ``sr_loss`` (L1 on the
    image channel + BCEDice on the label channels) and
    ``sr_uncertainty_loss`` (the UASR head's heteroscedastic terms too),
    each with the single-channel ``sr_mode='img'`` branch;
  - ``calculate_dice``: the binary evaluation metric, and
    ``calculate_psnr``, the SR quality metric (numpy).
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


# ------------------------------------------------------------ stage-1 losses

def _flatten_channel_first(x):
    """(B, *spatial, C) -> (C, B*prod(spatial)): dice per channel over the
    batch."""
    return torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)


def dice_loss_sigmoid(logits, target, epsilon: float = 1e-6, reduce=None):
    """DiceLoss with the sigmoid and a squared denominator
    (seg_utils.py:786-873). Its sums run over the whole batch, so under
    data parallelism ``reduce`` (``parallel.multihost.global_sum``) sums
    the intersect and the denominator across processes before the ratio:
    the dice of the global batch."""
    p = _flatten_channel_first(torch.sigmoid(logits))
    t = _flatten_channel_first(target).to(p.dtype)
    intersect = (p * t).sum(-1)
    denominator = (p * p).sum(-1) + (t * t).sum(-1)
    if reduce is not None:
        intersect, denominator = reduce(torch.stack([intersect,
                                                     denominator]))
    return 1.0 - (2.0 * intersect / denominator.clamp(min=epsilon)).mean()


def bce_with_logits(logits, target):
    return (logits.clamp(min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def bce_dice_loss(logits, target, alpha: float = 1.0, beta: float = 1.0,
                  reduce=None):
    """BCEDiceLoss (seg_utils.py:875-886); ``reduce``: as
    :func:`dice_loss_sigmoid`'s."""
    return (alpha * bce_with_logits(logits, target)
            + beta * dice_loss_sigmoid(logits, target, reduce=reduce))


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def sr_loss(pred, target, alpha: float = 1.0, beta: float = 1.0,
            reduce=None):
    """Stage-1 loss without uncertainty (train_all.py:132-134): L1 on
    channel 0 (the image) + BCEDice on the other (label) channels; the L1
    alone for single-channel SR. ``reduce``: the dice's cross-process sum
    (:func:`dice_loss_sigmoid`)."""
    img_l1 = l1_loss(pred[..., 0:1], target[..., 0:1])
    if pred.shape[-1] == 1:
        return img_l1
    return img_l1 + bce_dice_loss(pred[..., 1:], target[..., 1:], alpha,
                                  beta, reduce=reduce)


def sr_uncertainty_loss(pred, uncertainty, target, alpha: float = 1.0,
                        beta: float = 1.0, reduce=None):
    """Stage-1 loss of the UASR head (train_all.py:125-134): L1(image) +
    mean(|err| / u + log u) + L1(u, |err| detached) + BCEDice(label), the
    last term absent for single-channel SR. ``reduce``: as
    :func:`sr_loss`'s."""
    err = pred[..., 0:1] - target[..., 0:1]
    loss = l1_loss(pred[..., 0:1], target[..., 0:1])
    loss = loss + (err.abs() / uncertainty + torch.log(uncertainty)).mean()
    loss = loss + l1_loss(uncertainty, err.abs().detach())
    if pred.shape[-1] == 1:
        return loss
    return loss + bce_dice_loss(pred[..., 1:], target[..., 1:], alpha, beta,
                                reduce=reduce)


# -------------------------------------------------------------- eval metrics

def calculate_dice(prediction, ground_truth, smooth: float = 1e-5) -> float:
    prediction = np.asarray(prediction).flatten()
    ground_truth = np.asarray(ground_truth).flatten()
    intersection = np.sum(prediction * ground_truth)
    return float((2.0 * intersection + smooth) /
                 (np.sum(prediction) + np.sum(ground_truth) + smooth))


def calculate_psnr(prediction, ground_truth,
                   data_range: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB (fp64), the SR quality metric;
    ``data_range`` defaults to the ground truth's range."""
    prediction = np.asarray(prediction, dtype=np.float64)
    ground_truth = np.asarray(ground_truth, dtype=np.float64)
    if data_range is None:
        data_range = float(ground_truth.max() - ground_truth.min())
    mse = np.mean((prediction - ground_truth) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))
