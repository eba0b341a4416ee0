"""Structural knowledge distillation between the SR teacher's and the
segmentation student's encoder features (``rehrseg_tpu.models.distiller``;
reference models/seg_model.py:60-151).

Three weighted terms on channels-last (B, S, H, W, C) feature maps:
  (a) structural: the slice dim folded into the batch, max-pooled to half
      size (ceil mode), channel-L2 normalized (the norm detached), pairwise
      position-similarity matrices, squared error teacher vs student;
  (b) a 1x1x1-conv projection of the student, then smooth-L1;
  (c) the cosine distance of channel-normalized features (the norm not
      detached).
The teacher is always detached. Under a spatial group the maps come as
:class:`..parallel.spatial.HBlocks`: the projection runs block by block,
every sum is added over blocks, and only the pooled maps (a few cells) of
the structural term are gathered.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial as sp


def _maxpool2d_ceil(x, kh: int, kw: int):
    """MaxPool2d(kernel=stride=(kh, kw), ceil_mode=True) on (N, H, W, C)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), (kh, kw),
                     ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _l2_channel(feat, eps: float = 1e-8):
    """Per-position channel L2 norm (reference L2(), seg_model.py:80-81)."""
    return feat.pow(2).sum(-1, keepdim=True).sqrt() + eps


def similarity(feat):
    """Pairwise position-similarity matrix: (N, H, W, C) -> (N, M, M),
    M = H*W (seg_model.py:83-88)."""
    feat = feat.float()
    feat = feat / _l2_channel(feat).detach()
    n, h, w, c = feat.shape
    flat = feat.reshape(n, h * w, c)
    return torch.einsum("imc,inc->imn", flat, flat)


def sim_dis_compute(f_s, f_t):
    """(similarity(T) - similarity(S))^2 normalized (seg_model.py:90-93)."""
    n, h, w, _ = f_t.shape
    sim_err = (similarity(f_t) - similarity(f_s)) ** 2 / ((h * w) ** 2) / n
    return sim_err.sum()


def _fold(x):
    """(B, S, H, W, C) -> (B*S, H, W, C)."""
    b, s_, h, w, c = x.shape
    return x.reshape(b * s_, h, w, c)


def _maxpool_blocks(x, kh: int, kw: int):
    """:func:`_maxpool2d_ceil` of a folded (B, S, H, W, C) HBlocks, on the
    group's first device: each block takes the maximum of its rows of each
    (kh, kw) cell, and the cell's maximum is the largest of the blocks'
    (the one chosen takes the gradient, as the whole map's pool gives it).
    Only the pooled map, a few cells, leaves the blocks."""
    home, rows = x.group[0], []
    for c0 in range(0, x.h, kh):
        c1 = min(c0 + kh, x.h)
        parts = []
        for p, a, b in zip(x.parts, x.starts, x.starts[1:]):
            lo, hi = max(a, c0), min(b, c1)
            if lo < hi:
                parts.append(_maxpool2d_ceil(
                    _fold(p[:, :, lo - a:hi - a]), hi - lo, kw).to(home))
        rows.append(parts[0] if len(parts) == 1
                    else torch.stack(parts).max(0).values)
    return torch.cat(rows, dim=1)


def pairwise_loss_after_pool(feat_s, feat_t, scale: float = 0.5):
    """CriterionPairWiseforWholeFeatAfterPool (seg_model.py:95-113): the
    slice dim folds into the batch, both maps pool to ``scale``. HBlocks
    inputs pool block by block (:func:`_maxpool_blocks`)."""
    b, s, h, w, cs = feat_s.shape
    kh, kw = max(int(h * scale), 1), max(int(w * scale), 1)
    if isinstance(feat_s, sp.HBlocks):
        return sim_dis_compute(_maxpool_blocks(feat_s, kh, kw),
                               _maxpool_blocks(feat_t, kh, kw)) / s
    fs = _fold(feat_s)
    ft = _fold(feat_t.detach())
    return sim_dis_compute(_maxpool2d_ceil(fs, kh, kw),
                           _maxpool2d_ceil(ft, kh, kw)) / s


def _cosine_sums(t1, t2):
    """(3, B, C): the per-channel dot product and squared norms, over the
    spatial dims, of the channel-normalized maps."""
    t1 = t1 / _l2_channel(t1)
    t2 = t2 / _l2_channel(t2)
    b, c = t1.shape[0], t1.shape[-1]
    f1 = torch.movedim(t1, -1, 1).reshape(b, c, -1)
    f2 = torch.movedim(t2, -1, 1).reshape(b, c, -1)
    return torch.stack([(f1 * f2).sum(2), f1.square().sum(2),
                        f2.square().sum(2)])


def cosine_distance_loss(t1, t2):
    """Mean cosine distance over per-channel spatial vectors
    (seg_model.py:60-78). t: (B, S, H, W, C), or HBlocks of one H whose
    sums are added over blocks (``spatial.total_of``)."""
    num, n1, n2 = sp.total_of(_cosine_sums, t1, t2)
    den = n1.sqrt() * n2.sqrt()
    return (1.0 - num / den.clamp(min=1e-8)).mean()


def smooth_l1(pred, target, beta: float = 1.0):
    def total(p, t):
        diff = (p - t).abs()
        return torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                           diff - 0.5 * beta).sum()
    return sp.total_of(total, pred, target) / math.prod(pred.shape)


class Distiller(nn.Module):
    """The KD module (seg_model.py:115-151): a 1x1x1 projection conv
    (``distill``) and the weighted losses; forward(student, teacher)
    returns the loss."""

    def __init__(self, student_dim: int = 64, teacher_dim: int = 64,
                 lambda_l1: float = 0.0, lambda_cosine: float = 1.0,
                 lambda_structure: float = 1.0):
        super().__init__()
        self.lambda_l1 = lambda_l1
        self.lambda_cosine = lambda_cosine
        self.lambda_structure = lambda_structure
        self.distill = nn.Conv3d(student_dim, teacher_dim, 1, bias=True)

    def forward(self, feature_student, feature_teacher):
        """The loss of a (B, S, H, W, C) student and teacher map, or of two
        HBlocks of one H (the 1x1x1 projection block by block, every sum
        added over blocks)."""
        loss = 0.0
        feature_teacher = sp.local(torch.Tensor.detach, feature_teacher)
        if self.lambda_structure > 0:
            loss = loss + self.lambda_structure * pairwise_loss_after_pool(
                feature_student, feature_teacher, scale=0.5)
        distilled = sp.local(lambda t, w, b: F.conv3d(
            t.permute(0, 4, 1, 2, 3), w, b).permute(0, 2, 3, 4, 1),
            feature_student, self.distill.weight, self.distill.bias)
        if self.lambda_l1 > 0:
            loss = loss + self.lambda_l1 * smooth_l1(distilled,
                                                     feature_teacher)
        if self.lambda_cosine > 0:
            loss = loss + self.lambda_cosine * cosine_distance_loss(
                distilled, feature_teacher)
        return loss
