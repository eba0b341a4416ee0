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
The teacher is always detached.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def pairwise_loss_after_pool(feat_s, feat_t, scale: float = 0.5):
    """CriterionPairWiseforWholeFeatAfterPool (seg_model.py:95-113): the
    slice dim folds into the batch, both maps pool to ``scale``."""
    b, s, h, w, cs = feat_s.shape
    ct = feat_t.shape[-1]
    fs = feat_s.reshape(b * s, h, w, cs)
    ft = feat_t.detach().reshape(b * s, h, w, ct)
    kh, kw = max(int(h * scale), 1), max(int(w * scale), 1)
    return sim_dis_compute(_maxpool2d_ceil(fs, kh, kw),
                           _maxpool2d_ceil(ft, kh, kw)) / s


def cosine_distance_loss(t1, t2):
    """Mean cosine distance over per-channel spatial vectors
    (seg_model.py:60-78). t: (B, S, H, W, C)."""
    t1 = t1 / _l2_channel(t1)
    t2 = t2 / _l2_channel(t2)
    b, c = t1.shape[0], t1.shape[-1]
    f1 = torch.movedim(t1, -1, 1).reshape(b, c, -1)
    f2 = torch.movedim(t2, -1, 1).reshape(b, c, -1)
    num = (f1 * f2).sum(2)
    den = torch.linalg.norm(f1, dim=2) * torch.linalg.norm(f2, dim=2)
    return (1.0 - num / den.clamp(min=1e-8)).mean()


def smooth_l1(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                       diff - 0.5 * beta).mean()


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
        loss = 0.0
        feature_teacher = feature_teacher.detach()
        if self.lambda_structure > 0:
            loss = loss + self.lambda_structure * pairwise_loss_after_pool(
                feature_student, feature_teacher, scale=0.5)
        distilled = self.distill(
            feature_student.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        if self.lambda_l1 > 0:
            loss = loss + self.lambda_l1 * smooth_l1(distilled,
                                                     feature_teacher)
        if self.lambda_cosine > 0:
            loss = loss + self.lambda_cosine * cosine_distance_loss(
                distilled, feature_teacher)
        return loss
