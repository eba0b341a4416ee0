"""LR simulation on the device for stage-1 SR training
(``rehrseg_tpu.data.device_sr_sim``).

The reference simulates each LR patch on the host: a rational B-spline
downsample of the blurred image (order 3) and the label (order 0) along
the through-plane axis, then a random zero-out of the first / last
context slice (train_set.py:394-408). Here the downsample is one matmul
with the host-built resize matrix over the whole batch on its device, and
the dropout draws from a ``torch.Generator``.

The host loader flips and transposes after the resize; the centred resize
matrix commutes with a flip along the resized axis and the transpose
never touches it, so flipping first and resizing on the device last gives
the same numbers. The dropout then hits the post-flip first / last slice,
a symmetric difference with the same distribution.
"""

from __future__ import annotations

import torch

from ..ops.bspline import resize_1d
from .device_aug import global_rows, shard_rows


def simulate_lr_batch(gen, hr_source: torch.Tensor, slice_separation: float,
                      zero_dropout: bool = True, draws=None, shard=None):
    """hr_source: (B, X, Z, Y, 2) (FLAVR) or (B, X, Y, 2) (WDSR), channel
    0 the (pre-blurred) image, channel 1 the label. Returns the LR batch,
    X downsampled by ``slice_separation``.

    The zero-slice dropout (p = 0.1 each for the first and the last
    slice, FLAVR batches with more than one slice only) draws two uniform
    (B,) vectors from ``gen``, a generator on the batch's device; or takes
    them as ``draws`` = (first, last). shard=(index, count): the batch is
    this process's slice of a global batch; the vectors are drawn for the
    global batch and this slice's rows used."""
    img = resize_1d(hr_source[..., 0:1], slice_separation, axis=1, order=3)
    lab = resize_1d(hr_source[..., 1:], slice_separation, axis=1, order=0)
    out = torch.cat([img, lab], dim=-1)
    if zero_dropout and hr_source.ndim == 5 and hr_source.shape[2] > 1:
        b = out.shape[0]
        if draws is None:
            draws = tuple(shard_rows(
                torch.rand(global_rows(b, shard), generator=gen,
                           device=out.device), shard) for _ in range(2))
        for idx, u in ((0, draws[0]), (-1, draws[1])):
            u = torch.as_tensor(u, device=out.device)
            drop = (u < 0.1)[:, None, None, None]
            out[:, idx] = torch.where(drop, torch.zeros_like(out[:, idx]),
                                      out[:, idx])
    return out
