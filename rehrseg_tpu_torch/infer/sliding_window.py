"""Gaussian-weighted sliding-window inference engines
(``rehrseg_tpu.infer.sliding_window`` in PyTorch).

Tile the volume with step = patch * 0.5 (steps evenly redistributed), run
each tile as one batched forward of its mirror-TTA flips, accumulate
``prediction * gaussian`` in fp32 and argmax. The JAX package's jitted
``lax.scan`` over tiles becomes a Python loop over tiles here, and the
accumulators are updated in place.

Two tile grids:

  - the parity grid (:func:`sliding_window_starts`), bit-identical to the
    reference's, with the flip combos in ``_flip_axes_combinations`` order;
  - the aligned grid (:func:`aligned_sliding_window_starts`): H starts
    snapped to multiples of 8 and W starts to multiples of 128, the volume
    padded just enough and the result cropped back. Its model emits
    per-class planes for a z-grouped mirror batch and K2
    (:func:`rehrseg_tpu_torch.ops.tail.accumulate_tta_tile`) does unmirror,
    mean, gaussian weight and accumulate in one pass. Its labels differ
    from the parity grid's by design.

``model_fn(batch)`` maps a (B, pd, ph, pw, C) batch to logits; unlike the
JAX engines it takes no params argument (a torch model holds its own).
The volume is uploaded as bf16 by default, as the JAX engines do, whatever
the compute dtype.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.gaussian import compute_gaussian
from ..ops.tail import accumulate_tta_tile, zgrouped_combos
from ..utils.device import resolve_device


def compute_steps_for_sliding_window(image_size, tile_size, tile_step_size):
    """Evenly redistributed tile starts per dim (seg_utils.py:176-199)."""
    assert all(i >= j for i, j in zip(image_size, tile_size)), \
        "image size must be as large or larger than patch_size"
    assert 0 < tile_step_size <= 1

    target_step = [i * tile_step_size for i in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target_step, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_step_value = image_size[dim] - tile_size[dim]
        if num_steps[dim] > 1:
            actual = max_step_value / (num_steps[dim] - 1)
        else:
            actual = 1e13
        steps.append([int(np.round(actual * i)) for i in range(num_steps[dim])])
    return steps


def sliding_window_starts(image_size, patch_size, tile_step_size=0.5) -> np.ndarray:
    """All (z, y, x) tile start coordinates as an (N, 3) int32 array."""
    steps = compute_steps_for_sliding_window(image_size, patch_size,
                                             tile_step_size)
    starts = [(sx, sy, sz) for sx in steps[0] for sy in steps[1]
              for sz in steps[2]]
    return np.asarray(starts, dtype=np.int32)


def _flip_axes_combinations(ndim_spatial: int = 3):
    """Identity + all 2^n - 1 mirror combinations over spatial axes 0..n-1
    (reference mirror order, seg_utils.py:213-215)."""
    combos = [()]
    for i in range(ndim_spatial):
        combos.extend(itertools.combinations(range(ndim_spatial), i + 1))
    return combos


def _mirror_batch(tile: torch.Tensor, combos) -> torch.Tensor:
    """(D, H, W, C) -> (n_combos, D, H, W, C) stacking every flip."""
    return torch.stack([tile.flip(c) if c else tile for c in combos])


def _unmirror_mean(preds: torch.Tensor, combos) -> torch.Tensor:
    """Invert each flip and average over the TTA batch (in preds' dtype,
    summed in combo order, as the JAX engine does)."""
    acc = None
    for i, c in enumerate(combos):
        part = preds[i].flip(c) if c else preds[i]
        acc = part if acc is None else acc + part
    return acc / len(combos)


def _gaussian(out_patch, use_gaussian: bool, device) -> torch.Tensor:
    if use_gaussian:
        g = np.array(compute_gaussian(tuple(out_patch), 1.0 / 8, 10.0))
    else:
        g = np.ones(out_patch, dtype=np.float32)
    return torch.from_numpy(g).to(device)


def _upload(data: np.ndarray, input_dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    return t.to(device=device, dtype=input_dtype or torch.float32)


def _argmax_uint8(logits: torch.Tensor, dim: int = -1) -> np.ndarray:
    return logits.argmax(dim).to(torch.uint8).cpu().numpy()


@torch.no_grad()
def _run_sliding_window(model_fn: Callable, data: np.ndarray, patch_size,
                        slice_separation, tile_step_size, use_gaussian,
                        mirror, num_classes, input_dtype=torch.bfloat16,
                        need_weights: bool = True, device=None):
    """The tile loop; returns (logits (D*sep, H, W, C) fp32, weights or
    None) on the device. need_weights=False skips the weight accumulator:
    argmax(logits / weights) == argmax(logits) since the weights are
    strictly positive."""
    device = resolve_device(device)
    pd, ph, pw = (int(p) for p in patch_size)
    z_scale = int(slice_separation)
    od = pd * z_scale
    g = _gaussian((od, ph, pw), bool(use_gaussian), device)
    combos = _flip_axes_combinations(3) if mirror else [()]
    vol = _upload(data, input_dtype, device)
    out_shape = (vol.shape[0] * z_scale, vol.shape[1], vol.shape[2])
    logits = torch.zeros((*out_shape, num_classes), dtype=torch.float32,
                         device=device)
    weights = (torch.zeros(out_shape, dtype=torch.float32, device=device)
               if need_weights else None)
    for sx, sy, sz in sliding_window_starts(vol.shape[:3], (pd, ph, pw),
                                            tile_step_size).tolist():
        tile = vol[sx:sx + pd, sy:sy + ph, sz:sz + pw]
        preds = model_fn(_mirror_batch(tile, combos))
        pred = _unmirror_mean(preds, combos).float() * g[..., None]
        zo = sx * z_scale
        logits[zo:zo + od, sy:sy + ph, sz:sz + pw] += pred
        if need_weights:
            weights[zo:zo + od, sy:sy + ph, sz:sz + pw] += g
    return logits, weights


def predict_sliding_window_logits(model_fn: Callable, data: np.ndarray,
                                  patch_size: Sequence[int], *,
                                  slice_separation: int = 1,
                                  tile_step_size: float = 0.5,
                                  use_gaussian: bool = True,
                                  mirror: bool = True,
                                  num_classes: int = 2,
                                  input_dtype=torch.bfloat16,
                                  device=None) -> np.ndarray:
    """Full sliding-window prediction of one volume. model_fn maps
    (B, pd, ph, pw, C) -> (B, pd*slice_separation, ph, pw, num_classes).
    data: (D, H, W, C) numpy, already normalized. Returns
    (D*slice_separation, H, W, num_classes) fp32 logits."""
    logits, weights = _run_sliding_window(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, device=device)
    logits = (logits / weights[..., None]).cpu().numpy()
    if np.any(np.isinf(logits)):
        raise RuntimeError("Encountered inf in predicted array.")
    return logits


def predict_sliding_window_labels(model_fn: Callable, data: np.ndarray,
                                  patch_size: Sequence[int], *,
                                  slice_separation: int = 1,
                                  tile_step_size: float = 0.5,
                                  use_gaussian: bool = True,
                                  mirror: bool = True,
                                  num_classes: int = 2,
                                  input_dtype=torch.bfloat16,
                                  device=None) -> np.ndarray:
    """Like :func:`predict_sliding_window_logits` but returns the uint8
    argmax label map (D*slice_separation, H, W)."""
    logits, _ = _run_sliding_window(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, need_weights=False,
        device=device)
    return _argmax_uint8(logits)


def predict_sliding_window_labels_many(model_fn: Callable, volumes,
                                       patch_size, *,
                                       slice_separation: int = 1,
                                       tile_step_size: float = 0.5,
                                       use_gaussian: bool = True,
                                       mirror: bool = True,
                                       num_classes: int = 2,
                                       input_dtype=torch.bfloat16,
                                       device=None):
    """Label maps of many volumes, in order."""
    return [predict_sliding_window_labels(
        model_fn, data, patch_size, slice_separation=slice_separation,
        tile_step_size=tile_step_size, use_gaussian=use_gaussian,
        mirror=mirror, num_classes=num_classes, input_dtype=input_dtype,
        device=device) for data in volumes]


@torch.no_grad()
def _dual_logits(model_fn: Callable, data: np.ndarray, patch_size,
                 slice_separation, tile_step_size, use_gaussian, mirror,
                 num_classes, input_dtype, device):
    """Dual-head tile loop: model_fn returns (lr_pred, hr_pred); both
    heads accumulate in one pass. Returns (LR, HR) logits on the device."""
    device = resolve_device(device)
    pd, ph, pw = (int(p) for p in patch_size)
    sep = int(slice_separation)
    g_lr = _gaussian((pd, ph, pw), bool(use_gaussian), device)
    g_hr = _gaussian((pd * sep, ph, pw), bool(use_gaussian), device)
    combos = _flip_axes_combinations(3) if mirror else [()]
    vol = _upload(data, input_dtype, device)
    d, h, w = vol.shape[:3]
    llr = torch.zeros((d, h, w, num_classes), dtype=torch.float32,
                      device=device)
    lhr = torch.zeros((d * sep, h, w, num_classes), dtype=torch.float32,
                      device=device)
    for sx, sy, sz in sliding_window_starts((d, h, w), (pd, ph, pw),
                                            tile_step_size).tolist():
        tile = vol[sx:sx + pd, sy:sy + ph, sz:sz + pw]
        p_lr, p_hr = model_fn(_mirror_batch(tile, combos))
        pred_lr = _unmirror_mean(p_lr, combos).float()
        pred_hr = _unmirror_mean(p_hr, combos).float()
        llr[sx:sx + pd, sy:sy + ph, sz:sz + pw] += pred_lr * g_lr[..., None]
        zo = sx * sep
        lhr[zo:zo + pd * sep, sy:sy + ph, sz:sz + pw] += \
            pred_hr * g_hr[..., None]
    return llr, lhr


def predict_sliding_window_dual_labels(model_fn: Callable, data: np.ndarray,
                                       patch_size, *, slice_separation: int,
                                       tile_step_size: float = 0.5,
                                       use_gaussian: bool = True,
                                       mirror: bool = True,
                                       num_classes: int = 2,
                                       input_dtype=torch.bfloat16,
                                       device=None):
    """One-pass LR+HR prediction: returns (lr_labels, hr_labels) uint8.
    model_fn(batch) -> (lr_logits, hr_logits), HR z-upscaled by
    slice_separation."""
    llr, lhr = _dual_logits(model_fn, data, patch_size, slice_separation,
                            tile_step_size, use_gaussian, mirror,
                            num_classes, input_dtype, device)
    return _argmax_uint8(llr), _argmax_uint8(lhr)


# --------------------------------------------------------------- aligned grid

_ALIGN_HW = (8, 128)


def aligned_sliding_window_starts(image_size, patch_size,
                                  tile_step_size=0.5):
    """Aligned tile grid. Returns (starts (N, 4) int32 rows of
    (sx, sy, sz, valid), padded_size (D, H', W')). Raises ValueError where
    snapping cannot cover every voxel (a patch narrower than the snap on a
    multi-tile axis)."""
    steps = compute_steps_for_sliding_window(image_size, patch_size,
                                             tile_step_size)
    out_steps = [list(steps[0])]
    padded = [int(image_size[0])]
    for dim, snap in zip((1, 2), _ALIGN_HW):
        n = len(steps[dim])
        if n == 1:
            out_steps.append([0])
            padded.append(int(image_size[dim]))
            continue
        span = image_size[dim] - patch_size[dim]
        span_pad = -(-span // snap) * snap
        actual = span_pad / (n - 1)
        ss = [int(np.round(actual * i / snap)) * snap for i in range(n)]
        ss[-1] = span_pad
        ss = sorted(set(ss))
        # coverage guard: rebuild the axis with the widest aligned step
        # that still covers when snapping opened a gap wider than the patch
        if any(b - a > patch_size[dim] for a, b in zip(ss, ss[1:])):
            max_step = patch_size[dim] // snap * snap
            if max_step == 0:
                raise ValueError(
                    f"aligned tile grid needs patch_size[{dim}] "
                    f"({patch_size[dim]}) >= its snap ({snap}) when the "
                    f"axis takes more than one tile; use the parity grid")
            ss = sorted(set(list(range(0, span_pad, max_step))
                            + [span_pad]))
        out_steps.append(ss)
        padded.append(int(patch_size[dim] + span_pad))
    starts = [(sx, sy, sz, 1) for sx in out_steps[0] for sy in out_steps[1]
              for sz in out_steps[2]]
    return np.asarray(starts, dtype=np.int32), tuple(padded)


def _mirror_batch_zgrouped(tile: torch.Tensor) -> torch.Tensor:
    return _mirror_batch(tile, zgrouped_combos())


def _aligned_prep(data, patch_size, tile_step_size, input_dtype, device):
    patch_size = tuple(int(p) for p in patch_size)
    starts, padded = aligned_sliding_window_starts(
        data.shape[:3], patch_size, tile_step_size)
    pads = [(0, padded[i] - data.shape[i]) for i in range(3)]
    if any(p[1] for p in pads):
        data = np.pad(data, pads + [(0, 0)])
    return _upload(data, input_dtype, device), starts.tolist(), patch_size


@torch.no_grad()
def _aligned_logits(model_fn: Callable, data: np.ndarray, patch_size, *,
                    slice_separation: int = 0, tile_step_size: float = 0.5,
                    use_gaussian: bool = True, num_classes: int = 2,
                    input_dtype=torch.bfloat16, device=None):
    """Aligned-grid tile loop over the padded volume; K2 accumulates each
    tile. slice_separation=0: LR only, model_fn returns planes (8, C, pd,
    ph, pw) and this returns the (C, D, H', W') logits; > 0: dual,
    model_fn returns (lr_planes, hr_planes) and this returns both
    accumulators, the HR one (C, D*sep, H', W')."""
    device = resolve_device(device)
    vol, starts, (pd, ph, pw) = _aligned_prep(data, patch_size,
                                              tile_step_size, input_dtype,
                                              device)
    shape = tuple(vol.shape[:3])
    sep = int(slice_separation)
    g_lr = _gaussian((pd, ph, pw), bool(use_gaussian), device)
    llr = torch.zeros((num_classes, *shape), dtype=torch.float32,
                      device=device)
    if sep:
        g_hr = _gaussian((pd * sep, ph, pw), bool(use_gaussian), device)
        lhr = torch.zeros((num_classes, shape[0] * sep, *shape[1:]),
                          dtype=torch.float32, device=device)
    for row in starts:
        sx, sy, sz = row[:3]
        batch = _mirror_batch_zgrouped(vol[sx:sx + pd, sy:sy + ph,
                                           sz:sz + pw])
        out = model_fn(batch)
        if sep:
            accumulate_tta_tile(llr, out[0].contiguous(), g_lr, row,
                                z_scale=1)
            accumulate_tta_tile(lhr, out[1].contiguous(), g_hr, row,
                                z_scale=sep)
        else:
            accumulate_tta_tile(llr, out.contiguous(), g_lr, row, z_scale=1)
    return (llr, lhr) if sep else llr


def predict_sliding_window_labels_aligned(model_fn: Callable,
                                          data: np.ndarray, patch_size, *,
                                          tile_step_size: float = 0.5,
                                          use_gaussian: bool = True,
                                          num_classes: int = 2,
                                          input_dtype=torch.bfloat16,
                                          device=None) -> np.ndarray:
    """Aligned-grid label prediction (always 8-way mirror TTA). model_fn
    emits per-class planes. Returns (D, H, W) uint8 cropped to the input
    size."""
    d0, h0, w0 = data.shape[:3]
    logits = _aligned_logits(model_fn, data, patch_size,
                             tile_step_size=tile_step_size,
                             use_gaussian=use_gaussian,
                             num_classes=num_classes,
                             input_dtype=input_dtype, device=device)
    return _argmax_uint8(logits, 0)[:d0, :h0, :w0]


def predict_sliding_window_labels_aligned_many(
        model_fn: Callable, volumes, patch_size, *,
        tile_step_size: float = 0.5, use_gaussian: bool = True,
        num_classes: int = 2, input_dtype=torch.bfloat16, device=None):
    """Aligned-grid label maps of many volumes, in order."""
    return [predict_sliding_window_labels_aligned(
        model_fn, data, patch_size, tile_step_size=tile_step_size,
        use_gaussian=use_gaussian, num_classes=num_classes,
        input_dtype=input_dtype, device=device) for data in volumes]


def predict_sliding_window_dual_labels_aligned(
        model_fn: Callable, data: np.ndarray, patch_size, *,
        slice_separation: int, tile_step_size: float = 0.5,
        use_gaussian: bool = True, num_classes: int = 2,
        input_dtype=torch.bfloat16, device=None):
    """One-pass aligned-grid LR+HR prediction with K2 on both heads.
    model_fn returns (lr_planes, hr_planes). Returns (lr_labels,
    hr_labels) uint8 cropped to the input size."""
    d0, h0, w0 = data.shape[:3]
    sep = int(slice_separation)
    llr, lhr = _aligned_logits(model_fn, data, patch_size,
                               slice_separation=sep,
                               tile_step_size=tile_step_size,
                               use_gaussian=use_gaussian,
                               num_classes=num_classes,
                               input_dtype=input_dtype, device=device)
    return (_argmax_uint8(llr, 0)[:d0, :h0, :w0],
            _argmax_uint8(lhr, 0)[:d0 * sep, :h0, :w0])
