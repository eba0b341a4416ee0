"""Fold evaluation and the stage-2 model's geometry (from
``rehrseg_tpu.pipeline``).

:func:`evaluate` is the reference's fold evaluation (train_all.py:154-193):
each subject of a split through the sliding window, per-subject and global
dice, optional NIfTI outputs. It runs the packed SegModel forward with K1
at every decoder concat (``pallas_conv="cat"``) in the model's own dtype:
a trainer's fp32 weights meet the bf16-uploaded volume in fp32 (the
forward promotes), so on the card K1 runs its fp32 kernel.

The ``Pipeline`` class (the three stages, resume by artifact) is still to
be ported (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import os

import numpy as np

from .config import Config, load_plans
from .infer.sliding_window import evaluate_case_volume
from .io import nifti
from .losses import calculate_dice
from .models import convert
from .models.segnet import arch_from_plans
from .models.segnet_packed import segmodel_apply_packed
from .utils.device import resolve_device


def seg_model_fns(seg_model, packed: bool = True):
    """(lr_fn, dual_fn) model closures over a SegModel for the engines:
    ``lr_fn(batch)`` gives the LR logits, ``dual_fn(batch)`` (LR, HR).
    packed: the space-to-depth packed forward with K1 at the decoder
    concat; else the module's own (unpacked) forward. Both read the
    module's parameters at each call, so they follow training updates and
    moves between devices."""
    if packed:
        arch = dict(seg_model.arch)
        upscale = seg_model.upscale

        def lr_fn(batch):
            return segmodel_apply_packed(
                arch, convert.flax_tree_from_module(seg_model), batch,
                pack_max_channels=64, pallas_conv="cat")

        def dual_fn(batch):
            return segmodel_apply_packed(
                arch, convert.flax_tree_from_module(seg_model), batch,
                pack_max_channels=64, dual=True, upscale=upscale,
                pallas_conv="cat")
    else:
        def dual_fn(batch):
            dtype = next(seg_model.parameters()).dtype
            return seg_model(batch.to(dtype))

        def lr_fn(batch):
            return dual_fn(batch)[0]
    return lr_fn, dual_fn


def evaluate(seg_model, patch_size, val_img_path, val_label_path, split,
             slice_separation, save_path=None, eval_hr=False, mirror=True,
             bad_cases=(), device=None):
    """Fold evaluation: per-subject and global dice; returns the mean of
    the per-subject dice.

    seg_model: the port's SegModel, moved to ``device`` (default the card)
    and run in its own dtype. bad_cases: subjects to skip. With
    ``save_path``, writes ``save_path/val/<subject>_pred_lr.nii.gz`` (and
    with ``eval_hr`` ``_pred_hr.nii.gz`` at z-spacing / slice_separation)
    with the input's geometry."""
    device = resolve_device(device)
    seg_model.to(device)
    all_dice, all_pred, all_label = [], [], []
    lr_fn, dual_fn = seg_model_fns(seg_model)

    for subject in split:
        if subject in bad_cases:
            continue
        img_path = os.path.join(val_img_path, subject + "_0000.nii.gz")
        lab_path = os.path.join(val_label_path, subject + ".nii.gz")
        ref = nifti.read_image_itk(img_path)  # (z, y, x)
        lab = nifti.read_image_itk(lab_path).array.astype(np.uint8)
        pred_lr, pred_hr, dice = evaluate_case_volume(
            lr_fn, ref.array.astype(np.float32), lab, patch_size,
            slice_separation=int(slice_separation),
            dual_model_fn=dual_fn if eval_hr else None, mirror=mirror,
            device=device)
        if save_path is not None:
            os.makedirs(os.path.join(save_path, "val"), exist_ok=True)
            nifti.write_image_itk(
                nifti.ItkLikeImage(pred_lr, ref.spacing, ref.origin,
                                   ref.direction),
                os.path.join(save_path, "val", f"{subject}_pred_lr.nii.gz"))
            if eval_hr:
                sp = ref.spacing
                nifti.write_image_itk(
                    nifti.ItkLikeImage(
                        pred_hr, (sp[0], sp[1], sp[2] / slice_separation),
                        ref.origin, ref.direction),
                    os.path.join(save_path, "val",
                                 f"{subject}_pred_hr.nii.gz"))
        all_pred.append(pred_lr.flatten())
        all_label.append(lab.flatten())
        all_dice.append(dice)
        print(f"Subject {subject}: {dice}")
    if not all_dice:
        raise ValueError(
            "evaluate(): no subjects evaluated — the validation split is "
            f"empty after skipping bad_cases ({len(split)} subjects in, "
            f"{len(bad_cases)} bad_cases)")
    print(f"Global dice: {calculate_dice(np.concatenate(all_pred), np.concatenate(all_label))}")
    print(f"Average dice: {sum(all_dice) / len(all_dice)}")
    return sum(all_dice) / len(all_dice)


def seg_arch_and_patches(cfg: Config):
    """Arch kwargs and patch sizes (``Pipeline._seg_arch_and_patches``):
    from ``extra["arch_override"]`` and ``extra["patch_size_zyx"]``, or
    from ``plans.json`` under ``cfg.seg_path``. Returns (arch,
    patch_size_zyx, patch_xyz, patch_ori); the reference's patch math
    (train_all.py:469-470): patch (x, y, z) = reversed plans patch, crop
    patch (x + 64, y + 64, z)."""
    arch_override = (cfg.extra or {}).get("arch_override")
    if arch_override is not None:
        arch = dict(arch_override)
        arch["kernel_sizes"] = tuple(tuple(k) for k in arch["kernel_sizes"])
        arch["strides"] = tuple(tuple(s) for s in arch["strides"])
        arch["features_per_stage"] = tuple(arch["features_per_stage"])
        arch["n_conv_per_stage"] = tuple(arch["n_conv_per_stage"])
        arch["n_conv_per_stage_decoder"] = tuple(
            arch["n_conv_per_stage_decoder"])
        patch_size_zyx = list(cfg.extra["patch_size_zyx"])
    else:
        arch, patch_size_zyx = arch_from_plans(load_plans(cfg.seg_path))
    patch_xyz = patch_size_zyx[::-1]
    patch_ori = [patch_xyz[0] + 64, patch_xyz[1] + 64, patch_xyz[2]]
    return arch, patch_size_zyx, patch_xyz, patch_ori
