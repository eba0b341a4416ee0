"""Fold evaluation, the stage-2 model's geometry and the stage-2 training
loop (from ``rehrseg_tpu.pipeline``), as functions of a :class:`Config`.

:func:`evaluate` is the reference's fold evaluation (train_all.py:154-193):
each subject of a split through the sliding window, per-subject and global
dice, optional NIfTI outputs. It runs the packed SegModel forward with K1
at every decoder concat (``pallas_conv="cat"``) in the model's own dtype:
a trainer's fp32 weights meet the bf16-uploaded volume in fp32 (the
forward promotes), so on the card K1 runs its fp32 kernel.

:func:`stage2_segsr` is ``Pipeline.stage2_segsr`` (train_all.py:459-577):
the SegModel (warm-started from the fold's nnUNet checkpoint when there is
one), the distiller and the frozen FLAVR teacher, the stage-2 dataset with
the device augmentation, the poly-epoch SGD, resume, periodic evaluation
with a ``best`` tag, preemption saves and a profile window.

The rest of the ``Pipeline`` class (stages 0-1, resume by artifact, fold
parallelism, more than one process) is still to be ported (ROADMAP queue
1, item 10).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import config as _config
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


# ------------------------------------------------------------ stage 2

def pipeline_paths(cfg: Config) -> dict:
    """The stage directories ``Pipeline.__init__`` builds (pipeline.py
    :283-297), created."""
    c = cfg
    paths = {
        "merge_data": os.path.join(c.tmp_path, "data_merged"),
        "sr_h5": os.path.join(c.tmp_path, "data_merged_sr_h5"),
        "flavr_output": os.path.join(c.tmp_path, "flavr_output"),
        "segsr_h5": os.path.join(c.tmp_path, "data_merged_segsr_h5"),
        "smore_ckpt": os.path.join(c.checkpoint_path, "smore"),
        "flavr_ckpt": os.path.join(c.checkpoint_path, "flavr"),
        "flavr_unc_ckpt": os.path.join(c.checkpoint_path,
                                       "flavr_uncertainty"),
        "segsr_ckpt": os.path.join(c.checkpoint_path, "segsr"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def split_subjects(cfg: Config):
    """(train, val) subjects: every subject of ``data_path`` and no
    validation without a fold, else the fold of nnUNet's splits."""
    if cfg.fold is None or cfg.fold == "all":
        return [s.replace("_0000.nii.gz", "").replace(".nii.gz", "")
                for s in sorted(os.listdir(cfg.data_path))], None
    splits = _config.load_splits(cfg.seg_path)
    return splits[cfg.fold]["train"], splits[cfg.fold]["val"]


def _make_loader(cfg: Config, ds, batch_size: int):
    """The training batch loader: one background thread over the seeded
    stream (the JAX package's PrefetchLoader(BatchLoader) branch)."""
    from .data.datasets import BatchLoader, PrefetchLoader

    if int((cfg.extra or {}).get("loader_workers", 0) or 0) > 0:
        raise NotImplementedError(
            "loader_workers > 0 (MultiprocessBatchLoader) is still to be "
            "ported (ROADMAP queue 1, item 10)")
    return PrefetchLoader(BatchLoader(ds, batch_size))


def _init_seg_params(cfg: Config, seg, arch, fold) -> None:
    """Seeded SegModel weights, warm-started from the fold's nnUNet
    checkpoint when present (train_all.py:496-499); fails on a < 90 %
    match unless ``extra.allow_partial_warmstart``."""
    from .train import torch_import

    convert.load_flax_params(seg, convert.random_flax_params(
        arch, 0, num_classes=seg.num_classes))
    resume_seg = os.path.join(cfg.seg_path, f"fold_{fold}",
                              "checkpoint_final.pth")
    if os.path.exists(resume_seg):
        sd = torch_import.load_torch_state_dict(resume_seg)
        ap = (cfg.extra or {}).get("allow_partial_warmstart")
        report = torch_import.import_segmodel(
            seg, sd, allow_partial=bool(ap) if ap is not None else None)
        print(f"nnUNet warm start (fold {fold}): "
              f"loaded {len(report.loaded_keys)} tensors "
              f"(match {report.match_rate:.0%})")


def _make_distiller(cfg: Config, arch):
    from .models.distiller import Distiller

    student_dim = arch["features_per_stage"][1]
    dist = Distiller(student_dim=student_dim, teacher_dim=64,
                     lambda_l1=cfg.lambda_l1,
                     lambda_cosine=cfg.lambda_cosine,
                     lambda_structure=cfg.lambda_structure)
    convert.load_flax_distiller_params(dist, convert.random_distiller_params(
        3, student_dim=student_dim))
    return dist


def _ensure_flavr_teacher(cfg: Config, flavr_model, paths):
    """The frozen FLAVR teacher: the caller's, or one restored from the
    latest stage-1 checkpoint (the uncertainty model's first), else seeded
    weights."""
    from .models.flavr import UNet3D
    from .train import checkpoint as ckpt

    if flavr_model is not None:
        return flavr_model
    flavr_model = UNet3D(img_channels=2, n_inputs=cfg.num_slices,
                         n_outputs=int(cfg.slice_separation),
                         use_uncertainty=cfg.enable_uncertainty)
    convert.load_flax_flavr_params(flavr_model, convert.random_flavr_params(
        0, n_inputs=cfg.num_slices, n_outputs=int(cfg.slice_separation),
        use_uncertainty=cfg.enable_uncertainty), cfg.enable_uncertainty)
    src = (paths["flavr_unc_ckpt"]
           if ckpt.has_checkpoint(paths["flavr_unc_ckpt"])
           else paths["flavr_ckpt"])
    if ckpt.has_checkpoint(src):
        p = ckpt.restore_checkpoint_raw(src)["params"]
        flavr_model.load_state_dict(p, strict=True)
    return flavr_model


def _remat_mode(cfg: Config):
    """extra.remat: auto (default; probe none -> hires on the card), all,
    hires or none."""
    mode = str((cfg.extra or {}).get("remat", "auto")).lower()
    if mode in ("none", "false", "off"):
        return False
    if mode in ("hires", "auto"):
        return mode
    return True


def _sr_head_form(cfg: Config) -> str:
    return str((cfg.extra or {}).get("sr_head_form", "auto")).lower()


def stage2_segsr(cfg: Config, *, flavr_model=None, dataset=None,
                 device=None):
    """Stage-2 training (``Pipeline.stage2_segsr``); returns (seg model,
    train state, best val dice).

    dataset: a :class:`.data.datasets.SegSRDataset` to train on in place
    of the stage-1 HDF5 stores under ``tmp_path``; flavr_model: the
    distillation teacher (else restored from the stage-1 checkpoints).
    Runs on ``device`` (default the card). Checkpoints go to
    ``<checkpoint_path>/segsr`` (resumed from there), metrics to its
    ``metrics.jsonl``; every ``save_iters_segsr`` steps the validation
    subjects are evaluated with the enlarged patch and an improved dice
    tags a ``best`` checkpoint. A SIGTERM / SIGINT saves and raises
    :class:`.utils.preemption.TrainingPreempted`. ``extra.profile_dir``
    traces steps 5-10 with torch.profiler."""
    from .data.datasets import SegSRDataset
    from .models.segnet import SegModel
    from .train import checkpoint as ckpt
    from .train.optim import (nesterov_sgd, nesterov_sgd_grouped,
                              poly_epoch_schedule)
    from .train.seg_trainer import (REMAT_NAMES, SegBatch,
                                    make_seg_train_step, select_remat_mode)
    from .train.state import TrainState
    from .utils.metrics import MetricsLogger
    from .utils.preemption import PreemptionGuard, TrainingPreempted
    from .utils.timer import StepTimer

    c = cfg
    ex = c.extra or {}
    if int(ex.get("mesh_spatial", 1) or 1) > 1:
        raise NotImplementedError(
            "mesh_spatial > 1 (spatially sharded training) is still to be "
            "ported (ROADMAP queue 1, item 10)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "multi-process training is still to be ported (ROADMAP queue "
            "1, item 10)")
    device = resolve_device(device)
    paths = pipeline_paths(c)
    sep = int(c.slice_separation)
    arch, patch_size_zyx, patch_xyz, patch_ori = seg_arch_and_patches(c)
    precision = str(ex.get("precision", "bf16"))
    eval_mirror = bool(ex.get("eval_mirror", True))

    seg = SegModel(num_classes=2, upscale=sep, input_channels=1, arch=arch)
    _init_seg_params(c, seg, arch, c.fold)
    seg.to(device)
    params = seg
    if c.enable_distillation:
        dist = _make_distiller(c, arch).to(device)
        params = {"seg": seg, "distiller": dist}
        flavr_model = _ensure_flavr_teacher(c, flavr_model, paths).to(device)

    train_subjects, val_subjects = split_subjects(c)
    # device augmentation is the default; the host chain (device_augment:
    # false) is the parity oracle
    device_augment = bool(ex.get("device_augment", True))
    ds = dataset
    if ds is None:
        ds = SegSRDataset(paths["segsr_h5"], train_subjects,
                          c.slice_thickness, c.target_thickness, patch_ori,
                          patch_xyz, c.random_flip, c.enable_uncertainty,
                          device_augment=device_augment)
    elif bool(ds.device_augment) != device_augment:
        raise ValueError(f"dataset.device_augment={ds.device_augment} but "
                         f"the config asks for {device_augment}")
    loader = _make_loader(c, ds, c.batch_size_segsr)
    aug_gen = None
    if device_augment:
        from .data.device_aug import augment_seg_batch
        patch_hw = (patch_xyz[1], patch_xyz[0])    # in-plane (y, x)
        aug_gen = torch.Generator(device=device).manual_seed(0)
    iters_per_epoch = max(len(ds) // c.batch_size_segsr, 1)
    sched = poly_epoch_schedule(c.lr_segsr, c.epochs, iters_per_epoch)
    # KD: one uniform SGD over both modules (train_all.py:511-513); else
    # the SR head at the full lr, the rest at 0.1x without weight decay
    opt = nesterov_sgd(params) if c.enable_distillation \
        else nesterov_sgd_grouped(seg)
    state = TrainState(params, opt, sched)
    if ckpt.has_checkpoint(paths["segsr_ckpt"]):
        state.restore(paths["segsr_ckpt"])

    def make_step(remat_mode):
        return make_seg_train_step(
            seg, enable_uncertainty=c.enable_uncertainty,
            enable_distillation=c.enable_distillation,
            flavr_model=flavr_model,
            teacher_window_chunk=ex.get("teacher_window_chunk"),
            remat=remat_mode, precision=precision,
            sr_head_form=_sr_head_form(c))

    remat_mode = _remat_mode(c)
    step_fn = None if remat_mode == "auto" else make_step(remat_mode)
    total_steps = c.epochs * iters_per_epoch
    mlog = MetricsLogger(paths["segsr_ckpt"])
    # the best-dice watermark survives a resume
    best_dice = mlog.max_on_disk("val_dice")
    timer = StepTimer()
    profile_dir = ex.get("profile_dir")
    prof = None
    print(f"TRAINING NETWORK REHRSeg ({total_steps} steps)")
    guard = PreemptionGuard()
    start_it = int(state.step)

    def upload(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    try:
        with guard:
            for it in range(start_it, total_steps):
                if profile_dir and it == start_it + 5:
                    prof = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if device.type == "cuda" else []))
                    prof.start()
                if prof is not None and it == start_it + 10:
                    _stop_profile(prof, profile_dir)
                    prof = None
                if guard.should_stop:
                    state.save(paths["segsr_ckpt"])
                    raise TrainingPreempted(int(state.step))
                timer.start()
                b = loader.next()
                arrays = [upload(b[k]) for k in ("img", "label_lr",
                                                 "label_hr",
                                                 "uncertainty_lr")]
                if aug_gen is not None:
                    arrays = augment_seg_batch(
                        aug_gen, *arrays, patch_hw=patch_hw,
                        enable_uncertainty=c.enable_uncertainty)
                batch = SegBatch(*arrays)
                if step_fn is None:
                    mode, why = select_remat_mode(make_step, state, batch)
                    print(f"remat auto-select: {REMAT_NAMES[mode]} ({why})")
                    step_fn = make_step(mode)
                state, metrics = step_fn(state, batch)
                timer.stop()
                if (it + 1) % 100 == 0 or it + 1 == total_steps:
                    mlog.log(it + 1, loss=float(metrics["loss"]),
                             lr=float(sched(it)), step_time_s=timer.mean())
                if (it + 1) % c.save_iters_segsr == 0:
                    if val_subjects:
                        # the reference evaluates with the ENLARGED patch
                        # (x+64, y+64, z) reversed (train_all.py:563,165)
                        val_dice = evaluate(
                            seg, patch_ori[::-1], c.data_path,
                            c.data_path.replace("imagesTr", "labelsTr"),
                            val_subjects, c.slice_separation,
                            mirror=eval_mirror, device=device)
                        print(f"Eval result: {val_dice}")
                        mlog.log(it + 1, val_dice=float(val_dice))
                        if val_dice > best_dice:
                            state.save(paths["segsr_ckpt"], tag="best")
                        best_dice = max(best_dice, val_dice)
                    state.save(paths["segsr_ckpt"])
            if guard.should_stop:
                state.save(paths["segsr_ckpt"])
                raise TrainingPreempted(int(state.step))
    finally:
        if prof is not None:   # the loop ended inside the trace window
            _stop_profile(prof, profile_dir)
        loader.close()
    state.save(paths["segsr_ckpt"], step=total_steps)
    return seg, state, best_dice


def _stop_profile(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
