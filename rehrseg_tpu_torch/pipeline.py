"""The three-stage REHRSeg pipeline (``rehrseg_tpu.pipeline``; the
reference's train_all.py) as functions of a :class:`Config`, resumable by
artifact:

  preprocess   :func:`merge_images_and_labels`: image + label NIfTIs into
               2-channel volumes with pixdim (1, 1, 4) (train_all.py:34-62);
  stage 1a     :func:`stage1a_smore`: WDSR self-SR on in-plane patches (or
               the cubic / nearest zoom without SMORE), per-subject HDF5
               stores with the blurred training copies and the SMORE
               NIfTIs (train_all.py:265-330);
  stage 1b     :func:`stage1b_flavr`: FLAVR through-plane interpolation,
               warm-started from ``pretrain_path`` with the stem, outconv
               and feature_fuse dropped (train_all.py:332-397);
  stage 1c     :func:`stage1c_uncertainty`: FLAVR with the UASR head,
               warm-started from stage 1b's weights without outconv and
               feature_fuse (the fix of the reference's quirk Q2), and the
               uncertainty volumes (train_all.py:399-455);
  postprocess  :func:`postprocess_flavr`: image / seg / uncertainty into
               the stage-2 HDF5 stores (train_all.py:457-462);
  stage 2      :func:`stage2_segsr`: the SegModel (warm-started from the
               fold's nnUNet checkpoint when there is one), the distiller
               and the frozen FLAVR teacher, the stage-2 dataset with the
               device augmentation, the poly-epoch SGD, resume, periodic
               :func:`evaluate` with a ``best`` tag, preemption saves and a
               profile window (train_all.py:459-577).

:func:`run` chains them and :func:`main` (``python -m
rehrseg_tpu_torch.cli``) checks the paths first. :func:`evaluate` is the
fold evaluation (train_all.py:154-193): the packed SegModel forward with
K1 at every decoder concat in the model's own dtype, so a trainer's fp32
weights run K1's fp32 kernel on the card.

Entry points run on the card unless the caller passes ``device``. The
stage-1 loops take ``dataset=`` in place of the HDF5 stores. More than one
process (``dp_mesh``, ``--fold all``, ``loader_workers``, ``mesh_spatial``)
is still to be ported (ROADMAP queue 1, item 10b).
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path

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


def _make_loader(cfg: Config, ds, batch_size: int, device=None):
    """The training batch loader, chosen as the JAX package chooses: the
    :class:`.data.device_sampler.DeviceSRPatchSampler` (volumes resident
    on ``device``) where the dataset is of its kind and
    ``extra.device_sampler`` (default true) allows it; else one background
    thread over the seeded host stream."""
    from .data.datasets import BatchLoader, PrefetchLoader

    ex = cfg.extra or {}
    if bool(ex.get("device_sampler", True)):
        from .data.device_sampler import DeviceSRPatchSampler
        try:
            return DeviceSRPatchSampler(ds, batch_size,
                                        device=resolve_device(device))
        except (ValueError, AttributeError):
            pass
    if int(ex.get("loader_workers", 0) or 0) > 0:
        raise NotImplementedError(
            "loader_workers > 0 (MultiprocessBatchLoader) is still to be "
            "ported (ROADMAP queue 1, item 10b)")
    return PrefetchLoader(BatchLoader(ds, batch_size))


# ------------------------------------------------------------ stage 0

def merge_images_and_labels(main_dir: str, output_dir: str) -> None:
    """Stack each image and its label into a 2-channel NIfTI with pixdim
    (1, 1, 4, 1) (train_all.py:34-62); subjects already merged, without a
    label or of another shape are skipped."""
    os.makedirs(output_dir, exist_ok=True)
    subjects = sorted(os.listdir(main_dir))
    print(f"Merging images and labels for a total of {len(subjects)} "
          f"subjects")
    for name in subjects:
        out_path = os.path.join(output_dir, name)
        if os.path.exists(out_path):
            continue
        img_path = os.path.join(main_dir, name)
        label_path = img_path.replace("imagesTr", "labelsTr").replace(
            "_0000.nii.gz", ".nii.gz")
        if not os.path.exists(label_path):
            print(f"Segmentation label file not found for {name}")
            continue
        img = nifti.load(img_path).get_fdata(np.float32)
        lab = nifti.load(label_path).get_fdata(np.float32)
        if img.shape != lab.shape:
            print(f"Shape mismatch between main image {name} and label")
            continue
        merged = np.stack([img, lab], axis=-1).astype(np.float32)
        affine = np.diag([1.0, 1.0, 4.0, 1.0])
        nd = merged.ndim
        header = nifti.NiftiHeader(
            dim=(nd, *merged.shape, *([1] * (7 - nd))),
            pixdim=(1.0, 1.0, 1.0, 4.0, 1.0, 1.0, 1.0, 1.0),
            dtype=merged.dtype, affine=affine)
        nifti.save(nifti.NiftiImage(data=merged, affine=affine,
                                    header=header), out_path)


def preprocess(cfg: Config) -> None:
    """Stage 0: the merged 2-channel volumes under ``tmp_path``."""
    merge_images_and_labels(cfg.data_path,
                            pipeline_paths(cfg)["merge_data"])


# ------------------------------------------------------------ stage 1

def _train_sr_loop(state, loader, step_fn, n_steps: int, save_iters: int,
                   weight_dir: str, *, device, log_every: int = 100,
                   lr_sim_sep=None, dp_mesh=None, hr_aug: bool = False):
    """The stage-1 training loop (``rehrseg_tpu.pipeline._train_sr_loop``)
    from ``state.step`` to ``n_steps``; returns the state.

    lr_sim_sep: batches carry the pre-resize LR sources and the rational
    downsample with the slice dropout runs on ``device``
    (:mod:`.data.device_sr_sim`, a generator seeded 17). hr_aug: the
    stage-1 intensity augmentation of the HR target's image channel on the
    device (``augment_sr_hr_batch``, a generator seeded 23). The loss is
    read, and logged with the lr and the step time to
    ``<weight_dir>/metrics.jsonl``, every ``log_every`` steps only, so
    steps chain without a sync between. A checkpoint is saved every
    ``save_iters`` steps and at the end; a SIGTERM / SIGINT saves and
    raises :class:`.utils.preemption.TrainingPreempted`. The loader is
    closed on every exit."""
    from .data.device_aug import augment_sr_hr_batch
    from .data.device_sr_sim import simulate_lr_batch
    from .utils.metrics import MetricsLogger
    from .utils.preemption import PreemptionGuard, TrainingPreempted

    if dp_mesh is not None:
        raise NotImplementedError(
            "dp_mesh (data-parallel stage-1 training) is still to be "
            "ported (ROADMAP queue 1, item 10b)")
    mlog = MetricsLogger(weight_dir)
    sim_gen = torch.Generator(device=device).manual_seed(17)
    aug_gen = (torch.Generator(device=device).manual_seed(23) if hr_aug
               else None)

    def upload(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.from_numpy(a).to(device, non_blocking=True)

    start_it = int(state.step)
    last_log_it, last_log_t = start_it, time.perf_counter()
    guard = PreemptionGuard()
    try:
        with guard:
            for it in range(start_it, n_steps):
                if guard.should_stop:
                    state.save(weight_dir)
                    raise TrainingPreempted(int(state.step))
                lr_b, hr_b = (upload(a) for a in loader.next())
                if aug_gen is not None:
                    hr_b = augment_sr_hr_batch(aug_gen, hr_b)
                if lr_sim_sep is not None:
                    lr_b = simulate_lr_batch(sim_gen, lr_b, float(lr_sim_sep))
                state, metrics = step_fn(state, lr_b, hr_b)
                if it > 0 and it % save_iters == 0:
                    state.save(weight_dir)
                if it % log_every == 0:
                    loss = float(metrics["loss"])
                    now = time.perf_counter()
                    dt = (now - last_log_t) / max(it - last_log_it, 1)
                    last_log_it, last_log_t = it, now
                    mlog.log(it, loss=loss, step_time_s=dt,
                             lr=float(state.schedule(it)))
                    print(f"  step {it}/{n_steps} loss={loss:.4f} "
                          f"(~{dt * 1e3:.0f} ms/step)")
            if guard.should_stop:
                state.save(weight_dir)
                raise TrainingPreempted(int(state.step))
    finally:
        if hasattr(loader, "close"):
            loader.close()
    state.save(weight_dir, step=n_steps)
    return state


def _precision(cfg: Config) -> str:
    return str((cfg.extra or {}).get("precision", "bf16"))


def _sr_infer_dtype(cfg: Config):
    """extra.sr_infer_dtype: fp32 (default) or bf16 for the stage-1 volume
    inference."""
    dt = str((cfg.extra or {}).get("sr_infer_dtype") or "").lower()
    if dt in ("bf16", "bfloat16"):
        return torch.bfloat16
    if dt in ("", "fp32", "float32", "none"):
        return None
    raise ValueError(f"unknown sr_infer_dtype {dt!r} (use 'bf16' or "
                     f"'fp32')")


def _sr_steps(cfg: Config) -> int:
    return int(math.ceil(cfg.n_patches / cfg.batch_size_sr))


def stage1a_smore(cfg: Config, *, device=None) -> None:
    """Stage 1a (``Pipeline.stage1a_smore``): per subject an HDF5 store
    under ``tmp_path/data_merged_sr_h5`` with the pseudo-HR image and
    label and their blurred copies.

    With ``smore_initialization`` the WDSR (``extra.wdsr_n_resblocks``,
    ``wdsr_num_channels``; ``extra.sr_mode`` 'img+seg' SRs image and
    label, 'img' the image alone and zooms the label) trains on in-plane
    patches of the merged volumes (checkpoints in
    ``checkpoint_path/smore``, resumed) and SRs each subject; its
    ``tmp_path/smore_output/<subject>_img`` (and ``_seg``) NIfTIs are
    written, and backfilled from the store when a run stopped between the
    two. Without it the volumes are zoomed along z (cubic image, nearest
    label). A stage whose artifacts all exist returns at once."""
    from .infer.sr_infer import (infer_wdsr_volume, interpolate_pseudo_sr,
                                 postprocess_sr_volume)
    from .io.volume import parse_image, read_h5, write_h5, write_sr_niftis
    from .models.wdsr import WDSR
    from .ops.bspline import zoom_axis_np
    from .train import checkpoint as ckpt
    from .train.optim import onecycle_adam
    from .train.sr_trainer import make_sr_train_step
    from .train.state import TrainState

    c = cfg
    ex = c.extra or {}
    paths = pipeline_paths(c)
    train_subjects, _ = split_subjects(c)
    sep = c.slice_separation
    smore_out = os.path.join(c.tmp_path, "smore_output")
    subjects = sorted(os.listdir(paths["merge_data"]))
    done = all(os.path.exists(os.path.join(paths["sr_h5"], s + ".h5"))
               for s in subjects)
    if done and c.smore_initialization:
        done = all(os.path.exists(os.path.join(
            smore_out, s.replace(".nii.gz", "") + "_img.nii.gz"))
            for s in subjects)
    if done and subjects:
        return

    if not c.smore_initialization:
        # the interpolation fallback (train_all.py:321-330): no SMORE
        # NIfTIs in this branch
        for subject in subjects:
            h5_path = os.path.join(paths["sr_h5"], subject + ".h5")
            if os.path.exists(h5_path):
                continue
            image, _, _, blur_fwhm, *_ = parse_image(
                os.path.join(paths["merge_data"], subject),
                c.slice_thickness, c.target_thickness)
            up_img, up_lab = interpolate_pseudo_sr(image[..., 0],
                                                   image[..., 1], sep)
            fx, fy = postprocess_sr_volume(up_img, blur_fwhm, c.blur_kernel)
            write_h5(h5_path, img_hr=up_img[..., None],
                     label_hr=up_lab[..., None].astype(np.uint8),
                     image_x_rgb=fx, image_y_rgb=fy)
        return

    device = resolve_device(device)
    sr_mode = str(ex.get("sr_mode", "img+seg"))
    n_ch = 1 if sr_mode == "img" else 2
    n_blocks = int(ex.get("wdsr_n_resblocks", 16))
    n_feats = int(ex.get("wdsr_num_channels", 32))
    model = WDSR(out_channel=n_ch, n_resblocks=n_blocks,
                 num_channels=n_feats, scale=sep)
    convert.load_flax_wdsr_params(model, convert.random_wdsr_params(
        0, out_channel=n_ch, n_resblocks=n_blocks, num_channels=n_feats,
        scale=sep))
    model.to(device)
    patch_size = model.calc_out_patch_size([c.patch_size, c.patch_size])
    n_steps = _sr_steps(c)
    opt, sched = onecycle_adam(model, c.lr_sr, n_steps)
    state = TrainState(model, opt, sched)
    if ckpt.has_checkpoint(paths["smore_ckpt"]):
        print("NETWORK SMORE TRAINED, LOADING LAST WEIGHTS")
        state.restore(paths["smore_ckpt"])
    if state.step < n_steps:
        print("TRAINING NETWORK SMORE")
        from .data.datasets import SRPatchDataset

        dev_sim = bool(ex.get("device_lr_sim", False))
        ds = SRPatchDataset(paths["merge_data"], train_subjects,
                            c.slice_thickness, c.target_thickness, None,
                            c.blur_kernel, patch_size, c.random_flip,
                            blur=True, nnunet_transform=False,
                            device_lr_sim=dev_sim, channels=n_ch)
        step_fn = make_sr_train_step(model, enable_uncertainty=False,
                                     slice_separation=sep, num_slices=1,
                                     precision=_precision(c))
        state = _train_sr_loop(
            state, _make_loader(c, ds, c.batch_size_sr, device), step_fn,
            n_steps, c.save_iters_sr, paths["smore_ckpt"], device=device,
            lr_sim_sep=sep if dev_sim else None)

    print("INFERENCE NETWORK SMORE")
    os.makedirs(smore_out, exist_ok=True)
    for subject in subjects:
        h5_path = os.path.join(paths["sr_h5"], subject + ".h5")
        out_base = os.path.join(smore_out, subject.replace(".nii.gz", ""))
        if os.path.exists(h5_path):
            if not os.path.exists(out_base + "_img.nii.gz"):
                ref = nifti.read_image_itk(os.path.join(c.data_path,
                                                        subject))
                # a run stopped between the store's write and the NIfTIs'
                # backfills them from the store
                img_hr, label_hr = read_h5(h5_path, "img_hr", "label_hr")
                write_sr_niftis(ref, out_base, sep, img_xyz=img_hr[..., 0],
                                seg_xyz=(label_hr[..., 0]
                                         if "seg" in sr_mode else None))
            continue
        ref = nifti.read_image_itk(os.path.join(c.data_path, subject))
        image, _, _, blur_fwhm, *_ = parse_image(
            os.path.join(paths["merge_data"], subject), c.slice_thickness,
            c.target_thickness)
        sr = infer_wdsr_volume(model, image[..., :n_ch].astype(np.float32),
                               sep, device=device)
        img_hr = sr[..., 0]
        if n_ch == 2:
            label_hr = (sr[..., 1] > 0).astype(np.uint8)
        else:
            # 'img' mode SRs no label: the merged label, nearest-zoomed,
            # keeps the stage-2 store complete
            label_hr = zoom_axis_np(image[..., 1] if image.shape[-1] > 1
                                    else np.zeros_like(image[..., 0]),
                                    sep, axis=2, order=0).astype(np.uint8)
            if label_hr.shape[2] < img_hr.shape[2]:
                label_hr = np.pad(
                    label_hr, ((0, 0), (0, 0),
                               (0, img_hr.shape[2] - label_hr.shape[2])),
                    mode="edge")
            label_hr = label_hr[:, :, :img_hr.shape[2]]
        write_sr_niftis(ref, out_base, sep, img_xyz=img_hr,
                        seg_xyz=label_hr if "seg" in sr_mode else None)
        fx, fy = postprocess_sr_volume(img_hr, blur_fwhm, c.blur_kernel)
        write_h5(h5_path, img_hr=img_hr[..., None],
                 label_hr=label_hr[..., None], image_x_rgb=fx,
                 image_y_rgb=fy)


def _make_flavr(cfg: Config, use_uncertainty: bool):
    """A UNet3D of the config's geometry with seeded weights (where the
    JAX package calls ``init`` with key 0)."""
    from .models.flavr import UNet3D

    kw = dict(n_inputs=cfg.num_slices, n_outputs=int(cfg.slice_separation),
              use_uncertainty=use_uncertainty)
    model = UNet3D(img_channels=2, **kw)
    convert.load_flax_flavr_params(
        model, convert.random_flavr_params(0, **kw), use_uncertainty)
    return model


def _flavr_dataset(cfg: Config, model, paths):
    """The stage-1b / 1c dataset over the stage-1a stores; with
    ``extra.device_augment_sr`` the intensity chain runs on the device in
    place of the host transforms."""
    from .data.datasets import SRPatchDataset

    c = cfg
    ex = c.extra or {}
    patch_size = model.calc_out_patch_size([c.num_slices, c.patch_size,
                                            c.patch_size])
    host_tf = c.nnunet_transform and not bool(ex.get("device_augment_sr",
                                                      False))
    return SRPatchDataset(paths["sr_h5"], split_subjects(c)[0],
                          c.slice_thickness, c.target_thickness, None,
                          c.blur_kernel, patch_size, c.random_flip,
                          blur=True, nnunet_transform=host_tf,
                          device_lr_sim=bool(ex.get("device_lr_sim",
                                                    False)))


def _train_flavr(cfg: Config, model, state, weight_dir, dataset, paths,
                 device, enable_uncertainty: bool, n_steps: int):
    """Stage 1b / 1c training from ``state.step`` to ``n_steps`` on
    ``dataset`` (else the stage-1a stores)."""
    from .train.sr_trainer import make_sr_train_step

    c = cfg
    ex = c.extra or {}
    dev_sim = bool(ex.get("device_lr_sim", False))
    ds = dataset if dataset is not None else _flavr_dataset(c, model, paths)
    if bool(ds.device_lr_sim) != dev_sim:
        raise ValueError(f"dataset.device_lr_sim={ds.device_lr_sim} but "
                         f"the config asks for {dev_sim}")
    step_fn = make_sr_train_step(model,
                                 enable_uncertainty=enable_uncertainty,
                                 slice_separation=c.slice_separation,
                                 num_slices=c.num_slices,
                                 precision=_precision(c))
    return _train_sr_loop(
        state, _make_loader(c, ds, c.batch_size_sr, device), step_fn,
        n_steps, c.save_iters_sr, weight_dir, device=device,
        lr_sim_sep=c.slice_separation if dev_sim else None,
        hr_aug=bool(ex.get("device_augment_sr", False)))


def stage1b_flavr(cfg: Config, *, dataset=None, device=None):
    """Stage 1b (``Pipeline.stage1b_flavr``): the FLAVR UNet3D, warm-started
    from ``pretrain_path`` when that file exists, trained to
    ``ceil(n_patches / batch_size_sr)`` steps (checkpoints in
    ``checkpoint_path/flavr``, resumed) on ``dataset`` (an
    :class:`.data.datasets.SRPatchDataset`; default the stage-1a stores),
    then each merged subject's ``tmp_path/flavr_output/<subject>_img`` and
    ``_seg`` NIfTIs (skipped where both exist). Returns (model, state)."""
    from .train import checkpoint as ckpt
    from .train import torch_import
    from .train.optim import onecycle_adam
    from .train.state import TrainState

    c = cfg
    device = resolve_device(device)
    paths = pipeline_paths(c)
    model = _make_flavr(c, False)
    if c.pretrain_path and os.path.exists(c.pretrain_path):
        report = torch_import.import_flavr(
            model, torch_import.load_torch_state_dict(c.pretrain_path))
        print(f"FLAVR warm start: loaded {len(report.loaded_keys)} tensors "
              f"(match {report.match_rate:.0%})")
    model.to(device)
    n_steps = _sr_steps(c)
    opt, sched = onecycle_adam(model, c.lr_sr, n_steps)
    state = TrainState(model, opt, sched)
    if ckpt.has_checkpoint(paths["flavr_ckpt"]):
        print("NETWORK FLAVR TRAINED, LOADING LAST WEIGHTS")
        state.restore(paths["flavr_ckpt"])
    if state.step < n_steps:
        print("TRAINING NETWORK FLAVR")
        state = _train_flavr(c, model, state, paths["flavr_ckpt"], dataset,
                             paths, device, False, n_steps)
    print("INFERENCE NETWORK FLAVR")
    _flavr_inference(c, model, paths, device, uncertainty=False)
    return model, state


def _flavr_inference(cfg: Config, model, paths, device, uncertainty: bool):
    """Each merged subject through the FLAVR volume inference, its NIfTIs
    written in the source geometry (``_img`` and ``_seg``, or
    ``_uncertainty``), skipped where they all exist. One subject deep:
    subject N's forward is enqueued before subject N-1 is fetched, restored
    and written, so the host's writes overlap the card's work; writes land
    in subject order."""
    from .infer.sr_infer import infer_flavr_volume_async, restore_intensity
    from .io.volume import parse_image, write_sr_niftis

    c = cfg
    sep = c.slice_separation
    dtype = _sr_infer_dtype(c)

    def flush(pend):
        finalize, subject, ref, out_base, omin, omax = pend
        out = restore_intensity(finalize(), omin, omax)
        if uncertainty:
            write_sr_niftis(ref, out_base, sep, unc_xyz=out[..., 0])
        else:
            write_sr_niftis(ref, out_base, sep, img_xyz=out[..., 0],
                            seg_xyz=out[..., 1])
            _log_sr_psnr(c, paths, subject, out[..., 0].transpose(2, 1, 0))

    pending = None
    for subject in sorted(os.listdir(paths["merge_data"])):
        base = os.path.join(paths["flavr_output"], subject)
        out_base = base.replace(".nii.gz", "")
        # keyed on every artifact of the pass: _img is written before
        # _seg, and a stop between the two must not skip the subject
        if (os.path.exists(out_base + "_uncertainty.nii.gz") if uncertainty
                else (os.path.exists(out_base + "_img.nii.gz")
                      and os.path.exists(out_base + "_seg.nii.gz"))):
            continue
        image, _, _, _, _, _, orig_min, orig_max = parse_image(
            os.path.join(paths["merge_data"], subject), c.slice_thickness,
            c.target_thickness)
        ref = nifti.read_image_itk(os.path.join(c.data_path, subject))
        finalize = infer_flavr_volume_async(
            model, image.astype(np.float32), sep,
            out_index=1 if uncertainty else 0, compute_dtype=dtype,
            device=device)
        if pending is not None:
            flush(pending)
        pending = (finalize, subject, ref, out_base, orig_min, orig_max)
    if pending is not None:
        flush(pending)


def _log_sr_psnr(cfg: Config, paths, subject: str, sr_img_zyx: np.ndarray):
    """The SR image's PSNR against ``extra.hr_reference_path/<subject>``
    when that HR volume exists (synthetic data has one, clinical LR data
    does not), appended to ``checkpoint_path/flavr/metrics.jsonl``."""
    from .losses import calculate_psnr
    from .utils.metrics import MetricsLogger

    hr_dir = (cfg.extra or {}).get("hr_reference_path")
    if not hr_dir:
        return
    hr_path = os.path.join(hr_dir, subject)
    if not os.path.exists(hr_path):
        return
    hr = nifti.read_image_itk(hr_path).array.astype(np.float32)  # (z, y, x)
    z = min(hr.shape[0], sr_img_zyx.shape[0])
    if hr.shape[1:] != sr_img_zyx.shape[1:]:
        print(f"PSNR skip {subject}: in-plane shape mismatch "
              f"{hr.shape} vs {sr_img_zyx.shape}")
        return
    data_range = float(hr.max() - hr.min()) or 1.0
    psnr = calculate_psnr(sr_img_zyx[:z], hr[:z], data_range=data_range)
    MetricsLogger(paths["flavr_ckpt"]).log(0, subject=subject, psnr=psnr)
    print(f"SR PSNR {subject}: {psnr:.2f} dB")


def stage1c_uncertainty(cfg: Config, *, dataset=None, device=None):
    """Stage 1c (``Pipeline.stage1c_uncertainty``): the UNet3D with the UASR
    head, warm-started from stage 1b's latest checkpoint without
    ``outconv`` and ``feature_fuse`` (the reference's intended filter,
    train_all.py:429-435), trained ``uncertainty_steps`` steps
    (checkpoints in ``checkpoint_path/flavr_uncertainty``, resumed) on
    ``dataset`` (default the stage-1a stores), then each subject's
    ``_uncertainty`` NIfTI. Returns (model, state), or (None, None) when
    ``enable_uncertainty`` is off."""
    from .train import checkpoint as ckpt
    from .train.optim import onecycle_adam
    from .train.state import TrainState

    c = cfg
    if not c.enable_uncertainty:
        return None, None
    device = resolve_device(device)
    paths = pipeline_paths(c)
    model = _make_flavr(c, True)
    if ckpt.has_checkpoint(paths["flavr_ckpt"]):
        src = ckpt.restore_checkpoint_raw(paths["flavr_ckpt"])["params"]
        dst = model.state_dict()
        with torch.no_grad():
            for key, value in src.items():
                if key.split(".")[0] in ("outconv", "feature_fuse"):
                    continue
                if key in dst:
                    dst[key].copy_(value)
    model.to(device)
    n_steps = int(c.uncertainty_steps)
    opt, sched = onecycle_adam(model, c.lr_sr, n_steps)
    state = TrainState(model, opt, sched)
    if ckpt.has_checkpoint(paths["flavr_unc_ckpt"]):
        state.restore(paths["flavr_unc_ckpt"])
    if state.step < n_steps:
        print("TRAINING NETWORK FLAVR WITH UNCERTAINTY")
        state = _train_flavr(c, model, state, paths["flavr_unc_ckpt"],
                             dataset, paths, device, True, n_steps)
    print("INFERENCE NETWORK FLAVR WITH UNCERTAINTY")
    _flavr_inference(c, model, paths, device, uncertainty=True)
    return model, state


def postprocess_flavr(cfg: Config) -> None:
    """The stage-2 HDF5 stores (train_all.py:457-462, sr_utils.py
    :284-304): per subject the SR image 0-255 normalized and re-blurred
    in-plane with the slice profile, the SR label, and the uncertainty
    0-255 (zeros without stage 1c); existing stores are kept."""
    from .infer.sr_infer import zeroonenorm255
    from .io.volume import parse_image, write_h5
    from .ops.blur import blur_axis_np, parse_kernel

    c = cfg
    paths = pipeline_paths(c)
    for subject in sorted(os.listdir(paths["merge_data"])):
        h5_path = os.path.join(paths["segsr_h5"],
                               subject.replace(".nii.gz", ".h5"))
        if os.path.exists(h5_path):
            continue
        base = os.path.join(paths["flavr_output"], subject)
        image, _, _, blur_fwhm, *_ = parse_image(
            base.replace(".nii.gz", "_img.nii.gz"), c.slice_separation, 1.0)
        image = zeroonenorm255(image)
        label, *_ = parse_image(base.replace(".nii.gz", "_seg.nii.gz"),
                                c.slice_separation, 1.0)
        unc_file = base.replace(".nii.gz", "_uncertainty.nii.gz")
        if os.path.exists(unc_file):
            unc, *_ = parse_image(unc_file, c.slice_separation, 1.0)
            unc = zeroonenorm255(unc).astype(np.uint8)
        else:
            unc = np.zeros_like(label)
        kernel = parse_kernel(None, c.blur_kernel, blur_fwhm)
        zxy = image.transpose(2, 0, 1)[:, None]       # (z, 1, x, y)
        blurred = blur_axis_np(zxy.astype(np.float32), kernel, axis=2)
        write_h5(h5_path, img=blurred[:, 0].transpose(1, 2, 0), seg=label,
                 uncertainty=unc)


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
            "ported (ROADMAP queue 1, item 10b)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "multi-process training is still to be ported (ROADMAP queue "
            "1, item 10b)")
    device = resolve_device(device)
    paths = pipeline_paths(c)
    sep = int(c.slice_separation)
    arch, patch_size_zyx, patch_xyz, patch_ori = seg_arch_and_patches(c)
    precision = _precision(c)
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
    loader = _make_loader(c, ds, c.batch_size_segsr, device)
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


# ------------------------------------------------------------ run all

def run(cfg: Config, *, device=None):
    """The whole pipeline (``Pipeline.run``): stage 0, stages 1a, 1b, 1c,
    the stage-2 stores, then :func:`stage2_segsr` with stage 1c's FLAVR
    (else 1b's) as the distillation teacher; each stage resumes by its
    artifacts. Returns what :func:`stage2_segsr` returns."""
    if cfg.fold == "all":
        raise NotImplementedError(
            "--fold all (one fold per device) is still to be ported "
            "(ROADMAP queue 1, item 10b)")
    print("=" * 20, "PROCESSING DATA", "=" * 20)
    preprocess(cfg)
    print("=" * 20, "BEGIN TRAINING STAGE ONE", "=" * 20)
    stage1a_smore(cfg, device=device)
    flavr_model, _ = stage1b_flavr(cfg, device=device)
    unc_model, _ = stage1c_uncertainty(cfg, device=device)
    postprocess_flavr(cfg)
    teacher = unc_model if unc_model is not None else flavr_model
    return stage2_segsr(cfg, flavr_model=teacher, device=device)


def main(config_path: str, fold: int | str | None = None, *, device=None,
         **overrides):
    """Load the config, check the data path (and the nnUNet results when
    the config names them), and :func:`run`."""
    if fold == "all":
        raise NotImplementedError(
            "--fold all (one fold per device) is still to be ported "
            "(ROADMAP queue 1, item 10b)")
    cfg = _config.load_config(config_path, fold=fold, **overrides)
    if not Path(cfg.data_path).exists():
        raise ValueError("Input image path does not exist.")
    if cfg.seg_path and not Path(cfg.seg_path).exists():
        raise ValueError("Segmentation results from nnUNet does not exist.")
    return run(cfg, device=device)
