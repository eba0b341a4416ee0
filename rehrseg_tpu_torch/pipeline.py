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
stage-1 loops take ``dataset=`` in place of the HDF5 stores.

More than one card:
  - data parallelism, one process per card over ``torch.distributed``
    (``torchrun --nproc-per-node N -m rehrseg_tpu_torch.cli ...``): each
    process loads its slice of the global batch (``BatchLoader(shard=)``,
    or the worker loader with ``extra.loader_workers``; no device
    sampler), the steps average their gradients across processes, the
    primary alone writes artifacts, checkpoints and metrics and runs the
    evaluations, and every skip / resume decision is the primary's,
    broadcast (:func:`_agree`), each write followed by a barrier with the
    JAX package's tag;
  - ``--fold all`` (:func:`stage2_segsr_all_folds`): stage 1 once, then the
    folds' stage-2 trainings side by side in one process, fold k on card
    k (``parallel.fold_parallel``);
  - ``extra.mesh_spatial: S`` > 1 (:func:`stage2_segsr`): each process
    drives S cards, cuda:(LOCAL_RANK * S + j), and its stage-2 steps run
    each patch's H sharded over them (``parallel.spatial``); the data
    extent is the process count.
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
from .parallel import multihost as _mh
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


def _agree(flag: bool) -> bool:
    """The primary's filesystem-derived decision, on every process: skip
    and resume branches must be the same everywhere, or the processes call
    different collectives and deadlock (on shared storage ``os.path.exists``
    can disagree across hosts). The flag itself in a single process."""
    if not _mh.is_multihost():
        return bool(flag)
    return _mh.broadcast_scalar(1.0 if flag else 0.0) > 0.5


def _dp_mesh(device, global_batch: int, what: str):
    """The data-parallel mesh (data = the process count) under more than
    one process, after checking the global batch divides over it; None in a
    single process."""
    if not _mh.is_multihost():
        return None
    from .parallel.mesh import make_mesh

    mesh = make_mesh(devices=[resolve_device(device)] * _mh.process_count())
    _mh.validate_global_batch(global_batch, mesh, what=what)
    return mesh


def _make_loader(cfg: Config, ds, batch_size: int, device=None):
    """The training batch loader, chosen as the JAX package chooses: in a
    single process the :class:`.data.device_sampler.DeviceSRPatchSampler`
    (volumes resident on ``device``) where the dataset is of its kind and
    ``extra.device_sampler`` (default true) allows it; else with
    ``extra.loader_workers`` > 0 the worker-process loader, else one
    background thread over the seeded host stream. Under data parallelism
    each process loads its slice of the global batch (``shard=``)."""
    from .data.datasets import (BatchLoader, MultiprocessBatchLoader,
                                PrefetchLoader)

    ex = cfg.extra or {}
    shard = _mh.data_shard()
    if not _mh.is_multihost() and bool(ex.get("device_sampler", True)):
        from .data.device_sampler import DeviceSRPatchSampler
        try:
            return DeviceSRPatchSampler(ds, batch_size, shard=shard,
                                        device=resolve_device(device))
        except (ValueError, AttributeError):
            pass
    workers = int(ex.get("loader_workers", 0) or 0)
    if workers > 0:
        return MultiprocessBatchLoader(ds, batch_size, num_workers=workers,
                                       shard=shard)
    return PrefetchLoader(BatchLoader(ds, batch_size, shard=shard))


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
    """Stage 0: the merged 2-channel volumes under ``tmp_path`` (written by
    the primary)."""
    merge_data = pipeline_paths(cfg)["merge_data"]
    if _mh.is_primary():
        merge_images_and_labels(cfg.data_path, merge_data)
    _mh.barrier("preprocess")


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
    closed on every exit.

    dp_mesh: data parallelism over the process group (the mesh of
    :func:`_dp_mesh`): the primary's weights are broadcast first, the
    stop flag is agreed across processes every 10 steps and once after the
    loop (a save is a lockstep call), and the device draws are the global
    batch's, each process applying its own rows."""
    from .data.device_aug import augment_sr_hr_batch
    from .data.device_sr_sim import simulate_lr_batch
    from .utils.metrics import MetricsLogger
    from .utils.preemption import PreemptionGuard, TrainingPreempted

    mlog = MetricsLogger(weight_dir)
    shard = None
    if dp_mesh is not None:
        _mh.replicate_global(state)
        shard = _mh.data_shard()
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
                stop = guard.should_stop
                if dp_mesh is not None:
                    stop = _mh.any_flag(stop) if it % 10 == 0 else False
                if stop:
                    state.save(weight_dir)
                    raise TrainingPreempted(int(state.step))
                lr_b, hr_b = (upload(a) for a in loader.next())
                if aug_gen is not None:
                    hr_b = augment_sr_hr_batch(aug_gen, hr_b, shard=shard)
                if lr_sim_sep is not None:
                    lr_b = simulate_lr_batch(sim_gen, lr_b, float(lr_sim_sep),
                                             shard=shard)
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
            # a signal in the last steps lands between the agreed checks
            stop = guard.should_stop
            if dp_mesh is not None:
                stop = _mh.any_flag(stop)
            if stop:
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
    if _agree(done and bool(subjects)):
        return

    if not c.smore_initialization:
        # the interpolation fallback (train_all.py:321-330): no SMORE
        # NIfTIs in this branch
        for subject in subjects if _mh.is_primary() else ():
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
        _mh.barrier("stage1a-interp")
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
    if _agree(ckpt.has_checkpoint(paths["smore_ckpt"])):
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
            lr_sim_sep=sep if dev_sim else None,
            dp_mesh=_dp_mesh(device, c.batch_size_sr, "batch_size_sr"))

    print("INFERENCE NETWORK SMORE")
    os.makedirs(smore_out, exist_ok=True)
    for subject in subjects if _mh.is_primary() else ():
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
    _mh.barrier("stage1a")


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
        dp_mesh=_dp_mesh(device, c.batch_size_sr, "batch_size_sr"),
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
    if _agree(ckpt.has_checkpoint(paths["flavr_ckpt"])):
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
    in subject order. The primary alone runs it; every process passes the
    barrier after it."""
    from .infer.sr_infer import infer_flavr_volume_async, restore_intensity
    from .io.volume import parse_image, write_sr_niftis

    if not _mh.is_primary():
        _mh.barrier(f"flavr-infer-{uncertainty}")
        return
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
    _mh.barrier(f"flavr-infer-{uncertainty}")


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
    if _agree(ckpt.has_checkpoint(paths["flavr_ckpt"])):
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
    if _agree(ckpt.has_checkpoint(paths["flavr_unc_ckpt"])):
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
    0-255 (zeros without stage 1c); existing stores are kept. Written by
    the primary."""
    from .infer.sr_infer import zeroonenorm255
    from .io.volume import parse_image, write_h5
    from .ops.blur import blur_axis_np, parse_kernel

    c = cfg
    paths = pipeline_paths(c)
    subjects = sorted(os.listdir(paths["merge_data"])) \
        if _mh.is_primary() else ()
    for subject in subjects:
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
    _mh.barrier("postprocess-flavr")


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
           if _agree(ckpt.has_checkpoint(paths["flavr_unc_ckpt"]))
           else paths["flavr_ckpt"])
    if _agree(ckpt.has_checkpoint(src)):
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


def _mesh_spatial(cfg: Config) -> int:
    return int((cfg.extra or {}).get("mesh_spatial", 1) or 1)


def _spatial_group(cfg: Config, device, spatial_devices=None):
    """The devices a process's stage-2 patches shard over along H: the
    ``extra.mesh_spatial`` = S cards cuda:(LOCAL_RANK * S + j), S names of
    the CPU for ``device="cpu"``, or ``spatial_devices`` as given (one
    device may be named several times); None for S = 1."""
    s = _mesh_spatial(cfg)
    if spatial_devices is not None:
        group = [torch.device(d) for d in spatial_devices]
        if len(group) != s:
            raise ValueError(f"{len(group)} spatial_devices for "
                             f"mesh_spatial={s}")
        return group if s > 1 else None
    if s == 1:
        return None
    if device.type == "cpu":
        return [device] * s
    base = int(os.environ.get("LOCAL_RANK", 0)) * s
    n = torch.cuda.device_count()
    if base + s > n:
        raise ValueError(
            f"mesh_spatial={s} needs cards {base}..{base + s - 1} for this "
            f"process but {n} are visible; run cards / {s} processes a "
            f"node, or name the devices (spatial_devices=)")
    return [torch.device("cuda", base + j) for j in range(s)]


def _seg_dataset(cfg: Config, paths, subjects, dataset, patch_ori,
                 patch_xyz, seed: int = 0):
    """Stage 2's training set: ``dataset`` when given (its augmentation
    mode checked against the config's), else the stage-1 HDF5 stores of
    ``subjects``. The device augmentation is the default; the host chain
    (``device_augment: false``) is the parity oracle."""
    from .data.datasets import SegSRDataset

    c = cfg
    device_augment = bool((c.extra or {}).get("device_augment", True))
    if dataset is None:
        return SegSRDataset(paths["segsr_h5"], subjects, c.slice_thickness,
                            c.target_thickness, patch_ori, patch_xyz,
                            c.random_flip, c.enable_uncertainty,
                            device_augment=device_augment, seed=seed)
    if bool(dataset.device_augment) != device_augment:
        raise ValueError(f"dataset.device_augment={dataset.device_augment} "
                         f"but the config asks for {device_augment}")
    return dataset


def _seg_train_state(cfg: Config, arch, fold, device, sched, ckpt_dir):
    """Fold ``fold``'s SegModel on ``device`` (seeded weights, warm-started
    from the fold's nnUNet checkpoint), the distiller under KD, their
    optimizer and TrainState, restored from ``ckpt_dir`` when it holds a
    checkpoint. Returns (seg model, state)."""
    from .models.segnet import SegModel
    from .train import checkpoint as ckpt
    from .train.optim import nesterov_sgd, nesterov_sgd_grouped
    from .train.state import TrainState

    c = cfg
    seg = SegModel(num_classes=2, upscale=int(c.slice_separation),
                   input_channels=1, arch=arch)
    _init_seg_params(c, seg, arch, fold)
    seg.to(device)
    params = seg
    if c.enable_distillation:
        params = {"seg": seg, "distiller": _make_distiller(c, arch).to(device)}
    # KD: one uniform SGD over both modules (train_all.py:511-513); else
    # the SR head at the full lr, the rest at 0.1x without weight decay
    opt = nesterov_sgd(params) if c.enable_distillation \
        else nesterov_sgd_grouped(seg)
    state = TrainState(params, opt, sched)
    if _agree(ckpt.has_checkpoint(ckpt_dir)):
        state.restore(ckpt_dir)
    return seg, state


def _seg_step_maker(cfg: Config, seg, teacher, spatial_devices=None):
    """``remat mode -> make_seg_train_step(seg, ...)`` with the config's
    options; ``teacher`` is the frozen FLAVR under KD, else None;
    ``spatial_devices`` the group the step shards H over, or None."""
    from .train.seg_trainer import make_seg_train_step

    c = cfg

    def make_step(remat_mode):
        return make_seg_train_step(
            seg, enable_uncertainty=c.enable_uncertainty,
            enable_distillation=c.enable_distillation, flavr_model=teacher,
            teacher_window_chunk=(c.extra or {}).get("teacher_window_chunk"),
            remat=remat_mode, precision=_precision(c),
            sr_head_form=_sr_head_form(c), spatial_devices=spatial_devices)

    return make_step


def _seg_batch(cfg: Config, b, device, aug_gen, patch_xyz, shard=None):
    """A loader batch on ``device`` as a SegBatch, augmented there when
    ``aug_gen`` is given (the global batch's draws under ``shard``)."""
    from .train.seg_trainer import SegBatch

    arrays = [torch.from_numpy(b[k]).to(device, non_blocking=True)
              for k in ("img", "label_lr", "label_hr", "uncertainty_lr")]
    if aug_gen is not None:
        from .data.device_aug import augment_seg_batch
        arrays = augment_seg_batch(
            aug_gen, *arrays, patch_hw=(patch_xyz[1], patch_xyz[0]),
            enable_uncertainty=cfg.enable_uncertainty, shard=shard)
    return SegBatch(*arrays)


def _val_dice(cfg: Config, seg, patch_ori, subjects, device) -> float:
    """The mean dice of ``subjects`` (fp32): the reference evaluates with
    the ENLARGED patch (x+64, y+64, z) reversed (train_all.py:563,165)."""
    c = cfg
    return evaluate(seg, patch_ori[::-1], c.data_path,
                    c.data_path.replace("imagesTr", "labelsTr"), subjects,
                    c.slice_separation,
                    mirror=bool((c.extra or {}).get("eval_mirror", True)),
                    device=device)


def stage2_segsr(cfg: Config, *, flavr_model=None, dataset=None,
                 device=None, spatial_devices=None):
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
    traces steps 5-10 with torch.profiler.

    Under data parallelism (a process group of N > 1) each process trains
    on its slice of the global ``batch_size_segsr`` (which N must divide)
    from the primary's weights; the device augmentation draws for the
    global batch; the remat mode is probed on the primary and broadcast;
    the primary alone evaluates (fp32 K1), its dice and the best-dice
    watermark broadcast; the stop flag is agreed every 10 steps and after
    the loop.

    With ``extra.mesh_spatial: S`` > 1 each step shards its patches' H over
    the process's spatial group (:func:`_spatial_group`; ``spatial_devices``
    names it, e.g. one card several times): the batch is placed as H-blocks
    (``multihost.place_global``), the state, the teacher and the
    validation live on the group's first device."""
    from .train.optim import poly_epoch_schedule
    from .train.seg_trainer import (REMAT_NAMES, REMAT_UNWIRE, REMAT_WIRE,
                                    select_remat_mode)
    from .utils.metrics import MetricsLogger
    from .utils.preemption import PreemptionGuard, TrainingPreempted
    from .utils.timer import StepTimer

    c = cfg
    ex = c.extra or {}
    if _mh.is_multihost() and c.fold == "all":
        raise NotImplementedError(
            "--fold all maps one fold per device and is exclusive with "
            "multi-process data parallelism; run one fold per process "
            "group with --fold k")
    device = resolve_device(device)
    group = _spatial_group(c, device, spatial_devices)
    if group is not None:
        device = group[0]
    dp_mesh = _dp_mesh(device, c.batch_size_segsr, "batch_size_segsr")
    shard = _mh.data_shard()
    paths = pipeline_paths(c)
    arch, _, patch_xyz, patch_ori = seg_arch_and_patches(c)

    teacher = None
    if c.enable_distillation:
        teacher = _ensure_flavr_teacher(c, flavr_model, paths).to(device)
    train_subjects, val_subjects = split_subjects(c)
    ds = _seg_dataset(c, paths, train_subjects, dataset, patch_ori,
                      patch_xyz)
    loader = _make_loader(c, ds, c.batch_size_segsr, device)
    aug_gen = (torch.Generator(device=device).manual_seed(0)
               if ds.device_augment else None)
    iters_per_epoch = max(len(ds) // c.batch_size_segsr, 1)
    sched = poly_epoch_schedule(c.lr_segsr, c.epochs, iters_per_epoch)
    seg, state = _seg_train_state(c, arch, c.fold, device, sched,
                                  paths["segsr_ckpt"])
    if group is not None:
        _mh.replicate_any(state, group)
        if teacher is not None:
            _mh.replicate_any(teacher, group)
    elif dp_mesh is not None:
        _mh.replicate_global(state)
        if teacher is not None:
            _mh.replicate_global(teacher)

    make_step = _seg_step_maker(c, seg, teacher, group)
    remat_mode = _remat_mode(c)
    step_fn = None if remat_mode == "auto" else make_step(remat_mode)
    total_steps = c.epochs * iters_per_epoch
    mlog = MetricsLogger(paths["segsr_ckpt"])
    # the best-dice watermark survives a resume
    best_dice = _mh.broadcast_scalar(
        mlog.max_on_disk("val_dice") if _mh.is_primary() else 0.0)
    timer = StepTimer()
    profile_dir = ex.get("profile_dir")
    prof = None
    print(f"TRAINING NETWORK REHRSeg ({total_steps} steps)")
    guard = PreemptionGuard()
    start_it = int(state.step)

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
                stop = guard.should_stop
                if dp_mesh is not None:
                    stop = _mh.any_flag(stop) if it % 10 == 0 else False
                if stop:
                    state.save(paths["segsr_ckpt"])
                    raise TrainingPreempted(int(state.step))
                timer.start()
                batch = _seg_batch(c, loader.next(), device, aug_gen,
                                   patch_xyz, shard)
                if group is not None:
                    batch = _mh.place_global(batch, group)
                if step_fn is None:
                    # probed on the primary, the choice broadcast
                    mode = True
                    if _mh.is_primary():
                        mode, why = select_remat_mode(make_step, state,
                                                      batch)
                        print(f"remat auto-select: {REMAT_NAMES[mode]} "
                              f"({why})")
                    code = _mh.broadcast_scalar(float(REMAT_WIRE[mode]))
                    step_fn = make_step(REMAT_UNWIRE[int(code)])
                state, metrics = step_fn(state, batch)
                timer.stop()
                if (it + 1) % 100 == 0 or it + 1 == total_steps:
                    mlog.log(it + 1, loss=float(metrics["loss"]),
                             lr=float(sched(it)), step_time_s=timer.mean())
                if (it + 1) % c.save_iters_segsr == 0:
                    if val_subjects:
                        val_dice = 0.0
                        if _mh.is_primary():
                            val_dice = _val_dice(c, seg, patch_ori,
                                                 val_subjects, device)
                            print(f"Eval result: {val_dice}")
                            mlog.log(it + 1, val_dice=float(val_dice))
                        val_dice = _mh.broadcast_scalar(val_dice)
                        if val_dice > best_dice:
                            state.save(paths["segsr_ckpt"], tag="best")
                        best_dice = max(best_dice, val_dice)
                    state.save(paths["segsr_ckpt"])
            stop = guard.should_stop
            if dp_mesh is not None:
                stop = _mh.any_flag(stop)
            if stop:
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


# ------------------------------------------------------------ stage 2, folds

def _fold_splits(cfg: Config, n_folds=None):
    """Per-fold (train, val) subjects: nnUNet's splits_final.json when
    ``seg_path`` is set, else a round-robin K-fold of ``data_path``'s
    subjects (``extra.synthetic_folds``, default 2)."""
    c = cfg
    if c.seg_path:
        splits = _config.load_splits(c.seg_path)
        if n_folds:
            splits = splits[:n_folds]
        return [(sp["train"], sp["val"]) for sp in splits]
    subjects = [s.replace("_0000.nii.gz", "").replace(".nii.gz", "")
                for s in sorted(os.listdir(c.data_path))]
    k = int(n_folds or (c.extra or {}).get("synthetic_folds", 2))
    out = []
    for f in range(k):
        val = subjects[f::k]
        out.append(([s for s in subjects if s not in val], val))
    return out


def stage2_segsr_all_folds(cfg: Config, *, flavr_model=None, dataset=None,
                           n_folds=None, device=None, devices=None):
    """Stage 2 of every fold at once, one fold per device
    (``Pipeline.stage2_segsr_all_folds``; the reference trains its folds
    as sequential runs, train_all.py:577-583). Returns (the folds'
    SegModels, their TrainStates, their best validation dice).

    Fold k: its split's subjects (:func:`_fold_splits`), a dataset and a
    ``BatchLoader`` seeded k, the SegModel's seeded weights warm-started
    from fold k's nnUNet checkpoint, its state, batches, augmentation
    generator (seeded k) and teacher copy on device k, checkpoints in
    ``<segsr_ckpt>_fold{k}``; the metrics of every fold go to
    ``<segsr_ckpt>_folds/metrics.jsonl``. One fold-parallel step runs every
    fold's unchanged step (``parallel.fold_parallel``). Folds restored at
    unequal steps resume from the largest. Every ``save_iters_segsr``
    steps and at the end each fold is evaluated on its validation subjects
    (fp32 K1 on its device), tagged ``best`` when it improved, and saved.
    remat "auto" resolves to "all" here, as in the JAX package.

    devices: the folds' devices (one device may be named several times);
    default the distinct visible cards, or every fold on the CPU with
    ``device="cpu"``. Fewer devices than folds raises. dataset: a
    :class:`.data.datasets.SegSRDataset`, or a list of one per fold, in
    place of the stage-1 stores. One process only."""
    import copy

    from .data.datasets import BatchLoader
    from .parallel.fold_parallel import (make_fold_mesh,
                                         make_fold_parallel_step)
    from .train.optim import poly_epoch_schedule
    from .utils.metrics import MetricsLogger
    from .utils.preemption import PreemptionGuard, TrainingPreempted

    if _mh.is_multihost():
        raise NotImplementedError(
            "--fold all is single-process (one fold per local card); with "
            "several processes run one fold per process group with --fold k")
    c = cfg
    if _mesh_spatial(c) > 1:
        raise NotImplementedError(
            "--fold all maps one fold per device and is exclusive with "
            "multi-host DP and mesh_spatial; run one fold per host/config "
            "with --fold k")
    paths = pipeline_paths(c)
    arch, _, patch_xyz, patch_ori = seg_arch_and_patches(c)
    folds = _fold_splits(c, n_folds)
    n = len(folds)
    if devices is None and device is not None \
            and torch.device(device).type == "cpu":
        devices = [torch.device(device)] * n
    mesh = make_fold_mesh(n, devices)
    devs = [resolve_device(d) for d in mesh.data_devices]

    teachers = {}
    if c.enable_distillation:
        flavr_model = _ensure_flavr_teacher(c, flavr_model, paths)
        for d in devs:
            if d not in teachers:
                teachers[d] = copy.deepcopy(flavr_model).to(d)

    datasets = [_seg_dataset(c, paths, train_sub,
                             dataset[k] if isinstance(dataset, (list, tuple))
                             else dataset, patch_ori, patch_xyz, seed=k)
                for k, (train_sub, _) in enumerate(folds)]
    loaders = [BatchLoader(ds, c.batch_size_segsr, seed=k)
               for k, ds in enumerate(datasets)]
    ckpt_dirs = [paths["segsr_ckpt"] + f"_fold{k}" for k in range(n)]
    iters_per_epoch = max(min(len(ds) for ds in datasets)
                          // c.batch_size_segsr, 1)
    sched = poly_epoch_schedule(c.lr_segsr, c.epochs, iters_per_epoch)
    remat = True if _remat_mode(c) == "auto" else _remat_mode(c)

    segs, states, steps = [], [], []
    for k, d in enumerate(devs):
        seg, st = _seg_train_state(c, arch, k, d, sched, ckpt_dirs[k])
        segs.append(seg)
        states.append(st)
        steps.append(_seg_step_maker(c, seg, teachers.get(d))(remat))
    fold_step = make_fold_parallel_step(steps, mesh)
    aug_gens = [torch.Generator(device=d).manual_seed(k) if ds.device_augment
                else None for k, (d, ds) in enumerate(zip(devs, datasets))]

    total_steps = c.epochs * iters_per_epoch
    # the folds are saved together, so unequal steps mean a torn save: the
    # folds behind lose at most one save interval
    fold_steps = [int(st.step) for st in states]
    if len(set(fold_steps)) > 1:
        print(f"WARNING: unequal fold checkpoint steps {fold_steps}; "
              "resuming from max")
    start = max(fold_steps)
    mlog = MetricsLogger(paths["segsr_ckpt"] + "_folds")
    best = [mlog.max_on_disk(f"val_dice_fold{k}") for k in range(n)]
    print(f"TRAINING NETWORK REHRSeg x{n} folds ({total_steps} steps, "
          f"devices={[str(d) for d in devs]})")
    guard = PreemptionGuard()
    with guard:
        for it in range(start, total_steps):
            if guard.should_stop:
                for k, st in enumerate(states):
                    st.save(ckpt_dirs[k])
                raise TrainingPreempted(max(int(st.step) for st in states))
            batches = [(_seg_batch(c, loaders[k].next(), d, aug_gens[k],
                                   patch_xyz),)
                       for k, d in enumerate(devs)]
            states, metrics = fold_step(states, batches)
            last = it + 1 == total_steps
            if (it + 1) % 100 == 0 or last:
                mlog.log(it + 1, **{f"loss_fold{k}": float(m["loss"])
                                    for k, m in enumerate(metrics)})
            if (it + 1) % c.save_iters_segsr == 0 or last:
                for k, st in enumerate(states):
                    val_sub = folds[k][1]
                    if val_sub:
                        val_dice = _val_dice(c, segs[k], patch_ori, val_sub,
                                             devs[k])
                        print(f"Eval fold {k}: {val_dice}")
                        mlog.log(it + 1, **{f"val_dice_fold{k}":
                                            float(val_dice)})
                        if val_dice > best[k]:
                            st.save(ckpt_dirs[k], tag="best")
                            best[k] = val_dice
                    st.save(ckpt_dirs[k], step=total_steps if last else None)
    return segs, states, best


# ------------------------------------------------------------ run all

def run(cfg: Config, *, device=None):
    """The whole pipeline (``Pipeline.run``): stage 0, stages 1a, 1b, 1c,
    the stage-2 stores, then :func:`stage2_segsr` (with ``fold="all"``
    :func:`stage2_segsr_all_folds`) with stage 1c's FLAVR (else 1b's) as
    the distillation teacher; each stage resumes by its artifacts. Returns
    what the stage-2 function returns. Under data parallelism the global
    batches are checked first."""
    if _mh.is_multihost():
        _dp_mesh(device, cfg.batch_size_sr, "batch_size_sr")
        _dp_mesh(device, cfg.batch_size_segsr, "batch_size_segsr")
    print("=" * 20, "PROCESSING DATA", "=" * 20)
    preprocess(cfg)
    print("=" * 20, "BEGIN TRAINING STAGE ONE", "=" * 20)
    stage1a_smore(cfg, device=device)
    flavr_model, _ = stage1b_flavr(cfg, device=device)
    unc_model, _ = stage1c_uncertainty(cfg, device=device)
    postprocess_flavr(cfg)
    teacher = unc_model if unc_model is not None else flavr_model
    if cfg.fold == "all":
        return stage2_segsr_all_folds(cfg, flavr_model=teacher,
                                      device=device)
    return stage2_segsr(cfg, flavr_model=teacher, device=device)


def main(config_path: str, fold: int | str | None = None, *, device=None,
         **overrides):
    """Load the config, check the data path (and the nnUNet results when
    the config names them), and :func:`run`. fold: an index, None, or
    "all" (every fold side by side, one per device)."""
    cfg = _config.load_config(config_path, fold=fold, **overrides)
    if not Path(cfg.data_path).exists():
        raise ValueError("Input image path does not exist.")
    if cfg.seg_path and not Path(cfg.seg_path).exists():
        raise ValueError("Segmentation results from nnUNet does not exist.")
    return run(cfg, device=device)
