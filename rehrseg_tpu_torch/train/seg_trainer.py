"""Stage-2 segmentation training step: the dual LR + HR seg loss,
uncertainty weighting, deep supervision and structural knowledge
distillation from the frozen FLAVR teacher (``rehrseg_tpu.train.
seg_trainer``; reference train_all.py:519-556 and
get_intermediate_features :85-112).

The teacher encoder slides a 4-slice window along z (zero-padded at the
ends); all windows go through one batched ``UNet3D.encode`` (or chunks of
``window_chunk``) under ``torch.no_grad()``, keeping feature slice 1 per
window plus slice 2 of the last, a full-depth 64-channel volume aligned
with the student's stage-1 skip.

The step runs the packed forward (:mod:`..models.segnet_packed`, plain
convs: the CUDA kernels have no backward) through autograd, with stages
checkpointed as ``remat`` says and the LR / HR loss terms checkpointed on
the packed path. :func:`select_remat_mode` picks the mode by running one
step of each candidate and reading the card's peak memory.

With a spatial group (``spatial_devices``, the JAX package's
``'spatial'`` mesh axis) the step runs the packed forward H-sharded over
the group (:mod:`..parallel.spatial`: a halo exchange at every conv, the
norm moments summed across blocks), the parameters on the group's first
device and copied to each block's inside the step; the LR and HR logits
and the student's skips come back gathered on the first device, where the
losses, the teacher and the distiller run (the JAX package shards those
too).

Under data parallelism (``parallel.multihost``) the step averages the
gradients of the student and the distiller across processes before the
update (the teacher is frozen), and its metrics are the global batch's
means. The seg losses are per-sample means and the distiller's pairwise
term is divided by the batch, so with equal local batches the mean of the
processes' gradients is the gradient over the global batch.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..data.normalize import zscore_batch
from ..losses import dc_and_weighted_ce, deep_supervision_weights
from ..models import convert
from ..models.segnet_packed import segmodel_apply_packed
from ..parallel import multihost, spatial
from .precision import policy as _policy, step_guard


def flavr_window_indices(depth: int) -> np.ndarray:
    """(depth-1, 4) gather indices into a z-padded (depth+2) volume: window
    st covers original slices [st-1, st+2], padded[st : st+4]."""
    return np.arange(depth - 1)[:, None] + np.arange(4)[None, :]


@torch.no_grad()
def flavr_teacher_features(flavr_model, img_lr, label_lr,
                           feature_index: int = 1,
                           window_chunk: int | None = None,
                           compute_dtype=None):
    """Teacher feature volume for KD (get_intermediate_features parity).

    img_lr, label_lr: (B, D, H, W, 1). Returns (B, D, H', W', C') where
    feature_index=1 selects the 64-channel layer1 features at H/2.
    window_chunk: encode the B*(D-1) windows in chunks of this size;
    compute_dtype: the windows' dtype for the encoder (pass a teacher cast
    to the same dtype). The result carries no graph."""
    x = torch.cat([zscore_batch(img_lr), label_lr], dim=-1)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    b, d, h, w, c = x.shape
    padded = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    idx = torch.as_tensor(flavr_window_indices(d), device=x.device)
    flat = padded[:, idx].reshape(b * (d - 1), 4, h, w, c)
    n = flat.shape[0]
    if window_chunk is not None and window_chunk < n:
        f = torch.cat([flavr_model.encode(ch)[feature_index]
                       for ch in torch.split(flat, int(window_chunk))])
    else:
        f = flavr_model.encode(flat)[feature_index]
    _, fd, fh, fw, fc = f.shape
    f = f.reshape(b, d - 1, fd, fh, fw, fc)
    # slice 1 of each window -> slices 0..d-2; slice 2 of the last -> d-1
    return torch.cat([f[:, :, 1], f[:, -1:, 2]], dim=1)


def ds_scales_from_arch(arch: dict) -> list[tuple]:
    """Per-decoder-output downsampling scales for deep supervision:
    cumulative stride products, highest resolution first."""
    strides = [tuple(s) if not isinstance(s, int) else (s, s, s)
               for s in arch["strides"]]
    scales = [(1, 1, 1)]
    cur = np.ones(3, dtype=np.int64)
    for s in strides[1:]:
        cur = cur * np.asarray(s)
        scales.append(tuple(int(v) for v in cur))
    return scales[: len(strides) - 1]


def downsample_label(label, scale):
    """Nearest (strided) downsample of a (B, D, H, W, 1) label by integer
    per-axis factors."""
    sd, sh, sw = (int(s) for s in scale)
    return label[:, ::sd, ::sh, ::sw]


class SegBatch(NamedTuple):
    img: torch.Tensor             # (B, D, H, W, 1) LR pseudo image
    label_lr: torch.Tensor        # (B, D, H, W, 1)
    label_hr: torch.Tensor        # (B, D*sep, H, W, 1)
    uncertainty_lr: torch.Tensor  # (B, D, H, W, 1) or zeros


def make_seg_train_step(seg_model, *, enable_uncertainty: bool,
                        enable_distillation: bool,
                        flavr_model=None,
                        deep_supervision: bool = False,
                        teacher_window_chunk: int | None = None,
                        packed: bool = True,
                        remat=True,
                        precision: str | None = None,
                        sr_head_form: str = "auto",
                        spatial_devices=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics).

    ``state``: a :class:`..train.state.TrainState` whose params are the
    SegModel, or ``{"seg": SegModel, "distiller": Distiller}`` with
    distillation (both optimized jointly, train_all.py:511-513). The step
    zeroes the gradients, runs forward and backward, and applies one
    update at ``schedule(state.step)``; metrics are 0-d tensors on the
    device (``loss``, ``loss_lr``, ``loss_hr``, ``loss_kd``), so steps
    chain without a sync until the caller reads one. The gradients of the
    last step stay in each parameter's ``.grad``; ``step.loss_fn(params,
    batch)`` -> (loss, metrics) is the forward alone.

    packed: the space-to-depth packed forward (ignored with
    deep_supervision: the packed forward has no DS heads). remat: False,
    "hires" or True, the packed forward's stage checkpointing. precision:
    'bf16' runs the student and the teacher in bfloat16 against fp32
    master weights, the logits cast back to fp32 before every loss; None /
    'fp32' is the reference's fp32 step. flavr_model: the frozen teacher,
    cast once here to the compute dtype (a copy when that is not fp32).
    sr_head_form: the packed SR head's emission ('auto' | 'cell4' |
    'legacy'). A bf16 step on the CPU runs without oneDNN
    (:func:`.precision.step_guard`). spatial_devices: a group of devices
    (one device may be named more than once) over which the forward runs
    H-sharded; the batch may come placed by
    :func:`..parallel.multihost.place_global` (an image that comes whole is
    split here), every other batch field is gathered on the first device.
    Deep supervision has no spatial form (its heads are the module's)."""
    pol = _policy(precision)
    group = ([torch.device(d) for d in spatial_devices]
             if spatial_devices is not None else None)
    if group is not None and len(group) > 1 and deep_supervision:
        raise ValueError("deep_supervision runs the module's forward, which "
                         "has no spatial form; use spatial_devices=None")
    ds_scales = (ds_scales_from_arch(seg_model.arch)
                 if deep_supervision else None)
    use_packed = bool(packed) and not deep_supervision
    arch = dict(seg_model.arch)
    upscale = seg_model.upscale
    teacher = None
    if enable_distillation:
        teacher = flavr_model
        if not pol.is_identity:
            teacher = copy.deepcopy(flavr_model).to(pol.compute_dtype)
        teacher.eval().requires_grad_(False)
    weight_dice_lr = 0.0 if enable_uncertainty else 1.0

    def _lr_loss(lg, tg, u):
        return dc_and_weighted_ce(lg, tg, u, weight_ce=1.0,
                                  weight_dice=weight_dice_lr)

    def _hr_loss(lg, tg):
        return dc_and_weighted_ce(lg, tg, None, weight_ce=1.0,
                                  weight_dice=1.0)

    def maybe_ckpt(fn, *args):
        # softmax / dice temporaries on the 4x-D HR grid need not survive
        # to the backward pass
        if use_packed:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(model, img):
        if use_packed or isinstance(img, spatial.HBlocks):
            # unpacked and H-sharded: the packed forward with nothing
            # packed is the module's math
            params = pol.cast_compute(convert.flax_tree_from_module(model))
            return segmodel_apply_packed(
                arch, params, pol.cast_compute(img), dual=True,
                upscale=upscale, return_skips=True,
                pack_max_channels=64 if use_packed else 0,
                remat=remat, sr_head_form=sr_head_form)
        params = pol.cast_compute(dict(model.named_parameters()))
        return torch.func.functional_call(
            model, params, (pol.cast_compute(img),),
            {"return_intermediate_feature": True})

    def loss_fn(params, batch: SegBatch):
        model = params["seg"] if enable_distillation else params
        img = batch.img
        if (group is not None and len(group) > 1
                and not isinstance(img, spatial.HBlocks)):
            img = spatial.split(img.to(group[0]), group)
        batch = SegBatch(img, *(spatial.gather(t) for t in batch[1:]))
        lr_logits, hr_logits, skips = forward(model, img)
        lr_logits = pol.cast_reduce(lr_logits)
        hr_logits = pol.cast_reduce(hr_logits)
        unc = batch.uncertainty_lr if enable_uncertainty else None
        if deep_supervision:
            weights = deep_supervision_weights(len(lr_logits))
            loss_lr = 0.0
            for w, lg, scale in zip(weights, lr_logits, ds_scales):
                if w == 0.0:
                    continue
                tgt = downsample_label(batch.label_lr, scale)
                u = downsample_label(unc, scale) if unc is not None else None
                loss_lr = loss_lr + float(w) * _lr_loss(lg, tgt, u)
        else:
            loss_lr = maybe_ckpt(_lr_loss, lr_logits, batch.label_lr, unc)
        loss_hr = maybe_ckpt(_hr_loss, hr_logits, batch.label_hr)
        loss = loss_lr + loss_hr
        metrics = {"loss_lr": loss_lr, "loss_hr": loss_hr}
        if enable_distillation:
            feats = flavr_teacher_features(
                teacher, spatial.gather(batch.img), batch.label_lr,
                window_chunk=teacher_window_chunk,
                compute_dtype=(None if pol.is_identity
                               else pol.compute_dtype))
            # KD math reduces in fp32; the distiller stays an fp32 module
            kd = params["distiller"](pol.cast_reduce(skips[1]),
                                     pol.cast_reduce(feats))
            loss = loss + kd
            metrics["loss_kd"] = kd
        metrics["loss"] = loss
        return loss, metrics

    def step(state, batch: SegBatch):
        state.optimizer.zero_grad(set_to_none=True)
        with step_guard(pol, state.params):
            loss, metrics = loss_fn(state.params, batch)
            loss.backward()
        multihost.all_reduce_grads(state.params)
        state.apply_gradients()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if multihost.is_multihost():
            # the global batch's means, one collective for every metric
            keys = list(metrics)
            means = multihost.global_mean(
                torch.stack([metrics[k].float() for k in keys]))
            metrics = dict(zip(keys, means.unbind()))
        return state, metrics

    step.loss_fn = loss_fn
    return step


# remat modes: wire codes (the JAX package's pod broadcast) and display
# names (logs and chip_smoke)
REMAT_WIRE = {False: 0, "hires": 1, True: 2}
REMAT_UNWIRE = {v: k for k, v in REMAT_WIRE.items()}
REMAT_NAMES = {False: "none", "hires": "hires", True: "all"}


def _free_grads(state):
    state.optimizer.zero_grad(set_to_none=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def select_remat_mode(build_step, state, batch, *,
                      bytes_limit: int | None = None,
                      margin_bytes: int = 1 << 30,
                      candidates=(False, "hires", True),
                      probes: dict | None = None):
    """Pick the fastest remat mode whose measured peak fits the card.

    JAX reads XLA's compiled peak; here each candidate in order (False,
    then "hires") runs one forward + backward on ``batch`` under
    ``torch.cuda.reset_peak_memory_stats()`` (no optimizer update: the
    state is left as it was), and the first whose peak fits
    ``bytes_limit`` (default the card's total memory) minus
    ``margin_bytes`` wins. An out-of-memory error frees the gradients and
    the cache and moves on. True (every stage checkpointed, the
    guaranteed-fit mode) is never probed; it is the fallback. A device
    without a memory limit (the CPU) returns True at once.

    build_step: mode -> a step of :func:`make_seg_train_step` (its
    ``loss_fn`` is what runs). Returns (mode, reason), the measured peaks
    in ``reason``; ``probes``, when given, gets each probed mode's peak in
    bytes (None for an out-of-memory error)."""
    device = batch.img.device
    if device.type != "cuda":
        bytes_limit = None
    elif bytes_limit is None:
        bytes_limit = torch.cuda.get_device_properties(device).total_memory
    if not bytes_limit:
        return True, "device reports no bytes_limit; remat=all (safe default)"
    budget = int(bytes_limit) - int(margin_bytes)
    last_err, peaks = None, []
    for mode in candidates:
        if mode is True:
            break
        try:
            _free_grads(state)
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            build_step(mode).loss_fn(state.params, batch)[0].backward()
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        except torch.cuda.OutOfMemoryError as e:
            last_err = f"OutOfMemoryError: {str(e).splitlines()[0][:120]}"
            if probes is not None:
                probes[REMAT_NAMES[mode]] = None
            continue
        finally:
            _free_grads(state)
        if probes is not None:
            probes[REMAT_NAMES[mode]] = peak
        peaks.append(f"{REMAT_NAMES[mode]} {peak / 2**30:.2f} GiB")
        if peak <= budget:
            return mode, (f"remat={mode!r}: peak {peak / 2**30:.2f} GiB "
                          f"fits {budget / 2**30:.2f} GiB budget")
    reason = "all probed candidates exceeded the budget or failed to run"
    if peaks:
        reason += f" ({', '.join(peaks)})"
    if last_err:
        reason += f" (last: {last_err})"
    return True, reason

