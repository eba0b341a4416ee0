"""Host-side training datasets and batch loaders (``rehrseg_tpu.data.
datasets``: ``SRPatchDataset``, ``SegSRDataset``, ``BatchLoader``,
``PrefetchLoader``).

``SRPatchDataset`` is the reference's TrainSetMultiple (train_set.py
:225-434): per-subject HR volumes (image + label) and their slice-profile
blurred copies along x and y; each sample picks the blur axis by a
transpose coin flip, crops a patch, optionally runs the intensity-only
nnUNet transforms, simulates LR by rational B-spline downsampling (order 3
image, order 0 label; or leaves that to the device with
``device_lr_sim``), zeroes the first / last context slice (p = 0.1 each),
flips and swaps the in-plane axes. It serves WDSR (2D, thin-z patches) and
FLAVR (3D).

``SegSRDataset`` is the reference's TrainSetMultipleSegSREfficient
(train_set.py:22-159): pseudo-HR volumes (img / seg / uncertainty) from
stage 1; a random crop of (ps_x+64, ps_y+64, ps_z*sep), flips, LR by
strided slicing [::sep], the uncertainty weight 1 - u/255*0.99, then the
dummy-2D spatial + intensity pipeline on the host, or raw crops for the
device augmentation (:mod:`.device_aug`).

Samples are numpy, channels-last, and bit-equal to the JAX package's at
the same ``np.random.default_rng`` seed. Each dataset reads its stores in
the constructor (h5py, imported there) or takes arrays through
``from_volumes``.

``MultiprocessBatchLoader`` builds whole batches in worker processes from
per-sample seeds the parent draws: the same batches as ``BatchLoader(
shard=(0, 1))`` (or its ``shard=``), whatever the number of workers.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.volume import parse_image
from ..ops.blur import blur_axis_np, parse_kernel
from ..ops.bspline import resize_1d_np
from ..utils.pad import target_pad
from .normalize import zscore_normalization
from .transforms import TrainingTransforms


class SRPatchDataset:
    """Stage-1 SR patch sampler (TrainSetMultiple parity).

    Subjects are matched to the files of ``image_path`` by name, anchored
    (``<subject>_...`` or ``<subject>.``; a bare substring only when no
    anchored name exists), so case_1 never takes case_10. A ``.nii.gz``
    source is a merged (x, y, z, 2) volume, blurred here; an ``.h5``
    store holds ``img_hr``, ``label_hr``, ``image_x_rgb``,
    ``image_y_rgb``. ``channels=1`` (``sr_mode='img'``) draws the same
    stream as 2 and keeps channel 0."""

    def __init__(self, image_path, split_subjects, slice_thickness,
                 target_thickness, blur_kernel_file, blur_kernel_name,
                 patch_size, random_flip, preload=True, blur=True,
                 nnunet_transform=False, seed=0, device_lr_sim=False,
                 channels=2):
        all_names = sorted(os.listdir(image_path))
        names = []
        for s in split_subjects:
            anchored = [x for x in all_names
                        if x.startswith(s + "_") or x.startswith(s + ".")]
            matches = anchored or [x for x in all_names if s in x]
            if matches:
                names.append(matches[0])
        self.image_path = image_path
        self._blur_kernel_file = blur_kernel_file
        self._blur_kernel_name = blur_kernel_name
        self._slice_thickness = slice_thickness
        self._target_thickness = target_thickness
        self.blur = blur
        volumes = []
        for name in names:
            vol = self._load(name)
            volumes.append(tuple(
                np.asarray(v[:]) if preload and v is not None else v
                for v in vol))
        self._setup(volumes, names, slice_thickness, target_thickness,
                    patch_size, random_flip, blur, nnunet_transform, seed,
                    device_lr_sim, channels)

    @classmethod
    def from_volumes(cls, volumes, slice_thickness, target_thickness,
                     patch_size, random_flip, blur=True,
                     nnunet_transform=False, seed=0, device_lr_sim=False,
                     channels=2):
        """The dataset over in-memory volumes: ``volumes`` a list of
        (img_hr (x, y, z, 1), label_hr (x, y, z, 1), image_x_rgb,
        image_y_rgb) arrays, the last two (z, 1, x, y) / (z, 1, y, x) as
        :func:`..infer.sr_infer.postprocess_sr_volume` makes them (None
        without ``blur``): what the constructor holds once it has read a
        stage-1 store."""
        self = cls.__new__(cls)
        self.image_path = None
        self.blur = blur
        vols = [tuple(np.asarray(v) if v is not None else None for v in vol)
                for vol in volumes]
        self._setup(vols, [f"volume{i}" for i in range(len(vols))],
                    slice_thickness, target_thickness, patch_size,
                    random_flip, blur, nnunet_transform, seed,
                    device_lr_sim, channels)
        return self

    def _setup(self, volumes, names, slice_thickness, target_thickness,
               patch_size, random_flip, blur, nnunet_transform, seed,
               device_lr_sim, channels):
        if len(patch_size) == 2:
            patch_size = (*patch_size, 1)
        self.patch_size = tuple(patch_size)
        self.channels = int(channels)
        self.random_flip = random_flip
        self.blur = blur
        self.device_lr_sim = device_lr_sim
        self.slice_separation = float(slice_thickness / target_thickness)
        self.rng = np.random.default_rng(seed)
        self.subjects = list(names)
        self.transform = None
        if nnunet_transform:
            # intensity only (enable_spatial=False), train_set.py:259-277
            self.transform = TrainingTransforms(
                self.patch_size, enable_spatial=False,
                enable_uncertainty=self.blur,
                extra_keys=["seg", "img_lr"] if self.blur else ["seg"])
        self.imgs_hr = [v[0] for v in volumes]
        self.labels_hr = [v[1] for v in volumes]
        self.filtered_x = [v[2] for v in volumes]
        self.filtered_y = [v[3] for v in volumes]

    def _load(self, name):
        """A subject's HR (x, y, z, c) image and label and the blurred
        copies in (z, c, x, y) layout (train_set.py:303-335)."""
        image, _, _, blur_fwhm, *_ = parse_image(
            os.path.join(self.image_path, name), self._slice_thickness,
            self._target_thickness)
        if name.endswith(".h5"):
            return (image["img_hr"], image["label_hr"],
                    image["image_x_rgb"] if self.blur else None,
                    image["image_y_rgb"] if self.blur else None)
        image = np.squeeze(image)
        if image.ndim == 3:
            image = image[..., np.newaxis]
        kernel = parse_kernel(self._blur_kernel_file,
                              self._blur_kernel_name, blur_fwhm)
        fx = fy = None
        if self.blur:
            # blur along x of (z, c, x, y): the reference's F.conv2d over
            # dim 2
            fx = blur_axis_np(image.transpose(2, 3, 0, 1)[:, 0:1]
                              .astype(np.float32), kernel, axis=2)
            fy = blur_axis_np(image.transpose(2, 3, 1, 0)[:, 0:1]
                              .astype(np.float32), kernel, axis=2)
        return image[..., :1], image[..., 1:].astype(np.uint8), fx, fy

    def __len__(self):
        return len(self.subjects)

    def sample(self, i=None, rng=None):
        """Draw one (img_lr, img_hr) channels-last pair."""
        rng = rng or self.rng
        if i is None:
            i = int(rng.integers(0, len(self.subjects)))
        img_hr = self.imgs_hr[i]
        label_hr = self.labels_hr[i]
        img_lr_vol = None
        if self.blur:
            if rng.random() < 0.5:
                img_hr = np.transpose(img_hr[:], (1, 0, 2, 3))
                label_hr = np.transpose(label_hr[:], (1, 0, 2, 3))
                img_lr_vol = self.filtered_y[i]
            else:
                img_lr_vol = self.filtered_x[i]
        elif rng.random() < 0.5:
            img_hr = np.transpose(img_hr[:], (1, 0, 2, 3))
            label_hr = np.transpose(label_hr[:], (1, 0, 2, 3))

        ps = self.patch_size
        sep = self.slice_separation
        x0 = int(rng.integers(0, max(img_hr.shape[0] - ps[0], 0) + 1))
        y0 = int(rng.integers(0, max(img_hr.shape[1] - ps[1], 0) + 1))
        z0 = int(rng.integers(0, max(img_hr.shape[2] - ps[2], 0) + 1))
        img = img_hr[x0:x0 + ps[0], y0:y0 + ps[1], z0:z0 + ps[2], :]
        lab = label_hr[x0:x0 + ps[0], y0:y0 + ps[1],
                       z0:z0 + ps[2], :].astype(np.float32)
        img = img.transpose(2, 3, 0, 1)  # (z, c, x, y)
        lab = lab.transpose(2, 3, 0, 1)

        target_shape = [max(s, p) for s, p in
                        zip(img.shape, (ps[2], 1, ps[0], ps[1]))]
        img, _ = target_pad(img, target_shape, mode="constant")
        lab, _ = target_pad(lab, target_shape, mode="constant")

        if self.blur:
            lr = img_lr_vol[z0:z0 + ps[2], :, x0:x0 + ps[0], y0:y0 + ps[1]]
            lr, _ = target_pad(lr, target_shape, mode="constant")
        else:
            lr = img.copy()

        if self.transform is not None:
            # transform layout: (c, z, x, y)
            d = {"data": img.transpose(1, 0, 2, 3),
                 "seg": lab.transpose(1, 0, 2, 3)}
            if self.blur:
                d["img_lr"] = lr.transpose(1, 0, 2, 3)
            out = self.transform(rng, **d)
            img = out["data"].transpose(1, 0, 2, 3)
            lab = out["seg"].transpose(1, 0, 2, 3)
            lr = (out["img_lr"].transpose(1, 0, 2, 3) if self.blur
                  else img.copy())

        img_hr_p = np.concatenate([img, lab], axis=1)  # (z, 2, x, y)
        if self.device_lr_sim:
            # the pre-resize LR source: the downsample and the slice
            # dropout run on the device (.device_sr_sim)
            img_lr_p = np.concatenate([lr, lab], axis=1)
        else:
            # LR: B-spline downsample of the through-plane (x) axis
            lr = resize_1d_np(lr.astype(np.float64), sep, axis=2, order=3)
            lab_lr = resize_1d_np(lab.astype(np.float64), sep, axis=2,
                                  order=0)
            img_lr_p = np.concatenate([lr, lab_lr], axis=1)

        img_hr_p = img_hr_p.transpose(1, 2, 0, 3)  # (c, x, z, y)
        img_lr_p = img_lr_p.transpose(1, 2, 0, 3)

        if not self.device_lr_sim:
            if img_hr_p.shape[2] > 1 and rng.random() < 0.1:
                img_lr_p[:, 0:1] = 0.0
            if img_hr_p.shape[2] > 1 and rng.random() < 0.1:
                img_lr_p[:, -1:] = 0.0

        if self.random_flip:
            for axis in (1, 2, 3):
                if rng.random() < 0.5:
                    img_hr_p = np.flip(img_hr_p, axis=axis)
                    img_lr_p = np.flip(img_lr_p, axis=axis)

        if rng.random() < 0.5:
            img_hr_p = img_hr_p.transpose(0, 1, 3, 2)
            img_lr_p = img_lr_p.transpose(0, 1, 3, 2)

        # the thin axis squeezed for 2D (WDSR); then channels-last:
        # (c, x, z, y) -> (x, z, y, c)
        if self.patch_size[2] == 1:
            img_hr_p = (img_hr_p[:, :, 0] if img_hr_p.shape[2] == 1
                        else img_hr_p[:, :, :, 0])
            img_lr_p = (img_lr_p[:, :, 0] if img_lr_p.shape[2] == 1
                        else img_lr_p[:, :, :, 0])
        # order="C": a batch's np.stack of strided views is a slow gather
        lr_out = np.moveaxis(img_lr_p, 0, -1).astype(np.float32, order="C")
        hr_out = np.moveaxis(img_hr_p, 0, -1).astype(np.float32, order="C")
        if self.channels == 1:
            lr_out = lr_out[..., :1]
            hr_out = hr_out[..., :1]
        return lr_out, hr_out


class SegSRDataset:
    """Stage-2 dataset (TrainSetMultipleSegSREfficient parity).

    The constructor reads ``<image_path>/<subject>[_0000].h5`` stores
    (h5py, imported there); :meth:`from_volumes` takes the volumes as
    arrays."""

    def __init__(self, image_path, split_subjects, slice_thickness,
                 target_thickness, patch_size_ori, target_patch_size,
                 random_flip=False, uncertainty=False, preload=True,
                 norm=True, seed=0, device_augment=False):
        volumes = []
        for s in split_subjects:
            path = os.path.join(image_path, s + "_0000.h5")
            if not os.path.exists(path):
                path = os.path.join(image_path, s + ".h5")
            image, *_ = parse_image(path, slice_thickness, target_thickness)
            img, lab = image["img"], image["seg"]
            unc = image["uncertainty"] if uncertainty else None
            volumes.append((np.asarray(img[:]) if preload else img,
                            np.asarray(lab[:]) if preload else lab,
                            np.asarray(unc[:]) if (preload and unc is not None)
                            else unc))
        self._setup(volumes, slice_thickness, target_thickness,
                    patch_size_ori, target_patch_size, random_flip,
                    uncertainty, preload, norm, seed, device_augment)

    @classmethod
    def from_volumes(cls, volumes, slice_thickness, target_thickness,
                     patch_size_ori, target_patch_size, random_flip=False,
                     uncertainty=False, norm=True, seed=0,
                     device_augment=False):
        """The dataset over in-memory volumes: ``volumes`` a list of
        (img, seg, uncertainty) arrays in (x, y, z), uncertainty None when
        ``uncertainty`` is off; what the constructor builds once it has
        read its stores (preloaded)."""
        self = cls.__new__(cls)
        self._setup([tuple(np.asarray(v) if v is not None else None
                           for v in vol) for vol in volumes],
                    slice_thickness, target_thickness, patch_size_ori,
                    target_patch_size, random_flip, uncertainty, True, norm,
                    seed, device_augment)
        return self

    def _setup(self, volumes, slice_thickness, target_thickness,
               patch_size_ori, target_patch_size, random_flip, uncertainty,
               preload, norm, seed, device_augment):
        self.patch_size = tuple(patch_size_ori)        # (x, y, z) crop size
        self.target_patch_size = tuple(target_patch_size)
        self.separation = int(slice_thickness / target_thickness)
        self.random_flip = random_flip
        self.uncertainty = uncertainty
        self.norm = norm
        self.device_augment = device_augment
        self.rng = np.random.default_rng(seed)
        self.imgs = [v[0] for v in volumes]
        self.labels = [v[1] for v in volumes]
        self.uncertainties = [v[2] if uncertainty else None for v in volumes]
        # z-score stats are volume-wide: normalizing once at load equals
        # normalizing each draw
        self._prenormed = False
        if preload and norm:
            self.imgs = [zscore_normalization(np.asarray(v, np.float32))
                         for v in self.imgs]
            self._prenormed = True
        # dummy-2D spatial + intensity pipeline; the uncertainty is
        # continuous (train_set.py:64-84); patch (z, y, x)
        self.transform = TrainingTransforms(
            tuple(target_patch_size[::-1]), enable_spatial=True,
            enable_uncertainty=uncertainty,
            extra_keys=["seg", "seg_sr", "uncertainty"] if uncertainty
            else ["seg", "seg_sr"])

    def __len__(self):
        return len(self.imgs)

    def sample(self, i=None, rng=None):
        rng = rng or self.rng
        if i is None:
            i = int(rng.integers(0, len(self.imgs)))
        img_vol = self.imgs[i]
        if not self._prenormed:
            img_vol = np.asarray(img_vol[:], dtype=np.float32)
            if self.norm:
                img_vol = zscore_normalization(img_vol)

        ps = self.patch_size
        sep = self.separation
        x0 = int(rng.integers(0, max(img_vol.shape[0] - ps[0], 0) + 1))
        y0 = int(rng.integers(0, max(img_vol.shape[1] - ps[1], 0) + 1))
        z0 = int(rng.integers(0, max(img_vol.shape[2] - ps[2] * sep, 0) + 1))
        sl = (slice(x0, x0 + ps[0]), slice(y0, y0 + ps[1]),
              slice(z0, z0 + ps[2] * sep))
        img = np.asarray(img_vol[sl], dtype=np.float32)
        label = np.asarray(self.labels[i][sl], dtype=np.float32)
        target_shape = [max(s, p) for s, p in
                        zip(img.shape, (ps[0], ps[1], ps[2] * sep))]
        img, _ = target_pad(img, target_shape, mode="constant")
        label, _ = target_pad(label, target_shape, mode="constant")
        if self.uncertainty:
            unc = np.asarray(self.uncertainties[i][sl], dtype=np.float32)
            unc, _ = target_pad(unc, target_shape, mode="constant")

        if self.random_flip:
            for axis in (0, 1, 2):
                if rng.random() < 0.5:
                    img = np.flip(img, axis=axis)
                    label = np.flip(label, axis=axis)
                    if self.uncertainty:
                        unc = np.flip(unc, axis=axis)

        img_lr = img[:, :, ::sep]
        label_lr = label[:, :, ::sep]

        # (x, y, z) -> transform layout (c=1, z, x, y)
        def to_c_zxy(a):
            return a.transpose(2, 0, 1)[None].copy()

        if self.device_augment:
            # raw crops; the augmentation runs on the device
            def raw(a):
                return np.moveaxis(to_c_zxy(a), 0, -1).astype(np.float32)
            if self.uncertainty:
                unc_raw = 1.0 - raw(unc[:, :, ::sep]) / 255.0 * 0.99
            else:
                unc_raw = np.zeros_like(raw(label_lr))
            return {"img": raw(img_lr), "label_lr": raw(label_lr),
                    "label_hr": raw(label), "uncertainty_lr": unc_raw}

        d = {"data": to_c_zxy(img_lr), "seg": to_c_zxy(label_lr),
             "seg_sr": to_c_zxy(label)}
        if self.uncertainty:
            unc_lr = unc[:, :, ::sep]
            d["uncertainty"] = 1.0 - to_c_zxy(unc_lr) / 255.0 * 0.99
        out = self.transform(rng, **d)

        def to_out(a):   # channels-last (z, x, y, 1)
            return np.moveaxis(a, 0, -1).astype(np.float32)

        return {
            "img": to_out(out["data"]),
            "label_lr": to_out(out["seg"]),
            "label_hr": to_out(out["seg_sr"]),
            "uncertainty_lr": to_out(out["uncertainty"])
            if self.uncertainty else np.zeros_like(to_out(out["seg"])),
        }


class BatchLoader:
    """Batching iterator over a dataset's ``sample()``.

    shard=(index, count): every process draws the same per-sample child
    seeds from the shared seeded stream and materializes only its
    contiguous slice. With shard=None samples draw directly from
    ``self.rng``."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shard: tuple[int, int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        _check_shard(batch_size, shard)
        self.shard = shard

    def next(self):
        if self.shard is not None:
            index, count = self.shard
            per = self.batch_size // count
            seeds = self.rng.integers(0, 2 ** 63, size=self.batch_size)
            local = seeds[index * per:(index + 1) * per]
            samples = [self.dataset.sample(rng=np.random.default_rng(int(s)))
                       for s in local]
        else:
            samples = [self.dataset.sample(rng=self.rng)
                       for _ in range(self.batch_size)]
        return _stack_samples(samples)


def _stack_samples(samples):
    """Batch-stack a list of per-sample dicts / tuples: the one place the
    batch layout is defined."""
    if isinstance(samples[0], dict):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    n = len(samples[0])
    return tuple(np.stack([s[j] for s in samples]) for j in range(n))


def _check_shard(batch_size: int, shard):
    if shard is None:
        return
    index, count = shard
    if batch_size % count != 0:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{count} processes")
    if not (0 <= index < count):
        raise ValueError(f"shard index {index} out of range [0,{count})")


def _mp_worker(dataset, task_q, out_q):
    """A loader worker: numpy batches from seed lists until a None task.
    It never touches CUDA (the parent may have initialized it before the
    fork; ``dataset.sample`` is numpy-only)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    while True:
        task = task_q.get()
        if task is None:
            break
        idx, seeds = task
        try:
            samples = [dataset.sample(rng=np.random.default_rng(int(s)))
                       for s in seeds]
            out_q.put((idx, "ok", _stack_samples(samples)))
        except Exception as e:  # noqa: BLE001 — surfaced to the parent
            out_q.put((idx, "err", f"{type(e).__name__}: {e}"))


class MultiprocessBatchLoader:
    """``num_workers`` worker processes building whole batches in parallel
    (the reference feeds stage 2 with 4 DataLoader workers,
    train_all.py:508).

    The parent draws one seed per sample from a seeded stream and the
    workers materialize batches from those seeds; batches come back in
    order. The stream is byte-identical to ``BatchLoader(dataset,
    batch_size, seed, shard=(0, 1))``, whatever ``num_workers``. shard=
    (index, count): every process draws the whole global seed list and
    builds its contiguous slice, as ``BatchLoader(shard=)``.

    ``REHRSEG_MP_CONTEXT`` (fork, the default: the volumes are shared copy
    on write; spawn; forkserver) picks the start method. A worker that
    dies, or hangs while the others are dead, is reported by a liveness
    watchdog in :meth:`next` instead of stalling the loop."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2,
                 seed: int = 0, depth: int = 2,
                 shard: tuple[int, int] | None = None):
        import multiprocessing as mp

        _check_shard(batch_size, shard)
        self.shard = shard
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        ctx = mp.get_context(os.environ.get("REHRSEG_MP_CONTEXT", "fork"))
        self._task_q = ctx.Queue()
        self._out_q = ctx.Queue()
        self._procs = [ctx.Process(target=_mp_worker,
                                   args=(dataset, self._task_q, self._out_q),
                                   daemon=True)
                       for _ in range(int(num_workers))]
        for p in self._procs:
            p.start()
        self._inflight_cap = len(self._procs) + int(depth)
        self._next_submit = 0
        self._next_emit = 0
        self._buffer: dict = {}
        self._closed = False
        self._pump()

    def _pump(self):
        while self._next_submit - self._next_emit < self._inflight_cap:
            seeds = self.rng.integers(0, 2 ** 63, size=self.batch_size)
            if self.shard is not None:
                index, count = self.shard
                per = self.batch_size // count
                seeds = seeds[index * per:(index + 1) * per]
            self._task_q.put((self._next_submit, seeds))
            self._next_submit += 1

    def next(self):
        import queue as _queue

        if self._closed:
            raise RuntimeError("MultiprocessBatchLoader is closed")
        self._pump()
        while self._next_emit not in self._buffer:
            try:
                idx, status, item = self._out_q.get(timeout=5.0)
            except _queue.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"{len(dead)} loader worker process(es) died "
                        f"(exitcodes {[p.exitcode for p in dead]}) — a "
                        "crashed or killed child cannot report through the "
                        "queue; loader_workers=0 or REHRSEG_MP_CONTEXT=spawn "
                        "avoids fork-related deaths") from None
                continue
            if status == "err":
                raise RuntimeError(f"loader worker failed: {item}")
            self._buffer[idx] = item
        out = self._buffer.pop(self._next_emit)
        self._next_emit += 1
        return out

    def close(self):
        """Stop the workers. Results still in flight are drained while
        they exit: a worker cannot exit before its queued output is
        taken."""
        import queue as _queue
        import time

        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            self._task_q.put(None)
        deadline = time.monotonic() + 3.0
        while (any(p.is_alive() for p in self._procs)
               and time.monotonic() < deadline):
            try:
                self._out_q.get(timeout=0.05)
            except _queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=1.0)


class PrefetchLoader:
    """Background-thread prefetch around a loader's ``next()``: batch i+1's
    host prep overlaps step i on the card. The order is the wrapped
    loader's (one worker consumes its stream sequentially)."""

    def __init__(self, loader, depth: int = 2):
        import queue
        import threading

        self.loader = loader
        self._queue_mod = queue
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                try:
                    item = self.loader.next()
                except Exception as e:
                    # surfaced at next(); the worker keeps serving
                    item = e
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        if self._stop.is_set():
            raise RuntimeError("PrefetchLoader is closed")
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so a worker blocked on put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except self._queue_mod.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
