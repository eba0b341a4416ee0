"""Host-side stage-2 dataset and batch loaders (``rehrseg_tpu.data.
datasets``: ``SegSRDataset``, ``BatchLoader``, ``PrefetchLoader``).

``SegSRDataset`` is the reference's TrainSetMultipleSegSREfficient
(train_set.py:22-159): pseudo-HR volumes (img / seg / uncertainty) from
stage 1; a random crop of (ps_x+64, ps_y+64, ps_z*sep), flips, LR by
strided slicing [::sep], the uncertainty weight 1 - u/255*0.99, then the
dummy-2D spatial + intensity pipeline on the host, or raw crops for the
device augmentation (:mod:`.device_aug`). Samples are numpy, channels-last
(z, x, y, 1), and bit-equal to the JAX package's at the same
``np.random.default_rng`` seed.

The stage-1 ``SRPatchDataset`` and the ``MultiprocessBatchLoader`` are
still to be ported (ROADMAP queue 1, items 9 and 10).
"""

from __future__ import annotations

import os

import numpy as np

from ..io.volume import parse_image
from ..utils.pad import target_pad
from .normalize import zscore_normalization
from .transforms import TrainingTransforms


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
