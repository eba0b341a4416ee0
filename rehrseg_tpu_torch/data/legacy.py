"""Legacy dataset variants kept for the reference's API surface (dead code
there): the port's own copy of ``rehrseg_tpu.data.legacy``.

Host numpy code on the port's NIfTI reader (:mod:`..io.volume`), blur
(:func:`..ops.blur.blur_axis_np`) and resize (:func:`..ops.bspline.
resize_1d_np`); every draw comes from the dataset's ``np.random.Generator``
in the JAX package's order, so a seed gives the same samples in both.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.volume import parse_image
from ..ops.blur import blur_axis_np
from ..ops.bspline import resize_1d_np
from ..utils.pad import target_pad
from ..utils.patch import get_patch, get_random_centers


def augment_3d_image(image: np.ndarray, rng: np.random.Generator):
    """Random flips of the trailing 2-D plane (reference
    utils/augmentations.py:5-17)."""
    if rng.random() < 0.5:
        image = np.flip(image, axis=-1)
    if rng.random() < 0.5:
        image = np.flip(image, axis=-2)
    return image


class LegacyTrainSet:
    """SMORE-style patch dataset with gradient-weighted sampling (reference
    train_set.py:437-520). ``__getitem__`` returns (LR patch (2, X/sep, Y),
    HR patch (2, X, Y)) in fp32."""

    def __init__(self, image, slice_separation, patch_size, ext_patch_crop,
                 blur_kernel, n_patches, patch_sampling="gradient", seed=0):
        self.n_patches = n_patches
        self.patch_size = patch_size
        self.slice_separation = slice_separation
        self.ext_patch_crop = ext_patch_crop
        self.blur_kernel = np.asarray(blur_kernel).squeeze()
        self.rng = np.random.default_rng(seed)

        self.imgs_hr, self.pads = [], []
        for im in (image, np.transpose(image, (1, 0, 2, 3))):
            target_shape = [s + p for s, p in
                            zip(im.shape[:-1], self.patch_size[:-1])] + \
                           [im.shape[2], 2]
            im, pads = target_pad(im, target_shape, mode="reflect")
            self.imgs_hr.append(im)
            self.pads.append(pads)
        self.centers = get_random_centers(
            self.imgs_hr, self.patch_size, self.n_patches,
            weighted=patch_sampling == "gradient", rng=self.rng)

    def __len__(self):
        return self.n_patches

    def __getitem__(self, i):
        aug_idx, center_idx = self.centers[i]
        patch_hr = get_patch(self.imgs_hr[aug_idx], center_idx,
                             self.patch_size)
        patch_hr = augment_3d_image(patch_hr.transpose(2, 0, 1), self.rng)
        patch_hr = patch_hr[None]                           # (1, c, X, Y)
        lr_rgb = blur_axis_np(patch_hr[:, 0:1].astype(np.float32),
                              self.blur_kernel.astype(np.float32), axis=2)
        patch_lr = np.concatenate([lr_rgb, patch_hr[:, 1:2]], axis=1)
        patch_hr = patch_hr[self.ext_patch_crop]
        patch_lr = patch_lr[self.ext_patch_crop]
        patch_lr = resize_1d_np(patch_lr.astype(np.float64),
                                self.slice_separation, axis=2, order=3)
        return patch_lr[0].astype(np.float32), patch_hr[0].astype(np.float32)


class LegacySegSRDataset:
    """Whole-volume NIfTI variant of the stage-2 dataset (reference
    TrainSetMultipleSegSR, train_set.py:161-222). ``__getitem__`` returns a
    random (image, label) patch, channels-last (z, x, y, 1), fp32."""

    def __init__(self, image_path, split_subjects, slice_thickness,
                 target_thickness, patch_size, random_flip=False, seed=0):
        if len(patch_size) == 2:
            patch_size = (*patch_size, 1)
        self.patch_size = patch_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)
        self.imgs, self.labels = [], []
        for s in split_subjects:
            image, *_ = parse_image(
                os.path.join(image_path, s + "_0000.nii.gz"),
                slice_thickness, target_thickness)
            image = np.squeeze(image)
            if image.ndim == 3:
                image = image[..., np.newaxis]
            target_shape = [max(sh, p) for sh, p in
                            zip(image.shape[:3], patch_size)] + \
                           [image.shape[3], 2]
            image, _ = target_pad(image, target_shape, mode="constant")
            self.imgs.append(image[..., :1])
            self.labels.append(image[..., 1:].astype(np.uint8))

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        rng = self.rng
        img, label = self.imgs[i], self.labels[i].astype(np.float32)
        ps = self.patch_size
        x0 = int(rng.integers(0, img.shape[0] - ps[0] + 1))
        y0 = int(rng.integers(0, img.shape[1] - ps[1] + 1))
        z0 = int(rng.integers(0, img.shape[2] - ps[2] + 1))
        img = img[x0:x0 + ps[0], y0:y0 + ps[1], z0:z0 + ps[2]]
        label = label[x0:x0 + ps[0], y0:y0 + ps[1], z0:z0 + ps[2]]
        if self.random_flip:
            for axis in (0, 1, 2):
                if rng.random() < 0.5:
                    img = np.flip(img, axis=axis)
                    label = np.flip(label, axis=axis)
        return (img.transpose(2, 0, 1, 3).astype(np.float32),
                label.transpose(2, 0, 1, 3).astype(np.float32))
