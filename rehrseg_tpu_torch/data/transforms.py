"""nnUNet-style training-time augmentations (host-side numpy/scipy): the
port's own copy of ``rehrseg_tpu.data.transforms``, the stage-2 loader's
``device_augment: false`` path and the parity oracle of
:mod:`.device_aug`.

Behavioral parity with the reference augmentation chain
(reference utils/seg_utils.py:374-728), which reimplements nnUNet's
transforms on top of batchgenerators with multi-label support:

  - dummy-2D spatial transform: the 3D volume folds its z-axis into channels,
    one shared 2D coordinate mesh applies rotation (±pi) and scaling
    (0.7-1.4, p=0.2 each, elastic off) to the data (order 3) and every label
    key (order 1 + per-label thresholding); the uncertainty key interpolates
    as continuous data (seg_utils.py:465-472);
  - intensity chain: GaussianNoise(p=.1), GaussianBlur(.5-1, p=.2/.5 per
    channel), BrightnessMultiplicative(.75-1.25, p=.15), Contrast(p=.15),
    SimulateLowResolution(zoom .5-1, p=.25, ignore z), Gamma(invert p=.1) and
    Gamma(p=.3) with retained stats.

All transforms operate on dicts of (C, z, y, x) numpy arrays keyed like the
reference ('data', 'seg', 'seg_sr', 'uncertainty', 'img_lr') and take an
explicit np.random.Generator for reproducibility. batchgenerators quirks are
preserved where they affect numerics (noise 'variance' used as std; gamma <1
coin flip).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates, zoom


# ------------------------------------------------------------- spatial core

def create_zero_centered_coordinate_mesh(shape) -> np.ndarray:
    coords = np.array(
        np.meshgrid(*[np.arange(i) for i in shape], indexing="ij"),
        dtype=np.float64)
    for d in range(len(shape)):
        coords[d] -= (np.array(shape, dtype=np.float64)[d] - 1) / 2.0
    return coords


def rotate_coords_2d(coords, angle):
    rot = np.array([[np.cos(angle), -np.sin(angle)],
                    [np.sin(angle), np.cos(angle)]])
    return np.dot(coords.reshape(2, -1).T, rot).T.reshape(coords.shape)


def rotate_coords_3d(coords, ax, ay, az):
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    rot = np.dot(np.dot(rx, ry), rz)
    return np.dot(coords.reshape(3, -1).T, rot).T.reshape(coords.shape)


def interpolate_img(img, coords, order=3, mode="nearest", cval=0.0,
                    is_seg=False):
    """batchgenerators.interpolate_img semantics: segmentation maps
    interpolate per unique label with >=0.5 thresholding."""
    if is_seg and order != 0:
        unique_labels = np.unique(img)
        result = np.zeros(coords.shape[1:], img.dtype)
        for cl in unique_labels:
            if cl == 0:
                continue
            res_new = map_coordinates((img == cl).astype(np.float64), coords,
                                      order=order, mode=mode, cval=cval)
            result[res_new >= 0.5] = cl
        return result
    return map_coordinates(img.astype(np.float64), coords, order=order,
                           mode=mode, cval=cval).astype(img.dtype
                                                        if is_seg else np.float64)


def augment_spatial_2d(data, seg_list, patch_size, rng: np.random.Generator,
                       angle_x=(-np.pi, np.pi), scale=(0.7, 1.4),
                       p_rot_per_sample=0.2, p_scale_per_sample=0.2,
                       order_data=3, order_seg=1, border_mode_data="constant",
                       border_cval_data=0, border_mode_seg="constant",
                       border_cval_seg=-1, uncertainty_last=False):
    """2D (dummy-2D) spatial transform of one sample.

    data: (C, H, W); seg_list: list of (C_s, H, W) label arrays. The last
    seg entry interpolates as continuous data when uncertainty_last
    (seg_utils.py:465-472). Center crop (random_crop=False).
    """
    coords = create_zero_centered_coordinate_mesh(patch_size)
    modified = False
    if rng.uniform() < p_rot_per_sample:
        a_x = rng.uniform(angle_x[0], angle_x[1])
        coords = rotate_coords_2d(coords, a_x)
        modified = True
    if rng.uniform() < p_scale_per_sample:
        if rng.random() < 0.5 and scale[0] < 1:
            sc = rng.uniform(scale[0], 1)
        else:
            sc = rng.uniform(max(scale[0], 1), scale[1])
        coords = coords * sc
        modified = True

    for d in range(2):
        ctr = data.shape[d + 1] / 2.0 - 0.5
        coords[d] += ctr

    if not modified and tuple(patch_size) == data.shape[1:]:
        return data.astype(np.float32), [s.astype(np.float32) for s in seg_list]

    data_out = np.zeros((data.shape[0], *patch_size), dtype=np.float32)
    for c in range(data.shape[0]):
        data_out[c] = interpolate_img(data[c], coords, order_data,
                                      border_mode_data, cval=border_cval_data)
    seg_out = []
    for i, seg in enumerate(seg_list):
        out = np.zeros((seg.shape[0], *patch_size), dtype=np.float32)
        continuous = uncertainty_last and i == len(seg_list) - 1
        for c in range(seg.shape[0]):
            if continuous:
                out[c] = interpolate_img(seg[c], coords, order_data,
                                         border_mode_data,
                                         cval=border_cval_data)
            else:
                out[c] = interpolate_img(seg[c], coords, order_seg,
                                         border_mode_seg,
                                         cval=border_cval_seg, is_seg=True)
        seg_out.append(out)
    return data_out, seg_out


# --------------------------------------------------------------- intensity

def augment_gaussian_noise(data, rng, noise_variance=(0, 0.1)):
    variance = rng.uniform(*noise_variance)
    # batchgenerators passes the sampled 'variance' as normal()'s scale (std)
    return data + rng.normal(0.0, variance, size=data.shape)


def augment_gaussian_blur(data, rng, sigma_range=(0.5, 1.0),
                          p_per_channel=0.5):
    out = data.copy()
    for c in range(data.shape[0]):
        if rng.uniform() < p_per_channel:
            sigma = rng.uniform(*sigma_range)
            out[c] = gaussian_filter(data[c], sigma)
    return out


def augment_brightness_multiplicative(data, rng, multiplier_range=(0.75, 1.25)):
    return data * rng.uniform(*multiplier_range)


def augment_contrast(data, rng, contrast_range=(0.75, 1.25),
                     preserve_range=True, per_channel=True):
    out = data.copy()
    channels = range(data.shape[0]) if per_channel else [slice(None)]
    for c in channels:
        factor = rng.uniform(*contrast_range)
        mn = out[c].mean()
        if preserve_range:
            minm, maxm = out[c].min(), out[c].max()
        out[c] = (out[c] - mn) * factor + mn
        if preserve_range:
            out[c] = np.clip(out[c], minm, maxm)
    return out


def augment_linear_downsampling(data, rng, zoom_range=(0.5, 1.0),
                                p_per_channel=0.5, ignore_axes=(0,),
                                order_downsample=0, order_upsample=3):
    """SimulateLowResolutionTransform parity."""
    out = data.copy()
    spatial = data.shape[1:]
    for c in range(data.shape[0]):
        if rng.uniform() < p_per_channel:
            # batchgenerators draws ONE scalar zoom per channel applied to
            # every non-ignored axis (zoom_range entries are scalars here)
            # — per-axis draws would generate anisotropic in-plane
            # degradation the reference never produces. Backend note: this
            # port composes scipy.ndimage.zoom (order 0 down / 3 up) where
            # batchgenerators uses skimage.transform.resize; the
            # interpolation weights differ slightly at non-integer grids.
            factor = rng.uniform(*zoom_range)
            factors = [factor] * len(spatial)
            if ignore_axes is not None:
                for ax in ignore_axes:
                    factors[ax] = 1.0
            target = [max(int(round(s * f)), 1)
                      for s, f in zip(spatial, factors)]
            down = zoom(data[c], [t / s for t, s in zip(target, spatial)],
                        order=order_downsample)
            out[c] = zoom(down, [s / t for s, t in zip(spatial, down.shape)],
                          order=order_upsample, grid_mode=False)[
                              tuple(slice(0, s) for s in spatial)]
    return out


def augment_gamma(data, rng, gamma_range=(0.7, 1.5), invert_image=False,
                  per_channel=True, retain_stats=True, epsilon=1e-7):
    out = data.copy()
    if invert_image:
        out = -out
    channels = range(data.shape[0]) if per_channel else [slice(None)]
    for c in channels:
        if retain_stats:
            mn, sd = out[c].mean(), out[c].std()
        if rng.random() < 0.5 and gamma_range[0] < 1:
            gamma = rng.uniform(gamma_range[0], 1)
        else:
            gamma = rng.uniform(max(gamma_range[0], 1), gamma_range[1])
        minm = out[c].min()
        rnge = out[c].max() - minm
        out[c] = np.power(((out[c] - minm) / float(rnge + epsilon)),
                          gamma) * rnge + minm
        if retain_stats:
            out[c] = out[c] - out[c].mean()
            out[c] = out[c] / (out[c].std() + 1e-8) * sd
            out[c] = out[c] + mn
    if invert_image:
        out = -out
    return out


# ------------------------------------------------------------- full pipeline

class TrainingTransforms:
    """The reference `get_training_transforms` pipeline
    (seg_utils.py:632-728) for dicts of (C, z, y, x) arrays.

    patch_size: (z, y, x). Spatial aug is dummy-2D (z folded into channels,
    in-plane only). `extra_keys` are treated as labels; with
    enable_uncertainty the LAST extra key interpolates as continuous data.
    """

    def __init__(self, patch_size, *, enable_spatial=True,
                 enable_uncertainty=False,
                 extra_keys=("seg", "seg_sr", "uncertainty"),
                 rotation=(-np.pi, np.pi)):
        self.patch_size = tuple(patch_size)
        self.enable_spatial = enable_spatial
        self.enable_uncertainty = enable_uncertainty
        self.extra_keys = list(extra_keys)
        self.rotation = rotation

    def __call__(self, rng: np.random.Generator, **data_dict):
        data = np.asarray(data_dict["data"], dtype=np.float32)
        segs = [np.asarray(data_dict[k], dtype=np.float32)
                for k in self.extra_keys if k in data_dict]
        present_keys = [k for k in self.extra_keys if k in data_dict]

        if self.enable_spatial:
            c, z, y, x = data.shape
            data2d = data.reshape(c * z, y, x)
            segs2d = [s.reshape(s.shape[0] * s.shape[1], *s.shape[2:])
                      for s in segs]
            patch2d = self.patch_size[1:]
            data2d, segs2d = augment_spatial_2d(
                data2d, segs2d, patch2d, rng, angle_x=self.rotation,
                uncertainty_last=self.enable_uncertainty)
            data = data2d.reshape(c, z, *patch2d)
            segs = [s2.reshape(s.shape[0], s.shape[1], *patch2d)
                    for s, s2 in zip(segs, segs2d)]

        if rng.uniform() < 0.1:
            data = augment_gaussian_noise(data, rng)
        if rng.uniform() < 0.2:
            data = augment_gaussian_blur(data, rng)
        if rng.uniform() < 0.15:
            data = augment_brightness_multiplicative(data, rng)
        if rng.uniform() < 0.15:
            data = augment_contrast(data, rng)
        if rng.uniform() < 0.25:
            data = augment_linear_downsampling(data, rng)
        if rng.uniform() < 0.1:
            data = augment_gamma(data, rng, invert_image=True)
        if rng.uniform() < 0.3:
            data = augment_gamma(data, rng, invert_image=False)

        out = dict(data_dict)
        out["data"] = data.astype(np.float32)
        for k, s in zip(present_keys, segs):
            out[k] = s.astype(np.float32)
        return out
