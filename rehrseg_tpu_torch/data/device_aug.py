"""Device-side, batched nnUNet-style augmentation for stage-2 training
(``rehrseg_tpu.data.device_aug`` in PyTorch).

The same distribution as the host :class:`.transforms.TrainingTransforms`
chain, vectorized over the batch on the card:

  spatial (dummy-2D): per-sample in-plane rotation (+-pi, p=0.2) and
    scaling (0.7-1.4, p=0.2), one coordinate mesh for the data (order-3
    B-spline, :mod:`..ops.warp`) and every label (order 1 + threshold), the
    uncertainty as continuous data;
  intensity chain on the data: GaussianNoise(p=.1, std ~ U(0, .1)),
    GaussianBlur(sigma U(.5, 1), p=.2 x .5, 'symmetric' padding as scipy's
    'reflect'), BrightnessMultiplicative(.75-1.25, p=.15),
    Contrast(.75-1.25 preserve-range, p=.15), SimulateLowResolution(p=.25 x
    .5, the zoom quantized to ``_ZOOM_FACTORS``, composed nearest-down +
    cubic-up scipy.zoom matrices), Gamma(invert, p=.1) and Gamma(p=.3) with
    retained stats.

Draws and their use are two functions: :func:`draw_seg_aug_params` takes
every per-sample parameter from an explicit ``torch.Generator`` (one on
the batch's device), :func:`apply_seg_aug` applies them. The JAX package
draws from ``jax.random``: the same distribution, other draws. The
deliberate deviations from the host path are the JAX package's: mirror
boundary inside the volume with constant masking outside, quantized zoom
factors.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops import warp as W
from ..utils.timer import span

_ZOOM_FACTORS = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


@lru_cache(maxsize=32)
def _lowres_matrices(n: int) -> np.ndarray:
    """(K, n, n) composed nearest-down -> cubic-up matrices, exact
    scipy.ndimage.zoom numerics per quantized factor."""
    from scipy.ndimage import zoom
    mats = []
    eye = np.eye(n, dtype=np.float64)
    for f in _ZOOM_FACTORS:
        target = max(int(round(n * f)), 1)
        M = np.zeros((n, n))
        for k in range(n):
            down = zoom(eye[k], target / n, order=0)
            M[:, k] = zoom(down, n / len(down), order=3)[:n]
        mats.append(M)
    return np.stack(mats).astype(np.float32)


def _gauss_kernel(sigma, radius: int = 4):
    """(B, 2r+1) normalized gaussian taps for per-sample sigma (B,)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (d / sigma[:, None]) ** 2)
    return k / k.sum(-1, keepdim=True)


def _symmetric_index(n: int, pad: int, device):
    """Indices of numpy's 'symmetric' pad (d c b a | a b c d) of width
    ``pad`` on both sides of an axis of n."""
    i = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _blur3(x, sigma):
    """Separable 3D gaussian blur of (B, z, y, x) with per-sample sigma
    (B,) over all three axes."""
    k = _gauss_kernel(sigma)
    pad = (k.shape[-1] - 1) // 2
    for axis in (1, 2, 3):
        moved = torch.movedim(x, axis, -1)
        n = moved.shape[-1]
        padded = moved[..., _symmetric_index(n, pad, x.device)]
        windows = padded.unfold(-1, 2 * pad + 1, 1)     # (..., n, 2p+1)
        kk = k.reshape(k.shape[0], *([1] * (windows.ndim - 2)), -1)
        moved = (windows * kk).sum(-1)
        x = torch.movedim(moved, -1, axis)
    return x


def _where(flag, a, b):
    """Per-sample select: flag (B,) against (B, ...) tensors."""
    return torch.where(flag.reshape(-1, *([1] * (a.ndim - 1))), a, b)


def _per_sample(x):
    return x.reshape(-1, *([1] * 3))


def _uniform(gen, b, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(b, generator=gen, device=device)


# ------------------------------------------------------------------ draws

def _draw_spatial(gen, b, device):
    do_rot = _uniform(gen, b, device) < 0.2
    do_scale = _uniform(gen, b, device) < 0.2
    angle = torch.where(do_rot, _uniform(gen, b, device, -math.pi, math.pi),
                        0.0)
    low = torch.where(_uniform(gen, b, device) < 0.5,
                      _uniform(gen, b, device, 0.7, 1.0),
                      _uniform(gen, b, device, 1.0, 1.4))
    return {"angle": angle, "scale": torch.where(do_scale, low, 1.0)}


def _draw_gamma(gen, b, device, p):
    return {"apply": _uniform(gen, b, device) < p,
            "gamma": torch.where(_uniform(gen, b, device) < 0.5,
                                 _uniform(gen, b, device, 0.7, 1.0),
                                 _uniform(gen, b, device, 1.0, 1.5))}


def _draw_intensity(gen, b, shape, device):
    """shape: one sample's data shape (z, y, x)."""
    return {
        "noise": _uniform(gen, b, device) < 0.1,
        "noise_std": _uniform(gen, b, device, 0.0, 0.1),
        "noise_field": torch.randn((b, *shape), generator=gen,
                                   device=device),
        "blur": ((_uniform(gen, b, device) < 0.2)
                 & (_uniform(gen, b, device) < 0.5)),
        "sigma": _uniform(gen, b, device, 0.5, 1.0),
        "bright": _uniform(gen, b, device) < 0.15,
        "mult": _uniform(gen, b, device, 0.75, 1.25),
        "contrast": _uniform(gen, b, device) < 0.15,
        "factor": _uniform(gen, b, device, 0.75, 1.25),
        "lowres": ((_uniform(gen, b, device) < 0.25)
                   & (_uniform(gen, b, device) < 0.5)),
        "zoom_index": torch.randint(0, len(_ZOOM_FACTORS), (b,),
                                    generator=gen, device=device),
        "gamma_invert": _draw_gamma(gen, b, device, 0.1),
        "gamma": _draw_gamma(gen, b, device, 0.3),
    }


def draw_seg_aug_params(gen, batch: int, depth: int, patch_hw,
                        device=None) -> dict:
    """Every per-sample parameter of :func:`apply_seg_aug` for a batch of
    ``batch`` samples of ``depth`` LR slices cropped to ``patch_hw``,
    drawn from ``gen``."""
    device = gen.device if device is None else device
    return {"spatial": _draw_spatial(gen, batch, device),
            "intensity": _draw_intensity(gen, batch, (depth, *patch_hw),
                                         device)}


# ------------------------------------------------------------------ apply

def _spatial(params, data, segs, cont, patch_hw):
    """data (B, z, Y, X), segs list of (B, zs, Y, X) binary, cont list of
    (B, z, Y, X) continuous -> each warped to patch_hw."""
    coords, mask = W.rotate_scale_coords(patch_hw, params["angle"],
                                         params["scale"], data.shape[-2:])
    coords = coords.to(data.dtype)
    return (W.warp_data_2d(data, coords, mask),
            [W.warp_seg_2d(s, coords, mask) for s in segs],
            [W.warp_data_2d(c, coords, mask) for c in cont])


def _std(x):
    return x.std(dim=(1, 2, 3), keepdim=True, correction=0)


def _mean(x):
    return x.mean(dim=(1, 2, 3), keepdim=True)


def _gamma(p, data, invert: bool):
    x = -data if invert else data
    mn_s, sd_s = _mean(x), _std(x)
    minm = x.amin(dim=(1, 2, 3), keepdim=True)
    rnge = x.amax(dim=(1, 2, 3), keepdim=True) - minm
    y = torch.pow((x - minm) / (rnge + 1e-7), _per_sample(p["gamma"])) \
        * rnge + minm
    y = (y - _mean(y)) / (_std(y) + 1e-8) * sd_s + mn_s
    y = -y if invert else y
    return _where(p["apply"], y, data)


def _intensity(p, data):
    """The intensity chain on data (B, z, Y, X)."""
    data = _where(p["noise"],
                  data + p["noise_field"] * _per_sample(p["noise_std"]),
                  data)
    data = _where(p["blur"], _blur3(data, p["sigma"]), data)
    data = _where(p["bright"], data * _per_sample(p["mult"]), data)
    mn = _mean(data)
    contrasted = torch.clamp(
        (data - mn) * _per_sample(p["factor"]) + mn,
        data.amin(dim=(1, 2, 3), keepdim=True),
        data.amax(dim=(1, 2, 3), keepdim=True))
    data = _where(p["contrast"], contrasted, data)
    # SimulateLowResolution, in-plane only: y and x share one factor index
    mats_y = torch.as_tensor(_lowres_matrices(data.shape[2]),
                             device=data.device)[p["zoom_index"]]
    mats_x = torch.as_tensor(_lowres_matrices(data.shape[3]),
                             device=data.device)[p["zoom_index"]]
    low = torch.einsum("bzyx,bYy->bzYx", data, mats_y)
    low = torch.einsum("bzYx,bXx->bzYX", low, mats_x)
    data = _where(p["lowres"], low, data)
    data = _gamma(p["gamma_invert"], data, invert=True)
    return _gamma(p["gamma"], data, invert=False)


def apply_seg_aug(params, img, label_lr, label_hr, uncertainty, patch_hw,
                  enable_uncertainty: bool = True):
    """Apply drawn parameters: img / label_lr / uncertainty (B, z, Y, X,
    1), label_hr (B, z*sep, Y, X, 1) -> the same four cropped in-plane to
    patch_hw."""
    cont = [uncertainty[..., 0]] if enable_uncertainty else []
    im, (llr, lhr), cont = _spatial(
        params["spatial"], img[..., 0], [label_lr[..., 0], label_hr[..., 0]],
        cont, tuple(patch_hw))
    im = _intensity(params["intensity"], im)
    unc = cont[0] if enable_uncertainty else torch.zeros_like(llr)
    return (im[..., None], llr[..., None], lhr[..., None], unc[..., None])


def shard_rows(tree, shard):
    """The rows of this process's slice of a global batch's draws: every
    (B_global, ...) tensor of a nested dict cut to rows [index * B /
    count, (index + 1) * B / count). shard=None returns ``tree``."""
    if shard is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_rows(v, shard) for k, v in tree.items()}
    index, count = shard
    per = tree.shape[0] // count
    return tree[index * per:(index + 1) * per]


def global_rows(local_batch: int, shard) -> int:
    """The global batch a process with ``local_batch`` rows draws for."""
    return local_batch * (1 if shard is None else int(shard[1]))


def augment_seg_batch(gen, img, label_lr, label_hr, uncertainty, patch_hw,
                      enable_uncertainty: bool = True, shard=None):
    """Batched device augmentation for stage-2 training: draws from
    ``gen`` (a generator on the batch's device) and applies them. Shapes
    as :func:`apply_seg_aug`. shard=(index, count): the batch is this
    process's slice of a global batch; the draws are the global batch's
    (so N processes reproduce one process on the same stream) and this
    slice's rows are applied."""
    with span("rehrseg.augment"):
        b = global_rows(img.shape[0], shard)
        params = shard_rows(draw_seg_aug_params(gen, b, img.shape[1],
                                                patch_hw, img.device), shard)
        return apply_seg_aug(params, img, label_lr, label_hr, uncertainty,
                             patch_hw, enable_uncertainty)


def augment_sr_hr_batch(gen, hr, shard=None):
    """Batched intensity augmentation for stage-1 SR training: the
    intensity chain and the two gamma stages on channel 0 of hr (B, D, H,
    W, C >= 1); label channels return untouched (the reference's stage-1
    transform is intensity-only, train_set.py:259-277). shard: as
    :func:`augment_seg_batch`."""
    with span("rehrseg.augment"):
        p = shard_rows(_draw_intensity(gen, global_rows(hr.shape[0], shard),
                                       hr.shape[1:4], hr.device), shard)
        im = _intensity(p, hr[..., 0])
        return torch.cat([im[..., None], hr[..., 1:]], dim=-1)
