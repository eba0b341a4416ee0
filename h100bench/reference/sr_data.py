"""The plain reference of a stage-1b FLAVR batch: a frozen copy of the rules
that turn the stage-1a stores into a training batch, independent of the
program.

- Patch sampling (REHRSeg ``train_set.py`` TrainSetMultiple): per sample a
  subject, a transpose of x and y, a crop origin, three flips and an
  in-plane swap, drawn from ``numpy.random.default_rng(seed)`` in that
  order; the LR source channel is the image blurred along the transposed
  axis, the label beside it.
- The HR image's intensity chain (nnU-Net's GaussianNoise, GaussianBlur,
  BrightnessMultiplicative, Contrast, SimulateLowResolution, Gamma
  inverted and plain), every draw from a ``torch.Generator`` in a fixed
  order.
- The LR simulation (``train_set.py:394-408``): a rational B-spline
  downsample of x (cubic for the image, nearest for the label), then each
  first / last context slice zeroed with p = 0.1.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

ZOOM_FACTORS = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


# ------------------------------------------------------------ sampling

def canvas(volumes, ps):
    """The subjects (img, label, blur x, blur y; each (X, Y, Z)) stacked in
    one zero (S, Xc, Yc, Zc, 4) array at a margin; returns (canvas,
    shapes, margin)."""
    m = max(ps) // 2 + 1
    xs, ys, zs = zip(*(v[0].shape for v in volumes))
    side = max(max(xs), max(ys), ps[0], ps[1])
    zc = max(max(zs), ps[2])
    out = np.zeros((len(volumes), m + side + max(ps), m + side + max(ps),
                    m + zc + ps[2], 4), np.float32)
    for i, vol in enumerate(volumes):
        x, y, z = vol[0].shape
        for c, a in enumerate(vol):
            out[i, m:m + x, m:m + y, m:m + z, c] = a
    return out, np.asarray([v[0].shape for v in volumes]), m


def decisions(rng, shapes, ps, margin, random_flip=True):
    """One sample's (subject, t, x0, y0, z0, f1, f2, f3, t2)."""
    i = int(rng.integers(0, len(shapes)))
    t = rng.random() < 0.5
    sx, sy, sz = (int(v) for v in shapes[i])
    s0, s1 = (sy, sx) if t else (sx, sy)
    x0 = int(rng.integers(0, max(s0 - ps[0], 0) + 1))
    y0 = int(rng.integers(0, max(s1 - ps[1], 0) + 1))
    z0 = int(rng.integers(0, max(sz - ps[2], 0) + 1))
    f1 = f2 = f3 = False
    if random_flip:
        f1, f2, f3 = (rng.random() < 0.5 for _ in range(3))
    t2 = rng.random() < 0.5
    lo = [(p - s) // 2 if s < p else 0 for p, s in zip(ps, (s0, s1, sz))]
    return [i, t, margin + x0 - lo[0], margin + y0 - lo[1],
            margin + z0 - lo[2], f1, f2, f3, t2]


def crop(cv: np.ndarray, dec, ps):
    """(lr source, hr) of one sample, each (ps0, ps2, ps1, 2): x, then the
    patch's z and y (swapped by t2), every axis flipped as drawn."""
    i, t, x0, y0, z0, f1, f2, f3, t2 = (int(v) for v in dec)
    ps0, ps1, ps2 = ps
    if t:      # the transposed subject: canvas axes (y, x)
        block = cv[i, y0:y0 + ps1, x0:x0 + ps0].transpose(1, 0, 2, 3)
    else:
        block = cv[i, x0:x0 + ps0, y0:y0 + ps1]
    block = block[:, :, z0:z0 + ps2]             # (x, y, z, 4)
    if f1:
        block = block[::-1]
    if f3:
        block = block[:, ::-1]
    if f2:
        block = block[:, :, ::-1]
    block = block.transpose(0, 2, 1, 3)           # (x, z, y, 4)
    if t2:
        block = block.transpose(0, 2, 1, 3)
    hr = block[..., 0:2]
    blur = block[..., 3:4] if t else block[..., 2:3]
    return np.concatenate([blur, block[..., 1:2]], -1), hr


# ------------------------------------------------------------ intensity

def _uniform(gen, b, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(b, generator=gen, device=device)


def _gamma_draw(gen, b, device, p):
    return {"apply": _uniform(gen, b, device) < p,
            "gamma": torch.where(_uniform(gen, b, device) < 0.5,
                                 _uniform(gen, b, device, 0.7, 1.0),
                                 _uniform(gen, b, device, 1.0, 1.5))}


def draw_intensity(gen, b, shape, device):
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
        "zoom_index": torch.randint(0, len(ZOOM_FACTORS), (b,),
                                    generator=gen, device=device),
        "gamma_invert": _gamma_draw(gen, b, device, 0.1),
        "gamma": _gamma_draw(gen, b, device, 0.3),
    }


def _sel(flag, a, b):
    return torch.where(flag.reshape(-1, *([1] * (a.ndim - 1))), a, b)


def _ps(x):
    return x.reshape(-1, 1, 1, 1)


def _mean(x):
    return x.mean(dim=(1, 2, 3), keepdim=True)


def _std(x):
    return x.std(dim=(1, 2, 3), keepdim=True, correction=0)


def blur3(x, sigma, radius=4):
    """Separable gaussian blur over (z, y, x) of (B, z, y, x), per-sample
    sigma, numpy 'symmetric' edges, taps out to ``radius``."""
    d = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    k = torch.exp(-0.5 * (d / sigma[:, None]) ** 2)
    k = k / k.sum(-1, keepdim=True)
    for axis in (1, 2, 3):
        n = x.shape[axis]
        i = torch.arange(-radius, n + radius, device=x.device) % (2 * n)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
        xp = torch.index_select(x, axis, i)
        out = torch.zeros_like(x)
        for j in range(2 * radius + 1):
            out = out + xp.narrow(axis, j, n) * k[:, j].reshape(-1, 1, 1, 1)
        x = out
    return x


def lowres_matrices(n: int) -> np.ndarray:
    """(K, n, n): nearest downsample to round(n f) then cubic upsample
    back, scipy.ndimage.zoom's numerics, one per zoom factor f."""
    from scipy.ndimage import zoom

    eye = np.eye(n)
    mats = []
    for f in ZOOM_FACTORS:
        target = max(int(round(n * f)), 1)
        M = np.zeros((n, n))
        for k in range(n):
            down = zoom(eye[k], target / n, order=0)
            M[:, k] = zoom(down, n / len(down), order=3)[:n]
        mats.append(M)
    return np.stack(mats)


def _gamma(p, data, invert):
    x = -data if invert else data
    mn, sd = _mean(x), _std(x)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    rng = x.amax(dim=(1, 2, 3), keepdim=True) - lo
    y = torch.pow((x - lo) / (rng + 1e-7), _ps(p["gamma"])) * rng + lo
    y = (y - _mean(y)) / (_std(y) + 1e-8) * sd + mn
    return _sel(p["apply"], -y if invert else y, data)


def intensity(p, data):
    """The chain on (B, z, y, x)."""
    data = _sel(p["noise"], data + p["noise_field"] * _ps(p["noise_std"]),
                data)
    data = _sel(p["blur"], blur3(data, p["sigma"]), data)
    data = _sel(p["bright"], data * _ps(p["mult"]), data)
    mn = _mean(data)
    con = torch.maximum(torch.minimum(
        (data - mn) * _ps(p["factor"]) + mn,
        data.amax(dim=(1, 2, 3), keepdim=True)),
        data.amin(dim=(1, 2, 3), keepdim=True))
    data = _sel(p["contrast"], con, data)
    my = torch.as_tensor(lowres_matrices(data.shape[2]), dtype=data.dtype,
                         device=data.device)[p["zoom_index"]]
    mx = torch.as_tensor(lowres_matrices(data.shape[3]), dtype=data.dtype,
                         device=data.device)[p["zoom_index"]]
    low = torch.einsum("bzyx,bYy->bzYx", data, my)
    low = torch.einsum("bzYx,bXx->bzYX", low, mx)
    data = _sel(p["lowres"], low, data)
    data = _gamma(p["gamma_invert"], data, True)
    return _gamma(p["gamma"], data, False)


def augment_hr(gen, hr):
    """The chain on channel 0 of an HR batch (B, D, H, W, C)."""
    p = draw_intensity(gen, hr.shape[0], hr.shape[1:4], hr.device)
    return torch.cat([intensity(p, hr[..., 0])[..., None], hr[..., 1:]], -1)


# ------------------------------------------------------------ LR simulation

def resize_matrix(n: int, dx: float, order: int) -> np.ndarray:
    """(round(n / dx), n): the rational B-spline resize of the ``resize``
    package, the two grids sharing the field of view's centre, scipy's
    mirror boundary; order 0 nearest, 3 cubic."""
    from scipy.ndimage import map_coordinates

    dx = float(Fraction(dx).limit_denominator(10000))
    m = int(round(n / dx))
    coords = (n - 1) / 2.0 + (np.arange(m) - (m - 1) / 2.0) * dx
    eye = np.eye(n)
    M = np.zeros((m, n))
    for k in range(n):
        M[:, k] = map_coordinates(eye[k], [coords], order=order,
                                  mode="mirror")
    return M


def simulate_lr(gen, src, sep: float):
    """(B, X, Z, Y, 2) -> X downsampled by ``sep``, then each sample's
    first and last slice zeroed with p = 0.1 (two uniform draws)."""
    def along_x(t, order):
        M = torch.as_tensor(resize_matrix(t.shape[1], sep, order),
                            dtype=t.dtype, device=t.device)
        return torch.einsum("mx,bx...->bm...", M, t)

    out = torch.cat([along_x(src[..., 0:1], 3), along_x(src[..., 1:], 0)],
                    -1)
    if out.shape[2] > 1:
        b = out.shape[0]
        draws = [torch.rand(b, generator=gen, device=out.device)
                 for _ in range(2)]
        for idx, u in ((0, draws[0]), (-1, draws[1])):
            drop = (u < 0.1)[:, None, None, None]
            out[:, idx] = torch.where(drop, torch.zeros_like(out[:, idx]),
                                      out[:, idx])
    return out
