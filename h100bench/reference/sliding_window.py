"""The plain reference of a served volume: nnU-Net's sliding-window rule
with mirror TTA and gaussian weighting (zhiyuns/REHRSeg ``seg_utils.py``),
in fp32, one tile at a time.

Two tile grids: the parity grid (nnU-Net's evenly redistributed starts)
and the aligned grid (H starts snapped to multiples of 8 and W starts to
multiples of 128, the volume zero-padded at the far end just enough, the
result cropped back). Each tile is run under all 8 flips of (z, y, x), each
output unflipped, the mean weighted by a gaussian importance map and added
into fp32 sums with the weights beside them. ``logits`` returns the
weighted mean of each voxel, per class, for the LR head and, with ``hr``,
for the HR head (z upscaled).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def zscore(volume: np.ndarray) -> np.ndarray:
    v = volume.astype(np.float32, copy=True)
    mean, std = v.mean(), v.std()
    v -= mean
    v /= max(std, 1e-8)
    return v


def pad_to_patch(v: np.ndarray, patch):
    """Zero pad each axis up to the patch, split low / high (low gets the
    floor); returns (padded, pads)."""
    pads = []
    for n, p in zip(v.shape, patch):
        extra = max(int(p) - n, 0)
        pads.append((extra // 2, extra - extra // 2))
    if any(a or b for a, b in pads):
        v = np.pad(v, pads)
    return v, pads


def steps_per_axis(image_size, patch, step=0.5):
    """nnU-Net's evenly redistributed tile starts, per axis."""
    out = []
    for n, p in zip(image_size, patch):
        k = int(np.ceil((n - p) / (p * step))) + 1
        actual = (n - p) / (k - 1) if k > 1 else 1e13
        out.append([int(np.round(actual * i)) for i in range(k)])
    return out


def parity_starts(image_size, patch, step=0.5):
    s = steps_per_axis(image_size, patch, step)
    return [(a, b, c) for a in s[0] for b in s[1] for c in s[2]], \
        tuple(int(n) for n in image_size)


def aligned_starts(image_size, patch, step=0.5, snap=(8, 128)):
    """The aligned grid's starts and the padded size it covers."""
    s = steps_per_axis(image_size, patch, step)
    out, padded = [s[0]], [int(image_size[0])]
    for dim, sn in zip((1, 2), snap):
        n = len(s[dim])
        if n == 1:
            out.append([0])
            padded.append(int(image_size[dim]))
            continue
        span = image_size[dim] - patch[dim]
        span_pad = -(-span // sn) * sn
        actual = span_pad / (n - 1)
        ss = [int(np.round(actual * i / sn)) * sn for i in range(n)]
        ss[-1] = span_pad
        ss = sorted(set(ss))
        if any(b - a > patch[dim] for a, b in zip(ss, ss[1:])):
            widest = patch[dim] // sn * sn
            if widest == 0:
                raise ValueError("the aligned grid cannot cover this axis")
            ss = sorted(set(list(range(0, span_pad, widest)) + [span_pad]))
        out.append(ss)
        padded.append(int(patch[dim] + span_pad))
    return ([(a, b, c) for a in out[0] for b in out[1] for c in out[2]],
            tuple(padded))


def gaussian(shape, sigma_scale=1.0 / 8, value_scale=10.0) -> np.ndarray:
    """nnU-Net's importance map: a centred delta filtered by a gaussian of
    sigma = size / 8 per axis, scaled to a maximum of 10, zeros replaced by
    the smallest nonzero value."""
    from scipy.ndimage import gaussian_filter

    g = None
    for n in shape:
        d = np.zeros(n)
        d[n // 2] = 1.0
        a = gaussian_filter(d, n * sigma_scale, 0, mode="constant", cval=0)
        g = a if g is None else np.multiply.outer(g, a)
    g = (g / g.max() * value_scale).astype(np.float32)
    nz = g[g != 0]
    if nz.size:
        g[g == 0] = nz.min()
    return g


FLIPS = [()] + [c for r in (1, 2, 3)
                for c in itertools.combinations((0, 1, 2), r)]
FLIPS_PER_FORWARD = 4


@torch.no_grad()
def logits(model, volume: np.ndarray, patch, *, grid: str, hr: bool,
           upscale: int = 4, num_classes: int = 2, device="cpu"):
    """The weighted-mean logits of one raw (D, H, W) volume, cropped to
    it: (C, D, H, W) fp32 on ``device``, and with ``hr`` also the HR head's
    (C, D * upscale, H, W). ``model(x, hr=...)`` maps (B, pd, ph, pw, 1)
    to channels-last logits."""
    patch = tuple(int(p) for p in patch)
    d0, h0, w0 = volume.shape
    v, pads = pad_to_patch(zscore(volume), patch)
    if grid == "aligned":
        starts, padded = aligned_starts(v.shape, patch)
        v = np.pad(v, [(0, p - n) for p, n in zip(padded, v.shape)])
    elif grid == "parity":
        starts, _ = parity_starts(v.shape, patch)
    else:
        raise ValueError(f"unknown grid {grid!r}")
    vol = torch.from_numpy(v).to(device)
    pd, ph, pw = patch
    heads = [(1, torch.from_numpy(gaussian(patch)).to(device))]
    if hr:
        heads.append((upscale, torch.from_numpy(
            gaussian((pd * upscale, ph, pw))).to(device)))
    D, H, W = vol.shape
    acc = [torch.zeros((num_classes, D * z, H, W), device=device)
           for z, _ in heads]
    wsum = [torch.zeros((D * z, H, W), device=device) for z, _ in heads]
    for sx, sy, sz in starts:
        tile = vol[sx:sx + pd, sy:sy + ph, sz:sz + pw]
        sums = [0.0] * len(heads)
        for i in range(0, len(FLIPS), FLIPS_PER_FORWARD):
            combos = FLIPS[i:i + FLIPS_PER_FORWARD]
            batch = torch.stack([tile.flip(c) if c else tile
                                 for c in combos])[..., None]
            out = model(batch, hr=hr)
            out = out if hr else (out,)
            for h, o in enumerate(out):
                for j, c in enumerate(combos):
                    o_j = o[j].permute(3, 0, 1, 2)      # (C, d, h, w)
                    sums[h] = sums[h] + (o_j.flip([a + 1 for a in c])
                                         if c else o_j)
        for h, (z, g) in enumerate(heads):
            zo = sx * z
            acc[h][:, zo:zo + pd * z, sy:sy + ph, sz:sz + pw] += \
                sums[h] / len(FLIPS) * g
            wsum[h][zo:zo + pd * z, sy:sy + ph, sz:sz + pw] += g
    out = []
    for h, (z, _) in enumerate(heads):
        mean = acc[h] / wsum[h]
        (zl, _), (yl, _), (xl, _) = pads
        out.append(mean[:, zl * z:(zl + d0) * z, yl:yl + h0, xl:xl + w0])
    return tuple(out) if hr else out[0]


def gaps(ref_logits: torch.Tensor, labels) -> torch.Tensor:
    """Per voxel, the amount by which the reference's logit of the served
    label lies below the reference's best logit."""
    lab = torch.as_tensor(np.ascontiguousarray(labels),
                          device=ref_logits.device).long()
    best = ref_logits.max(0).values
    return best - ref_logits.gather(0, lab[None])[0]


def widest_gap(ref_logits: torch.Tensor, labels) -> float:
    """The largest of :func:`gaps`, over all voxels."""
    return float(gaps(ref_logits, labels).max())
