"""Stage-1 patch sampling from volumes resident on the card
(``rehrseg_tpu.data.device_sampler``).

Every subject's HR image, label and two pre-blurred copies are uploaded
once; per batch the host draws only each sample's decisions (subject,
transpose, crop origin, flips, in-plane swap: nine integers), in exactly
the order of ``SRPatchDataset.sample``'s RNG draws, and the device runs
the crop, transpose, pad, flips and swap as one gather. So a seeded stream
is bit-identical to the host loader's; only where the data moves changes.

It covers the stage-1 FLAVR path: ``device_lr_sim=True`` (the downsample
and the slice dropout run on the device, :mod:`.device_sr_sim`), no host
transform (``device_augment_sr`` augments on the device), a square
in-plane patch (ps[1] == ps[2] > 1) and 2 channels. Anything else raises
ValueError, and the caller falls back to the host loader.

Device memory: the subjects stacked in one zero canvas of (S, Xc, Yc, Zc,
4) fp32, square in-plane so a transposed crop stays inside, with a leading
margin so the host's symmetric padding of a small volume folds into the
crop origin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timer import span


def _canvas_from_dataset(ds):
    """The subjects stacked into one (S, Xc, Yc, Zc, 4) fp32 array with
    channels (image, label, blur along x, blur along y), each volume at
    the (margin, margin, margin) origin. Returns (canvas, shapes (S, 3),
    margin)."""
    ps = ds.patch_size
    m = max(ps) // 2 + 1                    # symmetric-pad headroom
    xs = [v.shape[0] for v in ds.imgs_hr]
    ys = [v.shape[1] for v in ds.imgs_hr]
    zs = [v.shape[2] for v in ds.imgs_hr]
    side = max(max(xs), max(ys), ps[0], ps[1])
    zc = max(max(zs), ps[2])
    s = len(ds.imgs_hr)
    canvas = np.zeros((s, m + side + max(ps), m + side + max(ps),
                       m + zc + ps[2], 4), np.float32)
    shapes = np.zeros((s, 3), np.int64)
    for i in range(s):
        img = np.asarray(ds.imgs_hr[i])     # (X, Y, Z, 1)
        lab = np.asarray(ds.labels_hr[i])
        fx = np.asarray(ds.filtered_x[i])   # (Z, 1, X, Y), blurred along x
        fy = np.asarray(ds.filtered_y[i])   # (Z, 1, Y, X), blurred along y
        x, y, z = img.shape[:3]
        shapes[i] = (x, y, z)
        sl = (i, slice(m, m + x), slice(m, m + y), slice(m, m + z))
        canvas[sl + (0,)] = img[..., 0]
        canvas[sl + (1,)] = lab[..., 0]
        canvas[sl + (2,)] = fx.transpose(2, 3, 0, 1)[..., 0]
        canvas[sl + (3,)] = fy.transpose(3, 2, 0, 1)[..., 0]
    return canvas, shapes, m


def gather_batch(canvas: torch.Tensor, dec: torch.Tensor, ps):
    """The batch of decision rows ``dec`` (B, 9) = (subject, t, x0, y0,
    z0, f1, f2, f3, t2), crop origins canvas-absolute, from ``canvas`` (S,
    Xc, Yc, Zc, 4) on its device. Returns (lr source, hr), each (B, ps0,
    ps2, ps1, 2) in the host sampler's (x, z, y, c) layout.

    Output voxel (x, u, v) reads, after the in-plane swap t2, (z, y) = (u,
    v) or (v, u); the flips mirror x, z, y; the transpose t reads the
    canvas's first two axes the other way round. All of it folds into one
    index per voxel, so the batch is one gather of 4-channel rows."""
    ps0, ps1, ps2 = (int(v) for v in ps)
    dev = canvas.device
    d = dec.to(device=dev, dtype=torch.int64)
    idx, t, x0, y0, z0, f1, f2, f3, t2 = (
        d[:, k].view(-1, 1, 1, 1).bool() if k in (1, 5, 6, 7, 8)
        else d[:, k].view(-1, 1, 1, 1) for k in range(9))
    x = torch.arange(ps0, device=dev).view(1, -1, 1, 1)
    u = torch.arange(ps2, device=dev).view(1, 1, -1, 1)
    v = torch.arange(ps1, device=dev).view(1, 1, 1, -1)
    zi = torch.where(t2, v, u)
    yi = torch.where(t2, u, v)
    xx = torch.where(f1, ps0 - 1 - x, x)
    zz = torch.where(f2, ps2 - 1 - zi, zi)
    yy = torch.where(f3, ps1 - 1 - yi, yi)
    c0 = torch.where(t, y0 + yy, x0 + xx)
    c1 = torch.where(t, x0 + xx, y0 + yy)
    c2 = z0 + zz
    _, xc, yc, zc, _ = canvas.shape
    lin = ((idx * xc + c0) * yc + c1) * zc + c2
    rows = canvas.reshape(-1, 4).index_select(0, lin.reshape(-1))
    p = rows.view(*lin.shape, 4)           # (B, ps0, ps2, ps1, 4)
    hr = p[..., 0:2]
    blur = torch.where(t.unsqueeze(-1), p[..., 3:4], p[..., 2:3])
    lr = torch.cat([blur, p[..., 1:2]], dim=-1)
    return lr, hr


class DeviceSRPatchSampler:
    """A BatchLoader for ``SRPatchDataset(device_lr_sim=True)`` whose
    batches are tensors gathered on ``device`` (default the card) from
    resident volumes; (lr source, hr) as the host loader's batches.

    shard=(index, count): the BatchLoader's semantics and stream: every
    process draws the global per-sample seeds and keeps its slice."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shard=None, device=None):
        ps = dataset.patch_size
        if not (dataset.device_lr_sim and dataset.blur
                and dataset.transform is None and dataset.channels == 2
                and ps[1] == ps[2] and ps[2] > 1):
            raise ValueError(
                "DeviceSRPatchSampler covers the stage-1 FLAVR hot path: "
                "device_lr_sim=True, blur=True, no host transform, "
                "2 channels, square in-plane patch; got "
                f"ps={ps}, device_lr_sim={dataset.device_lr_sim}, "
                f"blur={dataset.blur}")
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shard = shard
        if shard is not None:
            index, count = shard
            if batch_size % count:
                raise ValueError(f"batch {batch_size} % shard {count}")
        canvas, self._shapes, self._margin = _canvas_from_dataset(dataset)
        self.device_bytes = canvas.nbytes
        self._canvas = torch.from_numpy(canvas).to(resolve_device(device))
        self._ps = tuple(int(v) for v in dataset.patch_size)

    def _decisions(self, rng) -> np.ndarray:
        """One sample's decision row, drawing ``rng`` in exactly the order
        of ``SRPatchDataset.sample`` (its device_lr_sim branch)."""
        ds, ps, m = self.ds, self._ps, self._margin
        i = int(rng.integers(0, len(ds.imgs_hr)))
        t = rng.random() < 0.5
        sx, sy, sz = (int(v) for v in self._shapes[i])
        s0, s1 = (sy, sx) if t else (sx, sy)
        x0 = int(rng.integers(0, max(s0 - ps[0], 0) + 1))
        y0 = int(rng.integers(0, max(s1 - ps[1], 0) + 1))
        z0 = int(rng.integers(0, max(sz - ps[2], 0) + 1))
        f1 = f2 = f3 = False
        if ds.random_flip:
            f1 = rng.random() < 0.5
            f2 = rng.random() < 0.5
            f3 = rng.random() < 0.5
        t2 = rng.random() < 0.5
        # the host pads a (transposed) extent smaller than the patch
        # symmetrically, the low side taking the floor: the crop origin
        # backs up by the low pad
        lo0 = (ps[0] - s0) // 2 if s0 < ps[0] else 0
        lo1 = (ps[1] - s1) // 2 if s1 < ps[1] else 0
        lo2 = (ps[2] - sz) // 2 if sz < ps[2] else 0
        return np.asarray(
            [i, t, m + x0 - lo0, m + y0 - lo1, m + z0 - lo2,
             f1, f2, f3, t2], np.int32)

    def next(self):
        with span("rehrseg.sampler.next"):
            with span("rehrseg.sampler.draw"):
                if self.shard is not None:
                    index, count = self.shard
                    per = self.batch_size // count
                    seeds = self.rng.integers(0, 2 ** 63,
                                              size=self.batch_size)
                    rows = [self._decisions(np.random.default_rng(int(s)))
                            for s in seeds[index * per:(index + 1) * per]]
                else:
                    rows = [self._decisions(self.rng)
                            for _ in range(self.batch_size)]
            with span("rehrseg.sampler.gather"):
                dec = torch.from_numpy(np.stack(rows)).to(
                    self._canvas.device, non_blocking=True)
                return gather_batch(self._canvas, dec, self._ps)

    def close(self):
        self._canvas = None
