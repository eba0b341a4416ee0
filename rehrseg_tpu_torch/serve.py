"""Serving API: volume in -> segmentation mask out
(``rehrseg_tpu.serve.Segmenter`` in PyTorch).

Load SegModel weights once, then segment volumes: z-score, pad to at least
the patch, gaussian-weighted sliding window with mirror TTA through the
packed SegModel forward (K1 at the decoder concat; with
``pallas_conv=True`` also K3/K4/K5 at the stride-1 packed convs; with
``"fused"`` the deferred-norm K6 forms of K1/K3/K5), fp32 accumulation
(K2 on the aligned grid), argmax, crop. ``segment(hr=True)`` also returns
the z-upscaled HR mask from the same pass.

Runs on the card unless constructed with ``device="cpu"``; without a card
and without that, construction raises.

Not ported yet: ``segment_file`` / NIfTI I/O, checkpoint loading and the
CLI (ROADMAP queue 1 item 5), ``mesh`` and ``streaming`` (item 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .data.normalize import zscore_normalization
from .infer import sliding_window as sw
from .models import convert
from .models.segnet import SegModel
from .models.segnet_packed import segmodel_apply_packed
from .utils.device import resolve_device
from .utils.pad import target_pad, crop


@dataclass
class Segmenter:
    """Stateless-per-request volume segmenter.

    model: the port's SegModel (its weights are moved to ``device`` and
    cast to ``compute_dtype`` once). patch_size: (z, y, x) network patch.
    tile_grid: "parity" (the reference tile grid) or "aligned" (starts
    snapped to H % 8, W % 128 and K2 accumulation; needs packed_eval and
    mirror). A volume the aligned grid cannot cover is served on the
    parity grid, as in the JAX package. pallas_conv: the packed forward's
    kernel routing, "cat" (served: K1 at the decoder concat), True (every
    covered stride-1 packed conv through K1/K3/K4/K5) or "fused" ("cat"
    plus the deferred instance norm: K6a at the decoder concat, K6b/K6c at
    the offset -> aligned convs that consume a deferred norm)."""

    model: SegModel
    patch_size: tuple
    slice_separation: int = 4
    mirror: bool = True
    tile_step_size: float = 0.5
    packed_eval: bool = True
    tile_grid: str = "parity"
    mesh: object = None
    streaming: int | None = None
    num_classes: int = 2
    compute_dtype: torch.dtype = torch.bfloat16
    device: object = None
    pallas_conv: str | bool = "cat"

    def __post_init__(self):
        if self.mesh is not None or self.streaming:
            raise NotImplementedError(
                "mesh and streaming engines are still to be ported "
                "(ROADMAP queue 1, item 6)")
        if self.tile_grid not in ("parity", "aligned"):
            raise ValueError(f"tile_grid must be 'parity' or 'aligned', "
                             f"got {self.tile_grid!r}")
        if self.tile_grid == "aligned" and (
                not self.packed_eval or not self.mirror):
            raise ValueError(
                "tile_grid='aligned' requires packed_eval + mirror TTA")
        self.device = resolve_device(self.device)
        self.patch_size = tuple(int(p) for p in self.patch_size)
        self.model = self.model.to(device=self.device,
                                   dtype=self.compute_dtype).eval()
        self.model.requires_grad_(False)
        self.params = convert.flax_tree_from_module(self.model)

    @classmethod
    def from_flax(cls, params, arch: dict, patch_size, *,
                  num_classes: int = 2, slice_separation: int = 4, **kw):
        """A Segmenter over flax SegModel params (nested dict of numpy
        arrays), carried in through the weight bridge."""
        model = SegModel(num_classes=num_classes, upscale=slice_separation,
                         arch=arch)
        convert.load_flax_params(model, params)
        return cls(model=model, patch_size=patch_size,
                   slice_separation=slice_separation,
                   num_classes=num_classes, **kw)

    # ------------------------------------------------------------- models

    def _fn(self, dual: bool, plane_out: bool = False):
        """The model closure the engines call on a mirror batch."""
        if not self.packed_eval:
            def unpacked(batch):
                out = self.model(batch.to(self.compute_dtype))
                return out if dual else out[0]
            return unpacked
        arch = dict(self.model.arch)
        kw = dict(num_classes=self.num_classes, pack_max_channels=64,
                  plane_out=plane_out, pallas_conv=self.pallas_conv)
        if dual:
            kw.update(dual=True, upscale=self.model.upscale)

        def packed(batch):
            return segmodel_apply_packed(
                arch, self.params, batch.to(self.compute_dtype), **kw)
        return packed

    # ------------------------------------------------------------- core

    def _prep(self, volume_zyx: np.ndarray):
        vol = zscore_normalization(volume_zyx.astype(np.float32))[..., None]
        target_shape = [max(s, p) for s, p in zip(vol.shape[:3],
                                                  self.patch_size)]
        return target_pad(vol, target_shape + [1], mode="constant")

    def _aligned_ok(self, shape) -> bool:
        """The aligned grid refuses volumes where snapping cannot cover
        every voxel; such volumes serve the parity grid (JAX semantics)."""
        try:
            sw.aligned_sliding_window_starts(shape, self.patch_size,
                                             self.tile_step_size)
            return True
        except ValueError:
            return False

    def _hr_pads(self, pads):
        sep = self.slice_separation
        return ((pads[0][0] * sep, pads[0][1] * sep),) + tuple(pads[1:3])

    def segment(self, volume_zyx: np.ndarray, hr: bool = False):
        """volume: (z, y, x). Returns the LR uint8 mask, or (lr, hr)."""
        vol_p, pads = self._prep(volume_zyx)
        common = dict(num_classes=self.num_classes, device=self.device,
                      tile_step_size=self.tile_step_size)
        if self.tile_grid == "aligned" and self._aligned_ok(vol_p.shape[:3]):
            if hr:
                lr_full, hr_full = sw.predict_sliding_window_dual_labels_aligned(
                    self._fn(True, True), vol_p, self.patch_size,
                    slice_separation=self.slice_separation, **common)
                return (crop(lr_full, pads[:3]),
                        crop(hr_full, self._hr_pads(pads)))
            pred = sw.predict_sliding_window_labels_aligned(
                self._fn(False, True), vol_p, self.patch_size, **common)
            return crop(pred, pads[:3])
        if hr:
            lr_full, hr_full = sw.predict_sliding_window_dual_labels(
                self._fn(True), vol_p, self.patch_size,
                slice_separation=self.slice_separation, mirror=self.mirror,
                **common)
            return crop(lr_full, pads[:3]), crop(hr_full, self._hr_pads(pads))
        pred = sw.predict_sliding_window_labels(
            self._fn(False), vol_p, self.patch_size, slice_separation=1,
            mirror=self.mirror, **common)
        return crop(pred, pads[:3])

    def segment_many(self, volumes_zyx):
        """LR masks of many volumes, all on the same engine as
        :meth:`segment` (aligned only when every volume fits it)."""
        prepped = [self._prep(v) for v in volumes_zyx]
        common = dict(num_classes=self.num_classes, device=self.device,
                      tile_step_size=self.tile_step_size)
        if (self.tile_grid == "aligned"
                and all(self._aligned_ok(vol_p.shape[:3])
                        for vol_p, _ in prepped)):
            preds = sw.predict_sliding_window_labels_aligned_many(
                self._fn(False, True), [vol_p for vol_p, _ in prepped],
                self.patch_size, **common)
        elif self.tile_grid == "aligned":
            # mixed coverage: stay engine-consistent per volume
            return [self.segment(v) for v in volumes_zyx]
        else:
            preds = sw.predict_sliding_window_labels_many(
                self._fn(False), [vol_p for vol_p, _ in prepped],
                self.patch_size, slice_separation=1, mirror=self.mirror,
                **common)
        return [crop(p, pads[:3]) for p, (_, pads) in zip(preds, prepped)]
