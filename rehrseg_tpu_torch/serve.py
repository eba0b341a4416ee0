"""Serving API: NIfTI in -> segmentation NIfTI out
(``rehrseg_tpu.serve`` in PyTorch).

Load SegModel weights once, then segment volumes: z-score, pad to at least
the patch, gaussian-weighted sliding window with mirror TTA through the
packed SegModel forward (K1 at the decoder concat; with
``pallas_conv=True`` also K3/K4/K5 at the stride-1 packed convs; with
``"fused"`` the deferred-norm K6 forms of K1/K3/K5), fp32 accumulation
(K2 on the aligned grid), argmax, crop. ``segment(hr=True)`` also returns
the z-upscaled HR mask from the same pass.

Runs on the card unless constructed with ``device="cpu"``; without a card
and without that, construction raises.

``segment_file`` reads and writes NIfTI, :func:`load_segmenter_from_checkpoint`
restores a checkpoint of ``train.checkpoint``, and the CLI serves files::

    python -m rehrseg_tpu_torch.serve IN.nii.gz --ckpt DIR --config CFG \
        --out OUT.nii.gz [--hr HR.nii.gz] [--step N|best] [--device cpu]

:class:`SRVolumizer` serves stage-1 SR: a merged 2-channel (image, label)
NIfTI in, the FLAVR pseudo-HR image and label (or the UASR uncertainty
map) out; :func:`load_sr_from_checkpoint` restores a UNet3D checkpoint, and
``--mode sr [--sr-uncertainty]`` serves it from the CLI (outputs
``<out>_img/_seg.nii.gz`` or ``<out>_uncertainty.nii.gz``). The CLI leaves
PyTorch's TF32 settings as they are: by default cuDNN runs fp32 convs in
TF32 on the card.

``Segmenter(mesh=make_mesh(..., spatial=S))`` shards each forward's
mirror-TTA batch over the mesh's 'data' rows and, with S > 1, each tile's
H over a row's S devices (``parallel.mesh``, ``parallel.spatial``) on the
parity paths, LR and dual, one weight replica per distinct device.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np
import torch

from .config import load_config
from .data.normalize import zscore_normalization
from .infer import sliding_window as sw
from .infer.sr_infer import infer_flavr_volume, restore_intensity
from .io import nifti
from .io.volume import parse_image, write_sr_niftis
from .models import convert
from .models.flavr import UNet3D
from .models.segnet import SegModel
from .models.segnet_packed import segmodel_apply_packed
from .parallel.spatial import HBlocks
from .pipeline import seg_arch_and_patches
from .train import checkpoint as ckpt
from .utils.device import resolve_device
from .utils.pad import target_pad, crop
from .utils.timer import count, span


def _indexed(device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
    the offset -> aligned convs that consume a deferred norm). streaming:
    None keeps the whole volume's accumulators on the device; an int k
    streams z-slabs of k tile rows (parity grid, LR and HR), for volumes
    whose accumulators exceed the device's memory: the same labels up to
    fp32 summation order. mesh: a (data, spatial)
    :class:`.parallel.mesh.Mesh` whose 'data' axis splits each forward's
    mirror batch over its rows and whose 'spatial' axis splits each tile's
    H over a row's devices (the parity paths: LR, dual and ``_many``; the
    JAX package meshes the LR path); ``device`` is the mesh's first. With
    a 'spatial' extent above 1 the volume, the accumulators and the label
    maps stay in even H blocks over the first data row's devices
    (``infer.sliding_window.BUFFERS`` records them). It composes with
    neither streaming nor the aligned grid, and a spatial extent above 1
    runs pallas_conv "cat" (or False, the unpacked forward through the
    packed one's plain path): True and "fused" have no spatial form and
    raise."""

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
        if self.mesh is not None and self.streaming:
            raise ValueError(
                "streaming z-slabs and mesh sharding are separate >HBM "
                "strategies and do not compose yet — pick one (a streamed "
                "slab would silently run on a single chip)")
        if self.tile_grid not in ("parity", "aligned"):
            raise ValueError(f"tile_grid must be 'parity' or 'aligned', "
                             f"got {self.tile_grid!r}")
        if self.tile_grid == "aligned" and (
                not self.packed_eval or not self.mirror
                or self.streaming or self.mesh is not None):
            raise ValueError(
                "tile_grid='aligned' requires packed_eval + mirror TTA and "
                "does not compose with streaming or mesh sharding")
        if self.mesh is not None:
            if (self.mesh.shape["spatial"] > 1
                    and self.pallas_conv in (True, "fused")):
                raise ValueError(
                    f"pallas_conv={self.pallas_conv!r} is a port-only mode "
                    f"with no spatial form; a mesh with a 'spatial' extent "
                    f"of {self.mesh.shape['spatial']} serves pallas_conv "
                    f"'cat' (the JAX package's)")
            if self.device is None:
                self.device = self.mesh.first
            elif _indexed(self.device) != _indexed(self.mesh.first):
                raise ValueError(f"device {self.device} is not the mesh's "
                                 f"first device {self.mesh.first}")
        self.device = resolve_device(self.device)
        self.patch_size = tuple(int(p) for p in self.patch_size)
        self.model = self.model.to(device=self.device,
                                   dtype=self.compute_dtype).eval()
        self.model.requires_grad_(False)
        self.params = convert.flax_tree_from_module(self.model)
        # one weight replica per distinct device a mesh names
        self._replicas = {next(self.model.parameters()).device:
                          (self.model, self.params)}

    def _replica(self, device: torch.device):
        """(module, flax-layout params) on ``device``, made once."""
        if device not in self._replicas:
            import copy

            model = copy.deepcopy(self.model).to(device)
            self._replicas[device] = (
                model, convert.flax_tree_from_module(model))
        return self._replicas[device]

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
        arch = dict(self.model.arch)
        if not self.packed_eval:
            def unpacked(batch):
                if isinstance(batch, HBlocks):
                    # H-sharded: the packed forward with nothing packed is
                    # the unpacked SegModel's math
                    return segmodel_apply_packed(
                        arch, self._replica(batch.device)[1],
                        batch.to(self.compute_dtype), dual=dual,
                        upscale=self.model.upscale,
                        num_classes=self.num_classes, pack_max_channels=0)
                out = self._replica(batch.device)[0](
                    batch.to(self.compute_dtype))
                return out if dual else out[0]
            return unpacked
        kw = dict(num_classes=self.num_classes, pack_max_channels=64,
                  plane_out=plane_out, pallas_conv=self.pallas_conv)
        if dual:
            kw.update(dual=True, upscale=self.model.upscale)

        def packed(batch):
            # an H-split batch hands its logits back as blocks: the
            # engine accumulates them on the blocks' devices
            return segmodel_apply_packed(
                arch, self._replica(batch.device)[1],
                batch.to(self.compute_dtype), **kw)
        return packed

    # ------------------------------------------------------------- core

    def _padded_shape(self, volume_zyx) -> tuple:
        """The volume's shape padded to at least the patch."""
        return tuple(max(s, p) for s, p in zip(volume_zyx.shape[:3],
                                               self.patch_size))

    def _prep(self, volume_zyx: np.ndarray):
        with span("rehrseg.segment.prep"):
            vol = zscore_normalization(
                volume_zyx.astype(np.float32))[..., None]
            return target_pad(vol, [*self._padded_shape(volume_zyx), 1],
                              mode="constant")

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
        with span("rehrseg.segment", request=count("serve.volumes")):
            vol_p, pads = self._prep(volume_zyx)
            labels = self._labels(vol_p, hr)
            with span("rehrseg.segment.crop"):
                if hr:
                    return (crop(labels[0], pads[:3]),
                            crop(labels[1], self._hr_pads(pads)))
                return crop(labels, pads[:3])

    def _labels(self, vol_p: np.ndarray, hr: bool):
        """The label map of the padded volume (and the HR one) on the
        engine the options select, uncropped."""
        common = dict(num_classes=self.num_classes, device=self.device,
                      tile_step_size=self.tile_step_size)
        if self.tile_grid == "aligned":
            if self._aligned_ok(vol_p.shape[:3]):
                if hr:
                    return sw.predict_sliding_window_dual_labels_aligned(
                        self._fn(True, True), vol_p, self.patch_size,
                        slice_separation=self.slice_separation, **common)
                return sw.predict_sliding_window_labels_aligned(
                    self._fn(False, True), vol_p, self.patch_size, **common)
            count("serve.aligned_fallbacks")
        common["mirror"] = self.mirror
        if self.streaming:
            common["z_slab_tiles"] = int(self.streaming)
        if hr:
            dual = (sw.predict_sliding_window_dual_labels_streamed
                    if self.streaming
                    else sw.predict_sliding_window_dual_labels)
            if not self.streaming:
                common["tta_mesh"] = self.mesh
            return dual(self._fn(True), vol_p, self.patch_size,
                        slice_separation=self.slice_separation, **common)
        if self.streaming:
            return sw.predict_sliding_window_labels_streamed(
                self._fn(False), vol_p, self.patch_size, **common)
        return sw.predict_sliding_window_labels(
            self._fn(False), vol_p, self.patch_size, slice_separation=1,
            tta_mesh=self.mesh, **common)

    def segment_many(self, volumes_zyx):
        """LR masks of many volumes, all on the same engine as
        :meth:`segment` (aligned only when every volume fits it; a mesh
        runs the parity engine over it): each volume's tiles and argmax
        are enqueued once it is prepared, and one fetch waits for every
        label map. Under streaming (that engine manages its own device
        memory), or on the aligned grid when some volume does not fit it,
        sequential :meth:`segment` calls."""
        aligned = self.tile_grid == "aligned"
        if self.streaming or (aligned and not all(
                self._aligned_ok(self._padded_shape(v))
                for v in volumes_zyx)):
            return [self.segment(v) for v in volumes_zyx]
        common = dict(num_classes=self.num_classes, device=self.device,
                      tile_step_size=self.tile_step_size)
        if aligned:
            fn = self._fn(False, True)
        else:
            fn = self._fn(False)
            common.update(mirror=self.mirror, tta_mesh=self.mesh)
        enqueue = (sw._aligned_labels_on_device if aligned
                   else sw._labels_on_device)
        labels, shapes = [], []
        for v in volumes_zyx:
            with span("rehrseg.segment", request=count("serve.volumes")):
                vol_p, pads = self._prep(v)
                labels.append(enqueue(fn, vol_p, self.patch_size, **common))
                shapes.append((vol_p.shape[:3], pads))
        preds = sw._to_host(labels)
        with span("rehrseg.segment.crop"):
            return [crop(p[:d, :h, :w], pads[:3])
                    for p, ((d, h, w), pads) in zip(preds, shapes)]

    # ------------------------------------------------------------- files

    def segment_file(self, in_path: str, out_path: str,
                     hr_out_path: str | None = None) -> None:
        """NIfTI in -> segmentation NIfTI out, geometry copied from the
        input; the HR mask's z-spacing is the input's / slice_separation."""
        ref = nifti.read_image_itk(in_path)
        if hr_out_path is not None:
            pred_lr, pred_hr = self.segment(ref.array.astype(np.float32),
                                            hr=True)
        else:
            pred_lr = self.segment(ref.array.astype(np.float32))
        nifti.write_image_itk(
            nifti.ItkLikeImage(pred_lr.astype(np.uint8), ref.spacing,
                               ref.origin, ref.direction), out_path)
        if hr_out_path is not None:
            sp = ref.spacing
            nifti.write_image_itk(
                nifti.ItkLikeImage(
                    pred_hr.astype(np.uint8),
                    (sp[0], sp[1], sp[2] / self.slice_separation),
                    ref.origin, ref.direction), hr_out_path)


def load_segmenter_from_checkpoint(ckpt_dir: str, arch: dict, patch_size,
                                   slice_separation: int = 4,
                                   num_classes: int = 2,
                                   step: int | str | None = None,
                                   **kw) -> Segmenter:
    """A Segmenter over a stage-2 checkpoint of ``train.checkpoint``.

    Its params are the SegModel's state dict, or ``{"seg": ...,
    "distiller": ...}`` from distillation training (the "seg" part is
    served). ``step``: a step number, the tag "best", or None for the
    latest step."""
    model = SegModel(num_classes=num_classes, upscale=slice_separation,
                     arch=arch)
    p = ckpt.restore_checkpoint_raw(ckpt_dir, step=step)["params"]
    if "seg" in p:
        p = p["seg"]
    model.load_state_dict(p, strict=True)
    return Segmenter(model=model, patch_size=tuple(patch_size),
                     slice_separation=slice_separation,
                     num_classes=num_classes, **kw)


@dataclass
class SRVolumizer:
    """Stage-1 SR serving: merged 2-channel (image + label) NIfTI in ->
    pseudo-HR image / label (or uncertainty-map) NIfTIs out, the reference's
    inference_flavr (sr_utils.py:137-242) as a service.

    model: the port's UNet3D, moved to ``device`` and cast once to
    ``compute_dtype`` (None = fp32, the reference's precision)."""

    model: UNet3D
    slice_thickness: float = 4.0
    target_thickness: float = 1.0
    batch: int = 8
    compute_dtype: torch.dtype | None = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(
            device=self.device,
            dtype=self.compute_dtype or torch.float32).eval()
        self.model.requires_grad_(False)

    @property
    def slice_separation(self) -> float:
        return self.slice_thickness / self.target_thickness

    def sr_volume(self, in_path: str, uncertainty: bool = False):
        """The SR output of one merged NIfTI, (x, y, z_out, c) fp32 in the
        source intensity range: c = (image, label), or the uncertainty map
        alone."""
        image, _, _, _, _, _, orig_min, orig_max = parse_image(
            in_path, self.slice_thickness, self.target_thickness)
        out = infer_flavr_volume(
            self.model, image.astype(np.float32), self.slice_separation,
            out_index=1 if uncertainty else 0, batch=self.batch,
            device=self.device)
        return restore_intensity(out, orig_min, orig_max)

    def sr_file(self, in_path: str, out_base: str,
                ref_path: str | None = None,
                uncertainty: bool = False) -> None:
        """in_path: merged 2-channel NIfTI. Writes ``<out_base>_img.nii.gz``
        + ``_seg.nii.gz`` (or ``_uncertainty.nii.gz``) at HR z-spacing with
        the geometry of ``ref_path`` (default: the input)."""
        out = self.sr_volume(in_path, uncertainty)
        ref = nifti.read_image_itk(ref_path or in_path)
        sep = self.slice_separation
        if uncertainty:
            write_sr_niftis(ref, out_base, sep, unc_xyz=out[..., 0])
        else:
            write_sr_niftis(ref, out_base, sep, img_xyz=out[..., 0],
                            seg_xyz=out[..., 1])


def load_sr_from_checkpoint(ckpt_dir: str, *, num_slices: int = 4,
                            slice_separation: int = 4,
                            uncertainty: bool = False,
                            img_channels: int = 2,
                            slice_thickness: float = 4.0,
                            target_thickness: float = 1.0,
                            step: int | str | None = None,
                            **kw) -> SRVolumizer:
    """An SRVolumizer over a stage-1b (flavr) or stage-1c
    (flavr_uncertainty) checkpoint of ``train.checkpoint``: the UNet3D's
    state dict."""
    model = UNet3D(img_channels=img_channels, n_inputs=num_slices,
                   n_outputs=int(slice_separation),
                   use_uncertainty=uncertainty)
    model.load_state_dict(
        ckpt.restore_checkpoint_raw(ckpt_dir, step=step)["params"],
        strict=True)
    return SRVolumizer(model=model, slice_thickness=slice_thickness,
                       target_thickness=target_thickness, **kw)


def _serve_sr(args, cfg, step) -> None:
    sr = load_sr_from_checkpoint(
        args.ckpt, num_slices=cfg.num_slices,
        slice_separation=int(cfg.slice_separation),
        uncertainty=args.sr_uncertainty,
        slice_thickness=cfg.slice_thickness,
        target_thickness=cfg.target_thickness, step=step,
        device=args.device)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        bases = [(path, os.path.join(
            args.out_dir, os.path.basename(path).replace(".nii.gz", "")))
            for path in args.inputs]
    else:
        bases = [(args.inputs[0], args.out.replace(".nii.gz", ""))]
    for path, base in bases:
        sr.sr_file(path, base, uncertainty=args.sr_uncertainty)
    for _, base in bases:
        print(f"SR -> {base}_*.nii.gz")


def main(argv=None):
    """CLI serving: ``python -m rehrseg_tpu_torch.serve IN.nii.gz --ckpt
    DIR --config CFG --out OUT.nii.gz [--hr HR.nii.gz]``, or many inputs
    with ``--out-dir``; ``--mode sr`` serves stage-1 SR volumes from a
    UNet3D checkpoint (``--sr-uncertainty`` for the UASR map).
    ``--device`` picks the device (default: the card)."""
    parser = argparse.ArgumentParser(
        description="REHRSeg volume segmentation serving (PyTorch)")
    parser.add_argument("inputs", nargs="+",
                        help="input NIfTI(s); with --out-dir, many at once")
    parser.add_argument("--ckpt", required=True,
                        help="stage-2 (or, with --mode sr, UNet3D) "
                             "checkpoint dir (<dir>/<step>/state.pt)")
    parser.add_argument("--config", required=True,
                        help="pipeline config, YAML or JSON (for arch, "
                             "patch, separation)")
    parser.add_argument("--step", default=None,
                        help="checkpoint step number or 'best'")
    parser.add_argument("--out", default=None, help="output path (1 input)")
    parser.add_argument("--hr", default=None, help="HR output path")
    parser.add_argument("--out-dir", default=None,
                        help="output directory for many inputs")
    parser.add_argument("--no-mirror", action="store_true",
                        help="disable 8-way TTA")
    parser.add_argument("--mode", choices=("seg", "sr"), default="seg",
                        help="seg (default) or stage-1 SR volume serving")
    parser.add_argument("--sr-uncertainty", action="store_true",
                        help="sr mode: emit the UASR uncertainty map "
                             "(checkpoint must be the uncertainty model)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if not args.out_dir and (len(args.inputs) != 1 or not args.out):
        parser.error("a single input needs --out (or use --out-dir)")

    cfg = load_config(args.config)
    step = args.step
    if step is not None and step != "best":
        step = int(step)
    if args.mode == "sr":
        _serve_sr(args, cfg, step)
        return
    arch, patch_size_zyx, _, _ = seg_arch_and_patches(cfg)
    seg = load_segmenter_from_checkpoint(
        args.ckpt, arch, patch_size=patch_size_zyx,
        slice_separation=int(cfg.slice_separation), step=step,
        mirror=not args.no_mirror, device=args.device)

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for path in args.inputs:
            base = os.path.basename(path).replace(".nii.gz", "_seg.nii.gz")
            hr_out = None
            if args.hr:
                # with --out-dir, --hr means "also write HR", one per input
                hr_out = os.path.join(args.out_dir, base.replace(
                    "_seg.nii.gz", "_hr_seg.nii.gz"))
            seg.segment_file(path, os.path.join(args.out_dir, base),
                             hr_out_path=hr_out)
            print(f"{path} -> {os.path.join(args.out_dir, base)}"
                  + (f" + {hr_out}" if hr_out else ""))
    else:
        seg.segment_file(args.inputs[0], args.out, hr_out_path=args.hr)
        print(f"{args.inputs[0]} -> {args.out}"
              + (f" + {args.hr}" if args.hr else ""))


if __name__ == "__main__":
    main()
