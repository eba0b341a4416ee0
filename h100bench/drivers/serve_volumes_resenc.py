"""Driver ``serve_volumes_resenc``: ``serve_volumes``'s closed loop (one
client segments volumes one after another through the program's
``Segmenter.segment``) over nnU-Net's residual-encoder SegModel
(``n_blocks_per_stage`` in the configuration).

Traffic keys, limits and the check are ``serve_volumes``'s; the reference
is ``reference/resenc_segnet.py``, on which the weights are drawn and the
served tile's operations counted. ``info`` adds ``res_blocks_per_volume``,
the program's ``segnet.res_blocks`` counter over the window a volume
(absent where the program has no such counter).

Importing it registers the serving faults under its name, so
``control.py --fault`` finds them once a program seed has loaded it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import count, faults
from ..reference import resenc_segnet as ref_resenc
from ..reference import sliding_window as ref_sw
from ..weights import seeded_state, shapes_of
from .serve_volumes import DTYPES, ServeVolumes, make_volumes

faults.BY_DRIVER.setdefault("serve_volumes_resenc", faults.SERVE)


def model_weights(arch: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = shapes_of(ref_resenc.SegModel(arch))
    return seeded_state(shapes, seed, device)


def _res_blocks():
    from rehrseg_tpu_torch.utils import timer

    return timer.counters().get("segnet.res_blocks")


class ServeVolumesResEnc(ServeVolumes):
    def __init__(self, cell, seed: int, device, clock):
        from rehrseg_tpu_torch.models.segnet import SegModel
        from rehrseg_tpu_torch.serve import Segmenter

        self.cell, self.seed, self.device = cell, int(seed), device
        cfg, tr = cell.config, cell.traffic
        self.arch = ref_resenc.arch_from_config(cfg)
        self.patch = tuple(cfg["patch_size"])
        self.upscale = int(cfg["upscale"])
        self.num_classes = int(cfg["num_classes"])
        self.hr = bool(tr["hr"])
        self.shape = tuple(tr["volume_shape"])
        opts = dict(tr["segmenter"])
        opts["compute_dtype"] = DTYPES[opts.get("compute_dtype",
                                                "bfloat16")]
        with torch.device("meta"):
            model = SegModel(num_classes=self.num_classes,
                             upscale=self.upscale, arch=self.arch)
        model = model.to_empty(device=device)
        model.load_state_dict(model_weights(self.arch, seed, device))
        clock.mark("weights")
        self.segmenter = Segmenter(model=model, patch_size=self.patch,
                                   slice_separation=self.upscale,
                                   num_classes=self.num_classes,
                                   device=device, **opts)
        clock.mark("program")
        self.volumes = make_volumes(seed, int(tr["distinct_volumes"]),
                                    self.shape, device)
        clock.mark("data")
        self.segmenter.segment(self.volumes[0], hr=self.hr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock.mark("warmup")
        self.grid = opts.get("tile_grid", "parity")
        starts = (ref_sw.aligned_starts if self.grid == "aligned"
                  else ref_sw.parity_starts)(
            ref_sw.pad_to_patch(np.zeros(self.shape, np.uint8),
                                self.patch)[0].shape, self.patch)[0]
        self.tiles_per_volume = len(starts)
        self.requests = []
        self.launches = {}
        self.volumes_done = 0
        self.error = None
        self.check_s = None
        self.diag = {}
        self.res_blocks = None
        self._tile_flops = None

    def window(self, seconds: float) -> dict:
        before = _res_blocks()
        out = super().window(seconds)
        after = _res_blocks()
        if before is not None and after is not None and self.volumes_done:
            self.res_blocks = (after - before) / self.volumes_done
        return out

    def info(self) -> dict:
        out = super().info()
        if self.res_blocks is not None:
            out["res_blocks_per_volume"] = self.res_blocks
        return out

    def tile_flops(self) -> int:
        if self._tile_flops is None:
            model = ref_resenc.SegModel(self.arch, self.num_classes,
                                        self.upscale)
            self._tile_flops = 2 * count.conv_macs(
                model, (8, *self.patch, 1), hr=self.hr)
        return self._tile_flops

    def reference_model(self, conv_hook=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            model = ref_resenc.SegModel(self.arch, self.num_classes,
                                        self.upscale)
        model = model.to_empty(device=self.device)
        model.load_state_dict(model_weights(self.arch, self.seed,
                                            self.device))
        model.conv_hook = conv_hook
        return model.eval()


def setup(cell, seed, device, clock):
    return ServeVolumesResEnc(cell, seed, device, clock)
