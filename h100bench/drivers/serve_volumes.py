"""Driver ``serve_volumes``: one client segments volumes one after another
through the program's ``Segmenter.segment`` (a closed loop).

Traffic keys: ``volume_shape`` (D, H, W); ``distinct_volumes`` made in
set-up from the seed and cycled; ``hr`` (also the HR mask);
``segmenter`` (the Segmenter's options: ``tile_grid``, ``pallas_conv``,
``compute_dtype``); ``check_requests`` (how many finished requests the
reference checks after the window).

Correctness: a sample of finished requests, drawn from the seed, is run
through the plain reference (fp32, TF32 off) on the same weights and
volume; for each head the widest gap by which the reference's logit of
the served label lies below its best logit is compared with the cell's
limit (``limits`` in the traffic file).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import count
from ..reference import lowp
from ..reference import segnet as ref_segnet
from ..reference import sliding_window as ref_sw
from ..weights import seeded_state, shapes_of

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def make_volumes(seed: int, n: int, shape, device) -> list:
    """``n`` raw (D, H, W) fp32 host volumes: a smooth field plus noise,
    drawn on the device from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    d, h, w = shape
    coarse = torch.randn((n, 1, max(d // 4, 1), max(h // 32, 1),
                          max(w // 32, 1)), generator=gen, device=device)
    smooth = torch.nn.functional.interpolate(coarse, size=(d, h, w),
                                             mode="trilinear",
                                             align_corners=False)
    noise = torch.randn((n, 1, d, h, w), generator=gen, device=device)
    vols = (100.0 + 30.0 * smooth + 10.0 * noise)[:, 0]
    return [v.cpu().numpy() for v in vols]


def model_weights(arch: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = shapes_of(ref_segnet.SegModel(arch))
    return seeded_state(shapes, seed, device)


class ServeVolumes:
    def __init__(self, cell, seed: int, device, clock):
        from rehrseg_tpu_torch.models.segnet import SegModel
        from rehrseg_tpu_torch.serve import Segmenter

        self.cell, self.seed, self.device = cell, int(seed), device
        cfg, tr = cell.config, cell.traffic
        self.arch = ref_segnet.arch_from_config(cfg)
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
        grid = opts.get("tile_grid", "parity")
        starts = (ref_sw.aligned_starts if grid == "aligned"
                  else ref_sw.parity_starts)(
            ref_sw.pad_to_patch(np.zeros(self.shape, np.uint8),
                                self.patch)[0].shape, self.patch)[0]
        self.grid = grid
        self.tiles_per_volume = len(starts)
        self.requests = []          # (volume index, outputs)
        self.launches = {}
        self.volumes_done = 0
        self.error = None
        self.check_s = None
        self.diag = {}

    # ------------------------------------------------------------ window

    def _launch_counts(self):
        from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
        from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile

        return dict(k1=pconv_pad11_cat.launches,
                    k2=accumulate_tta_tile.launches)

    def window(self, seconds: float) -> dict:
        before = self._launch_counts()
        attempted = failed = 0
        t0 = time.perf_counter()
        t_last = t0
        i = 0
        with torch.profiler.record_function("h100bench.window"):
            while True:
                k = i % len(self.volumes)
                attempted += 1
                with torch.profiler.record_function("h100bench.request"):
                    try:
                        out = self.segmenter.segment(self.volumes[k],
                                                     hr=self.hr)
                    except RuntimeError as e:   # counted, not fatal
                        failed += 1
                        self.error = repr(e)
                        out = None
                t_last = time.perf_counter()
                if out is not None:
                    self.requests.append((k, out))
                i += 1
                if t_last - t0 >= seconds:
                    break
        after = self._launch_counts()
        done = len(self.requests)
        self.launches = {k: (after[k] - before[k]) / max(done, 1)
                         for k in after}
        self.window_s = t_last - t0
        self.volumes_done = done
        vox = done * int(np.prod(self.shape))
        return dict(attempted=attempted, failed=failed,
                    window_s=self.window_s,
                    end_to_end={"seg_vox_per_s": vox / self.window_s})

    def info(self) -> dict:
        return dict(volumes_done=self.volumes_done,
                    tiles_per_volume=self.tiles_per_volume,
                    launches_per_volume=self.launches,
                    last_error=self.error)

    # ------------------------------------------------------------ per layer

    def tile_flops(self) -> int:
        return count.seg_tile_flops(self.arch, self.patch, dual=self.hr,
                                    upscale=self.upscale)

    def k2_bytes_per_tile(self) -> int:
        heads = [1] + ([self.upscale] if self.hr else [])
        return sum(count.k2_launch_bytes(self.patch, z, self.num_classes)
                   for z in heads)

    # ------------------------------------------------------------ check

    def release(self) -> None:
        self.segmenter = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """Indices of the finished requests to check: drawn from the seed,
        one request of each distinct volume first."""
        n = int(self.cell.traffic["check_requests"])
        rng = np.random.default_rng(self.seed)
        order = list(rng.permutation(len(self.requests)))
        seen, first, rest = set(), [], []
        for j in order:
            k = self.requests[j][0]
            (rest if k in seen else first).append(j)
            seen.add(k)
        return (first + rest)[:n]

    def reference_model(self, conv_hook=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            model = ref_segnet.SegModel(self.arch, self.num_classes,
                                        self.upscale)
        model = model.to_empty(device=self.device)
        model.load_state_dict(model_weights(self.arch, self.seed,
                                            self.device))
        model.conv_hook = conv_hook
        return model.eval()

    def reference_logits(self, model, volume):
        return ref_sw.logits(model, volume, self.patch, grid=self.grid,
                             hr=self.hr, upscale=self.upscale,
                             num_classes=self.num_classes,
                             device=self.device)

    def check(self, served=None) -> list:
        """[(name, widest gap)] over the sampled requests, per head.
        ``served``: labels to judge in place of the program's, a function
        of the volume index (the control)."""
        t = time.perf_counter()
        model = self.reference_model()
        widest = ({"lr_gap": 0.0, "hr_gap": 0.0} if self.hr
                  else {"lr_gap": 0.0})
        self.diag = {}
        for j in self.sample():
            k, out = self.requests[j]
            if served is not None:
                out = served(k)
            outs = out if self.hr else (out,)
            ref = self.reference_logits(model, self.volumes[k])
            ref = ref if self.hr else (ref,)
            for name, r, o in zip(widest, ref, outs):
                g = ref_sw.gaps(r, o)
                widest[name] = max(widest[name], float(g.max()))
                for stat, v in (("mean", float(g.mean())),
                                ("wrong_share", float((g > 0).float()
                                                      .mean()))):
                    key = f"{name}.{stat}"
                    self.diag[key] = max(self.diag.get(key, 0.0), v)
                del g
            del ref
        self.check_s = time.perf_counter() - t
        return list(widest.items())

    def control_check(self) -> list:
        """:meth:`check` of the reference with its convolutions in fp8 put
        in the program's place."""
        model = self.reference_model(conv_hook=lowp.fp8_conv_hook)

        def served(k):
            out = self.reference_logits(model, self.volumes[k])
            out = out if self.hr else (out,)
            labels = [o.argmax(0).to(torch.uint8).cpu().numpy()
                      for o in out]
            return tuple(labels) if self.hr else labels[0]

        return self.check(served=served)


def setup(cell, seed, device, clock):
    return ServeVolumes(cell, seed, device, clock)
