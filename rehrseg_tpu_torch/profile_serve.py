"""Where a served volume's time goes on the card.

    python -m rehrseg_tpu_torch.profile_serve [--pallas-conv cat|true|fused]

Runs ``Segmenter.segment(volume, hr=True)`` on the aligned grid at the bench
geometry (full-width DEFAULT_ARCH with seeded random weights, patch
(16, 320, 384), volume (20, 455, 633), bf16) once to warm up, then once
under ``torch.profiler`` with CPU and CUDA activities. ``--pallas-conv
true`` profiles the same dual aligned volume through the engine with the
``pallas_conv=True`` forward instead (``Segmenter(pallas_conv=True)``: K1,
K3 and K5 on every tile), ``--pallas-conv fused`` through the deferred-norm
forward (``Segmenter(pallas_conv="fused")``: K6a, K6b and K6c on every
tile). Prints one JSON line:
the profiled call's wall time, the device's busy time (sum of kernel
times) and idle share, CUDA time by kernel class, the 25 kernels with
the most CUDA time, and the convolutions with the most, by shape (input
shapes are recorded, which adds host time to the profiled call, not device
time). With ``cat``, a second line times one 8-way dual tile forward
(CUDA events) under each ``sr_head_form`` (the same math, emitted as
different convs), with cuDNN's algorithm search off (the default) and on.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-name fragments -> class, first match wins. The Hopper kernels are
# named by their tap geometry: bf16 K1 conv_wgmma_kernel<Pad11Cat, ..>, K5
# <Valid3, ..>, their deferred-norm forms K6a <K6aPad11Cat<..>, ..> and K6c
# <K6cValid3<..>, ..>, K4 conv_resident_kernel<Pad11> and K3 (and K7)
# <Valid2>, its deferred-norm form K6b <K6bValid2<..>>, or
# conv_wgmma_kernel<Pad11, ..> / <Valid2, ..> / <K6bValid2<..>, ..> where the
# weights do not fit in shared memory (the K6 forms are listed first: their
# names hold the plain ones'). The fp32 kernels are conv_wgmma_kernel
# instantiations whose Convs' names hold the bf16 ones': K1, K4 and K6a
# <Pad11CatF32, ..>, <Pad11F32, ..> and <K6aPad11CatF32<..>, ..>, K3 and K7
# <Valid2F32, ..>, K6b <K6bValid2F32<..>, ..>, K5 <Valid3F32, ..> and K6c
# <K6cValid3F32<..>, ..>.
_CLASSES = (
    ("k6a_pconv_pad11_cat_stats", ("K6aPad11Cat",)),
    ("k6c_pconv3_valid_fused", ("K6cValid3",)),
    ("k6b_pconv_valid_fused", ("K6bValid2",)),
    ("k1_pconv_pad11_cat", ("Pad11Cat",)),
    ("k4_pconv_pad11", ("Pad11",)),
    ("k3_pconv_valid", ("Valid2",)),
    ("k5_pconv3_valid", ("Valid3",)),
    ("k2_accumulate_tta_tile", ("accumulate_kernel",)),
    ("conv_and_gemm", ("conv", "gemm", "xmma", "cutlass", "sm90_", "sm80_",
                       "cudnn", "implicit")),
    ("copy_and_layout", ("copy", "cat", "pad", "flip", "permute",
                         "CatArray", "memcpy", "Memcpy")),
    ("reduction", ("reduce", "Reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def _classify(name: str) -> str:
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pallas-conv", choices=("cat", "true", "fused"),
                    default="cat",
                    help="the packed forward's kernel routing to profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .models import convert
    from .models.segnet import DEFAULT_ARCH
    from .serve import Segmenter

    seg = Segmenter.from_flax(convert.random_flax_params(DEFAULT_ARCH, 0),
                              DEFAULT_ARCH, (16, 320, 384),
                              compute_dtype=torch.bfloat16,
                              tile_grid="aligned",
                              pallas_conv=(True if args.pallas_conv == "true"
                                           else args.pallas_conv))
    vol = np.random.default_rng(0).normal(size=(20, 455, 633)).astype(
        np.float32)

    def volume():
        return seg.segment(vol, hr=True)
    volume()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        volume()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    kernels = [(e.key, _device_ms(e, "self_"), e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    by_class: dict[str, float] = {}
    for name, ms, _ in kernels:
        cls = _classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    kernels.sort(key=lambda k: -k[1])
    print(json.dumps({
        "phase": "profile", "card": _card(),
        "pallas_conv": args.pallas_conv,
        "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                        for n, ms, c in kernels[:25]],
        "top_convs": _top_convs(prof),
    }), flush=True)
    if args.pallas_conv == "cat":
        print(json.dumps({"phase": "sr_head_forms",
                          "tile_dual_forward_ms": _head_forms(seg)}),
              flush=True)
    return 0


def _device_ms(event, prefix="") -> float:
    """An averaged profiler event's device time in ms (``prefix="self_"``
    for its own kernels only, "" to include its children's)."""
    us = getattr(event, f"{prefix}device_time_total", None)
    if us is None:
        us = getattr(event, f"{prefix}cuda_time_total")
    return us / 1e3


def _top_convs(prof, n=8) -> list:
    """The convolutions with the most device time, by input and weight
    shape (channels-first views, as cuDNN receives them)."""
    convs = [dict(input=e.input_shapes[0], weight=e.input_shapes[1],
                  ms=_device_ms(e), count=e.count)
             for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::_convolution"]
    return sorted(convs, key=lambda c: -c["ms"])[:n]


def _head_forms(seg) -> dict:
    from .models.segnet_packed import segmodel_apply_packed

    tile = torch.randn(8, 16, 320, 384, 1, device=seg.device,
                       dtype=torch.bfloat16)
    out = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for form in ("auto", "cell4", "legacy"):
            def fwd():
                return segmodel_apply_packed(
                    seg.model.arch, seg.params, tile, pack_max_channels=64,
                    dual=True, upscale=4, plane_out=True, pallas_conv="cat",
                    sr_head_form=form)
            with torch.no_grad():
                for _ in range(2):
                    fwd()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fwd()
                end.record()
                torch.cuda.synchronize()
            out[f"{form}{'_cudnn_benchmark' if bench else ''}"] = \
                start.elapsed_time(end) / 3
    torch.backends.cudnn.benchmark = False
    return out


if __name__ == "__main__":
    sys.exit(main())
