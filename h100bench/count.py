"""The benchmark's yardstick: the chip's peaks and the operations and bytes
of the work each cell asks for, from shapes alone.

Convolution operations are counted on the benchmark's own reference models
(``h100bench.reference``) on meta tensors, counting only the taps that land
in range (no padding taps): two operations a multiply-add. Nothing here
reads the program, so a change to the program cannot move a count.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def tap_pairs(n: int, m: int, k: int, s: int, p: int,
              transposed: bool) -> int:
    """(output, tap) pairs of one dim whose input index is in range: an
    input of n, an output of m, kernel k, stride s, padding p."""
    o = (np.arange(n if transposed else m)[:, None] * s - p
         + np.arange(k)[None])
    return int(((o >= 0) & (o < (m if transposed else n))).sum())


def conv_macs(model: nn.Module, x_shape, *, by_module: bool = False,
              **forward_kw):
    """Multiply-adds of every convolution of ``model``'s forward on a meta
    input of ``x_shape`` (the model is moved to the meta device). The model
    reports its convolutions through its ``conv_observer``; per module name
    when ``by_module``."""
    model = model.to("meta")
    names = {mod: name for name, mod in model.named_modules()}
    total: dict[str, int] = {}

    def observe(mod, x, y):
        tr = isinstance(mod, nn.ConvTranspose3d)
        k, st, pad = mod.kernel_size, mod.stride, mod.padding
        nsp = x.ndim - 2
        pairs = 1
        for i in range(nsp):
            pairs *= tap_pairs(x.shape[2 + i], y.shape[2 + i], k[i], st[i],
                               pad[i], tr)
        name = names[mod]
        total[name] = total.get(name, 0) + (
            x.shape[0] * pairs * mod.in_channels * mod.out_channels
            // mod.groups)

    for m in model.modules():
        if hasattr(m, "conv_observer"):
            m.conv_observer = observe
    with torch.no_grad():
        model(torch.empty(x_shape, device="meta"), **forward_kw)
    return total if by_module else sum(total.values())


def seg_forward_flops(arch: dict, x_shape, *, dual: bool,
                      upscale: int = 4) -> int:
    """Operations of one SegModel forward on ``x_shape`` (B, D, H, W, 1):
    the encoder, decoder and LR head, and the SR head when ``dual``."""
    from .reference.segnet import SegModel

    return 2 * conv_macs(SegModel(arch, upscale=upscale), x_shape, hr=dual)


def seg_tile_flops(arch: dict, patch, *, dual: bool, flips: int = 8,
                   upscale: int = 4) -> int:
    """Operations of one served tile: ``flips`` mirror-TTA forwards of the
    patch."""
    return seg_forward_flops(arch, (flips, *patch, 1), dual=dual,
                             upscale=upscale)


def k1_launch(arch: dict, patch, flips: int = 8) -> dict:
    """K1 (the packed decoder concat + 3x3 conv at full resolution) of one
    served tile: every z slice of every flip is one image of the 2x2
    space-to-depth packing, so the kernel sees (N, h, w) = (flips * pd,
    ph / 2, pw / 2) with 4 x features[0] lanes on each of its two inputs
    and its output, and 2 x 2 taps. Each input pixel meets each tap once;
    the output is (N, h + 1, round8(w + 1), Co) bf16. Returns its
    operations and bytes (each input byte read once, each output byte
    written once)."""
    pd, ph, pw = (int(p) for p in patch)
    n, h, w = flips * pd, ph // 2, pw // 2
    c = 4 * int(arch["features_per_stage"][0])
    ca = cb = co = c
    flops = 2 * n * h * w * 4 * (ca + cb) * co
    wp8 = -(-(w + 1) // 8) * 8
    nbytes = 2 * (n * h * w * (ca + cb) + 4 * (ca + cb) * co + co
                  + n * (h + 1) * wp8 * co)
    return dict(flops=flops, bytes=nbytes)


def k2_launch_bytes(patch, z_scale: int, num_classes: int = 2,
                    flips: int = 8, pred_bytes: int = 2) -> int:
    """K2 (unmirror, mean, gaussian weight and accumulate of one tile's
    mirror-TTA predictions) at one head: the predictions and the gaussian
    read once in their dtype, the fp32 accumulator region read and
    written once."""
    pd, ph, pw = (int(p) for p in patch)
    od = pd * int(z_scale)
    return (flips * num_classes * od * ph * pw * pred_bytes
            + od * ph * pw * pred_bytes
            + 2 * num_classes * od * ph * pw * 4)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the memory's bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
