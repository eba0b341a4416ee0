"""A plain fp32 reference of nnU-Net's residual-encoder UNet with REHRSeg's
SR head, for the tests: ``ResidualEncoderUNet`` with ``BasicBlockD``
blocks (MIC-DKFZ/dynamic-network-architectures ``architectures/unet.py``,
``building_blocks/residual.py``; the ResEnc presets of arXiv:2404.09556)
and the SR head of zhiyuns/REHRSeg ``seg_model.py``.

Plain torch modules only: it imports nothing of the port and no JAX, and
has no packing, no kernels and no batching tricks. Its state-dict keys
are the library's (``encoder.stem.convs.0.{conv,norm}``,
``encoder.stages.{s}.blocks.{b}.conv1`` / ``.conv2`` / ``.skip.{i}``,
``decoder.transpconvs.{s}``, ``decoder.stages.{s}.convs.{i}``,
``decoder.seg_layers.{s}``, ``sr_head.0`` / ``sr_head.2``), without the
library's duplicate ``all_modules`` aliases.

Departures from the library, none of them in the mathematics: no dropout,
no deep supervision, and only the last decoder stage's seg layer, as
REHRSeg serves; the SR head reads the last decoder stage's features,
upsampled ``upscale`` x along z (trilinear, corners aligned).

Input (B, D, H, W, C) channels-last; ``forward(x, hr=True)`` returns the
LR logits, or (LR, HR) logits, channels-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class ConvDropoutNormReLU(nn.Module):
    """Conv, InstanceNorm3d (affine) and, unless ``act`` is False,
    LeakyReLU."""

    def __init__(self, ci, co, k, stride, a, bias=None, act=True):
        super().__init__()
        k = _t3(k)
        self.conv = nn.Conv3d(ci, co, k, stride=_t3(stride),
                              padding=tuple(kk // 2 for kk in k),
                              bias=a["conv_bias"] if bias is None else bias)
        self.norm = nn.InstanceNorm3d(co, eps=a["norm_eps"],
                                      affine=a["norm_affine"])
        self.nonlin = (nn.LeakyReLU(a["nonlin_slope"]) if act
                       else nn.Identity())

    def forward(self, x):
        return self.nonlin(self.norm(self.conv(x)))


class StackedConvBlocks(nn.Module):
    def __init__(self, n, ci, co, k, first_stride, a):
        super().__init__()
        self.convs = nn.Sequential(*[
            ConvDropoutNormReLU(ci if i == 0 else co, co, k,
                                first_stride if i == 0 else 1, a)
            for i in range(n)])

    def forward(self, x):
        return self.convs(x)


class BasicBlockD(nn.Module):
    def __init__(self, ci, co, k, stride, a):
        super().__init__()
        stride = _t3(stride)
        self.conv1 = ConvDropoutNormReLU(ci, co, k, stride, a)
        self.conv2 = ConvDropoutNormReLU(co, co, k, 1, a, act=False)
        self.nonlin2 = nn.LeakyReLU(a["nonlin_slope"])
        ops = []
        if any(s != 1 for s in stride):
            ops.append(nn.AvgPool3d(stride, stride))
        if ci != co:
            ops.append(ConvDropoutNormReLU(ci, co, 1, 1, a, bias=False,
                                           act=False))
        self.skip = nn.Sequential(*ops)      # empty: the identity

    def forward(self, x):
        return self.nonlin2(self.conv2(self.conv1(x)) + self.skip(x))


class StackedResidualBlocks(nn.Module):
    def __init__(self, n, ci, co, k, first_stride, a):
        super().__init__()
        self.blocks = nn.Sequential(*[
            BasicBlockD(ci if b == 0 else co, co, k,
                        first_stride if b == 0 else 1, a)
            for b in range(n)])

    def forward(self, x):
        return self.blocks(x)


class ResidualEncoder(nn.Module):
    def __init__(self, a, input_channels):
        super().__init__()
        f = a["features_per_stage"]
        self.stem = StackedConvBlocks(1, input_channels, f[0],
                                      a["kernel_sizes"][0], 1, a)
        self.stages = nn.Sequential(*[
            StackedResidualBlocks(a["n_blocks_per_stage"][s],
                                  f[0] if s == 0 else f[s - 1], f[s],
                                  a["kernel_sizes"][s], a["strides"][s], a)
            for s in range(a["n_stages"])])

    def forward(self, x):
        x = self.stem(x)
        skips = []
        for stage in self.stages:
            x = stage(x)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    def __init__(self, a, num_classes):
        super().__init__()
        n, f = a["n_stages"], a["features_per_stage"]
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        for s in range(n - 1):
            st = _t3(a["strides"][n - 1 - s])
            self.transpconvs.append(nn.ConvTranspose3d(
                f[n - 1 - s], f[n - 2 - s], st, stride=st,
                bias=a["conv_bias"]))
            self.stages.append(StackedConvBlocks(
                a["n_conv_per_stage_decoder"][s], 2 * f[n - 2 - s],
                f[n - 2 - s], a["kernel_sizes"][n - 2 - s], 1, a))
        self.seg_layers = nn.ModuleDict(
            {str(n - 2): nn.Conv3d(f[0], num_classes, 1)})

    def forward(self, skips):
        lres = skips[-1]
        n = len(skips)
        for s in range(n - 1):
            x = torch.cat([self.transpconvs[s](lres), skips[n - 2 - s]], 1)
            lres = self.stages[s](x)
        return self.seg_layers[str(n - 2)](lres), lres


class ResEncSegModel(nn.Module):
    def __init__(self, arch: dict, num_classes: int = 2, upscale: int = 4,
                 input_channels: int = 1):
        super().__init__()
        self.upscale = upscale
        self.encoder = ResidualEncoder(arch, input_channels)
        self.decoder = UNetDecoder(arch, num_classes)
        self.sr_head = nn.Sequential(
            nn.Conv3d(arch["features_per_stage"][0], 16, 3, padding=1),
            nn.ReLU(), nn.Conv3d(16, num_classes, 5, padding=2))

    def forward(self, x, hr: bool = True):
        lr, feats = self.decoder(self.encoder(x.permute(0, 4, 1, 2, 3)))
        lr = lr.permute(0, 2, 3, 4, 1)
        if not hr:
            return lr
        up = F.interpolate(feats, scale_factor=(self.upscale, 1, 1),
                           mode="trilinear", align_corners=True)
        return lr, self.sr_head(up).permute(0, 2, 3, 4, 1)
