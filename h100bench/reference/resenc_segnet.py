"""A frozen plain-PyTorch copy of nnU-Net's residual-encoder UNet with
REHRSeg's SR head: ``ResidualEncoderUNet`` with ``BasicBlockD`` blocks
(MIC-DKFZ/dynamic-network-architectures ``architectures/unet.py``,
``building_blocks/residual.py``; the ResEnc presets of arXiv:2404.09556),
the decoder and SR head as ``reference/segnet.py``'s.

It is the benchmark's reference for the served ResEnc SegModel and the
model whose convolutions ``h100bench.count`` counts for it. It imports
nothing of the program. Its state-dict keys are the library's
(``encoder.stem.convs.0.{conv,norm}``,
``encoder.stages.{s}.blocks.{b}.conv1`` / ``.conv2``, the skip's bias-free
projection at ``.skip.1`` after a pool, ``.skip.0`` without one), which
the program's SegModel uses too, so one state dict loads into both.

A block: ``lrelu(IN(conv2(lrelu(IN(conv1_stride(x))))) + r)``, ``r`` the
identity, or ``AvgPool3d(stride, stride)`` where the block strides, then
the 1x1x1 conv + IN where its channels change. ``conv_hook`` and
``conv_observer`` as ``reference/segnet.py``'s (the fp8 control and the
operation count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .segnet import (ConvNormAct, Decoder, InstanceNorm, StackedConvs,
                     instance_norm, linear_upsample_matrix)

ARCH_KEYS = ("n_stages", "features_per_stage", "kernel_sizes", "strides",
             "n_blocks_per_stage", "n_conv_per_stage_decoder", "conv_bias",
             "norm_eps", "norm_affine", "nonlin_slope")


def arch_from_config(cfg: dict) -> dict:
    """The arch dict of a configuration file's keys (lists as tuples)."""
    def tup(v):
        if isinstance(v, list):
            return tuple(tup(x) for x in v)
        return v
    return {k: tup(cfg[k]) for k in ARCH_KEYS}


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class Projection(nn.Module):
    """The skip's bias-free 1x1x1 conv and its instance norm."""

    def __init__(self, ci, co, a):
        super().__init__()
        self.conv = nn.Conv3d(ci, co, 1, bias=False)
        self.norm = InstanceNorm(co, a["norm_eps"])


class BasicBlockD(nn.Module):
    def __init__(self, ci, co, k, stride, a):
        super().__init__()
        stride = _t3(stride)
        self.conv1 = ConvNormAct(ci, co, k, stride, a)
        self.conv2 = ConvNormAct(co, co, k, (1, 1, 1), a)
        ops = []
        self.pool = stride if stride != (1, 1, 1) else None
        if self.pool is not None:
            ops.append(nn.AvgPool3d(stride, stride))
        if ci != co:
            ops.append(Projection(ci, co, a))
        self.skip = nn.Sequential(*ops)


class Encoder(nn.Module):
    def __init__(self, a, cin):
        super().__init__()
        f = a["features_per_stage"]
        self.stem = StackedConvs(cin, f[0], a["kernel_sizes"][0], 1,
                                 (1, 1, 1), a)
        self.stages = nn.ModuleList()
        for s in range(a["n_stages"]):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                BasicBlockD(f[max(s - 1, 0)] if b == 0 else f[s], f[s],
                            a["kernel_sizes"][s],
                            a["strides"][s] if b == 0 else (1, 1, 1), a)
                for b in range(a["n_blocks_per_stage"][s]))
            self.stages.append(stage)


class SegModel(nn.Module):
    """forward(x) -> (lr_logits, hr_logits), or lr_logits alone with
    ``hr=False``; with ``features=True`` also the encoder's skips
    (channels-first)."""

    def __init__(self, arch: dict, num_classes: int = 2, upscale: int = 4,
                 input_channels: int = 1):
        super().__init__()
        a = dict(arch)
        self.arch, self.upscale = a, upscale
        self.encoder = Encoder(a, input_channels)
        self.decoder = Decoder(a, num_classes)
        self.sr_head = nn.Sequential(
            nn.Conv3d(a["features_per_stage"][0], 16, 3, padding=1),
            nn.ReLU(), nn.Conv3d(16, num_classes, 5, padding=2))
        self.conv_hook = None
        self.conv_observer = None

    def _conv(self, mod, x):
        w = mod.weight
        if self.conv_hook is not None:
            x, w = self.conv_hook(x, w)
        if isinstance(mod, nn.ConvTranspose3d):
            y = F.conv_transpose3d(x, w, mod.bias, mod.stride)
        else:
            y = F.conv3d(x, w, mod.bias, mod.stride, mod.padding)
        if self.conv_observer is not None:
            self.conv_observer(mod, x, y)
        return y

    def _cn(self, c, x, act=True):
        y = instance_norm(self._conv(c.conv, x), c.norm.weight, c.norm.bias,
                          c.norm.eps)
        return F.leaky_relu(y, self.arch["nonlin_slope"]) if act else y

    def _block(self, blk, x):
        r = x
        if blk.pool is not None:
            r = F.avg_pool3d(r, blk.pool, blk.pool)
        if len(blk.skip) and isinstance(blk.skip[-1], Projection):
            r = self._cn(blk.skip[-1], r, act=False)
        y = self._cn(blk.conv2, self._cn(blk.conv1, x), act=False)
        return F.leaky_relu(y + r, self.arch["nonlin_slope"])

    def forward(self, x, hr: bool = True, features: bool = False):
        x = x.permute(0, 4, 1, 2, 3)
        for c in self.encoder.stem.convs:
            x = self._cn(c, x)
        skips = []
        for st in self.encoder.stages:
            for blk in st.blocks:
                x = self._block(blk, x)
            skips.append(x)
        n = self.arch["n_stages"]
        lres = skips[-1]
        dec = self.decoder
        for s in range(n - 1):
            y = self._conv(dec.transpconvs[s], lres)
            lres = torch.cat([y, skips[n - 2 - s]], 1)
            for c in dec.stages[s].convs:
                lres = self._cn(c, lres)
        lr = self._conv(dec.seg_layers[str(n - 2)], lres)
        out = [lr.permute(0, 2, 3, 4, 1)]
        if hr:
            M = torch.tensor(linear_upsample_matrix(lres.shape[2],
                                                    self.upscale),
                             dtype=lres.dtype, device=lres.device)
            up = torch.einsum("ncdhw,ed->ncehw", lres, M)
            h = F.relu(self._conv(self.sr_head[0], up))
            out.append(self._conv(self.sr_head[2], h).permute(0, 2, 3, 4, 1))
        if features:
            out.append(skips)
        return out[0] if len(out) == 1 else tuple(out)
