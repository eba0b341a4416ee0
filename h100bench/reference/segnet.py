"""A frozen plain-PyTorch copy of the nnU-Net SegModel: the 3d_fullres
plain-conv UNet with REHRSeg's SR head (zhiyuns/REHRSeg ``seg_model.py``).

It is the benchmark's reference for the served and trained SegModel, and
the model whose convolutions ``h100bench.count`` counts. It imports nothing
of the program: the module names follow nnU-Net's state-dict keys
(``encoder.stages.{s}.convs.{i}.conv``, ``decoder.transpconvs.{s}``,
``decoder.seg_layers.{s}``, ``sr_head.0`` / ``sr_head.2``), which the
program's SegModel uses too, so one state dict loads into both.

Input (B, D, H, W, C) channels-last, logits channels-last. ``conv_hook``
(None, or a function ``(x, w) -> (x, w)``) rewrites every convolution's
operands: the lower-precision control passes one that rounds them.
``conv_observer`` (None, or a function ``(module, x, y)``) sees every
convolution's input and output: ``h100bench.count`` counts with it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_ARCH = dict(
    n_stages=6,
    features_per_stage=(32, 64, 128, 256, 320, 320),
    kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3),
                  (3, 3, 3)),
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2),
             (1, 2, 2)),
    n_conv_per_stage=(2, 2, 2, 2, 2, 2),
    n_conv_per_stage_decoder=(2, 2, 2, 2, 2),
    conv_bias=True,
    norm_eps=1e-5,
    norm_affine=True,
    nonlin_slope=0.01,
)


def arch_from_config(cfg: dict) -> dict:
    """The arch dict of a configuration file's keys (lists as tuples)."""
    a = dict(DEFAULT_ARCH)
    for k in a:
        if k in cfg:
            v = cfg[k]
            a[k] = (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                    if isinstance(v, list) else v)
    return a


def instance_norm(x, weight, bias, eps):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * weight.view(shape) + bias.view(shape)


class InstanceNorm(nn.Module):
    """The affine parameters of one instance norm (``instance_norm``)."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class ConvNormAct(nn.Module):
    def __init__(self, ci, co, k, stride, a):
        super().__init__()
        k = _t3(k)
        self.conv = nn.Conv3d(ci, co, k, stride=_t3(stride),
                              padding=tuple(kk // 2 for kk in k),
                              bias=a["conv_bias"])
        self.norm = InstanceNorm(co, a["norm_eps"])
        self.slope = a["nonlin_slope"]


class StackedConvs(nn.Module):
    def __init__(self, ci, co, k, n, first_stride, a):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvNormAct(ci if i == 0 else co, co, k,
                        first_stride if i == 0 else (1, 1, 1), a)
            for i in range(n))


class Encoder(nn.Module):
    def __init__(self, a, cin):
        super().__init__()
        f = a["features_per_stage"]
        self.stages = nn.ModuleList(
            StackedConvs(cin if s == 0 else f[s - 1], f[s],
                         a["kernel_sizes"][s], a["n_conv_per_stage"][s],
                         a["strides"][s], a)
            for s in range(a["n_stages"]))


class Decoder(nn.Module):
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
            self.stages.append(StackedConvs(
                2 * f[n - 2 - s], f[n - 2 - s], a["kernel_sizes"][n - 2 - s],
                a["n_conv_per_stage_decoder"][s], (1, 1, 1), a))
        self.seg_layers = nn.ModuleDict(
            {str(n - 2): nn.Conv3d(f[0], num_classes, 1, bias=True)})


def linear_upsample_matrix(n: int, scale: int) -> np.ndarray:
    """(n * scale, n) linear interpolation along one axis, corners
    aligned: output j samples input position j (n - 1) / (n scale - 1)."""
    m = n * scale
    M = np.zeros((m, n))
    if n == 1:
        M[:, 0] = 1.0
        return M
    for j in range(m):
        pos = j * (n - 1) / (m - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        M[j, lo] += 1.0 - (pos - lo)
        M[j, hi] += pos - lo
    return M


class SegModel(nn.Module):
    """forward(x) -> (lr_logits, hr_logits), or lr_logits alone with
    ``hr=False``; with ``features=True`` also the encoder's skips
    (channels-first), which distillation reads."""

    def __init__(self, arch: dict | None = None, num_classes: int = 2,
                 upscale: int = 4, input_channels: int = 1):
        super().__init__()
        a = dict(DEFAULT_ARCH if arch is None else arch)
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

    def _stack(self, stack, x):
        for c in stack.convs:
            x = F.leaky_relu(instance_norm(self._conv(c.conv, x),
                                           c.norm.weight, c.norm.bias,
                                           c.norm.eps), c.slope)
        return x

    def forward(self, x, hr: bool = True, features: bool = False):
        x = x.permute(0, 4, 1, 2, 3)
        skips = []
        for st in self.encoder.stages:
            x = self._stack(st, x)
            skips.append(x)
        n = self.arch["n_stages"]
        lres = skips[-1]
        dec = self.decoder
        for s in range(n - 1):
            y = self._conv(dec.transpconvs[s], lres)
            lres = self._stack(dec.stages[s],
                               torch.cat([y, skips[n - 2 - s]], 1))
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
