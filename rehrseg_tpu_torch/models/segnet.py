"""SegModel: configurable plain-conv 3D UNet with an SR head
(``rehrseg_tpu.models.segnet`` as ``nn.Module``s).

The unpacked network is the oracle the packed forward
(:mod:`rehrseg_tpu_torch.models.segnet_packed`) is held against. Submodule
names follow the nnUNet / dynamic_network_architectures state-dict keys that
``rehrseg_tpu.train.torch_import.segmodel_mapping`` encodes
(``encoder.stages.{s}.convs.{i}.conv``, ``decoder.transpconvs.{s}``,
``decoder.seg_layers.{s}``, ``sr_head.0`` / ``sr_head.2``), so a reference
torch checkpoint and the flax bridge (:mod:`.convert`) land on the same keys.

Public layout is the JAX package's: input (B, D, H, W, C) channels-last,
logits channels-last. Inside, the modules run channels-first.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.bspline import upsample_axis_linear
from .layers import InstanceNorm, leaky_relu


def _to_tuple3(v):
    if isinstance(v, int):
        return (v, v, v)
    return tuple(v)


DEFAULT_ARCH = dict(
    n_stages=6,
    features_per_stage=(32, 64, 128, 256, 320, 320),
    kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_conv_per_stage=(2, 2, 2, 2, 2, 2),
    n_conv_per_stage_decoder=(2, 2, 2, 2, 2),
    conv_bias=True,
    norm_eps=1e-5,
    norm_affine=True,
    nonlin_slope=0.01,
)


class ConvNormAct(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides=(1, 1, 1),
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 norm_affine: bool = True, nonlin_slope: float = 0.01):
        super().__init__()
        k = _to_tuple3(kernel_size)
        self.conv = nn.Conv3d(in_channels, features, k,
                              stride=_to_tuple3(strides),
                              padding=tuple(kk // 2 for kk in k),
                              bias=conv_bias)
        self.norm = InstanceNorm(features, norm_eps, norm_affine)
        self.nonlin_slope = nonlin_slope

    def forward(self, x):
        return leaky_relu(self.norm(self.conv(x)), self.nonlin_slope)


class StackedConvs(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size,
                 n_convs: int, first_stride=(1, 1, 1), **kw):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvNormAct(in_channels if i == 0 else features, features,
                        kernel_size, first_stride if i == 0 else (1, 1, 1),
                        **kw)
            for i in range(n_convs))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return x


def _block_kw(a: dict) -> dict:
    return dict(conv_bias=a["conv_bias"], norm_eps=a["norm_eps"],
                norm_affine=a["norm_affine"], nonlin_slope=a["nonlin_slope"])


class PlainConvEncoder(nn.Module):
    def __init__(self, arch: dict, input_channels: int = 1):
        super().__init__()
        a = arch
        feats = a["features_per_stage"]
        self.stages = nn.ModuleList(
            StackedConvs(input_channels if s == 0 else feats[s - 1], feats[s],
                         a["kernel_sizes"][s], a["n_conv_per_stage"][s],
                         first_stride=a["strides"][s], **_block_kw(a))
            for s in range(a["n_stages"]))

    def forward(self, x):
        skips = []
        for stage in self.stages:
            x = stage(x)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    """Decoder exposing last-stage features (reference MyUnetDecoder,
    seg_model.py:14-58). Only the last stage's seg layer exists (no deep
    supervision on the serving path), under its stage index."""

    def __init__(self, arch: dict, num_classes: int):
        super().__init__()
        a = arch
        n = a["n_stages"]
        feats = a["features_per_stage"]
        self.n_stages = n
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        for s in range(n - 1):
            stride = _to_tuple3(a["strides"][n - 1 - s])
            in_ch, out_ch = feats[n - 1 - s], feats[n - 2 - s]
            self.transpconvs.append(nn.ConvTranspose3d(
                in_ch, out_ch, stride, stride=stride, bias=a["conv_bias"]))
            self.stages.append(StackedConvs(
                2 * out_ch, out_ch, a["kernel_sizes"][n - 2 - s],
                a["n_conv_per_stage_decoder"][s], **_block_kw(a)))
        self.seg_layers = nn.ModuleDict(
            {str(n - 2): nn.Conv3d(feats[0], num_classes, 1, bias=True)})

    def forward(self, skips):
        n = self.n_stages
        lres = skips[-1]
        for s in range(n - 1):
            x = self.transpconvs[s](lres)
            x = torch.cat([x, skips[n - 2 - s]], dim=1)
            lres = self.stages[s](x)
        return self.seg_layers[str(n - 2)](lres), lres


class SegModel(nn.Module):
    """Full LR-seg + HR-SR-seg model (reference seg_model.py:153-210).

    forward(x (B, D, H, W, input_channels)) -> (lr_logits, hr_logits[,
    skips]), channels-last, hr_logits upsampled x``upscale`` along D."""

    def __init__(self, num_classes: int = 2, upscale: int = 4,
                 input_channels: int = 1, arch: dict | None = None):
        super().__init__()
        self.arch = dict(DEFAULT_ARCH if arch is None else arch)
        self.num_classes = num_classes
        self.upscale = upscale
        self.input_channels = input_channels
        self.encoder = PlainConvEncoder(self.arch, input_channels)
        self.decoder = UNetDecoder(self.arch, num_classes)
        c0 = self.arch["features_per_stage"][0]
        self.sr_head = nn.Sequential(
            nn.Conv3d(c0, 16, 3, padding=1, bias=True), nn.ReLU(),
            nn.Conv3d(16, num_classes, 5, padding=2, bias=True))

    def forward(self, x, return_intermediate_feature: bool = False):
        def cl(t):
            return t.permute(0, 2, 3, 4, 1)

        skips = self.encoder(x.permute(0, 4, 1, 2, 3))
        out, features = self.decoder(skips)
        up = upsample_axis_linear(features, self.upscale, axis=2,
                                  align_corners=True)
        out_up = self.sr_head(up)
        if return_intermediate_feature:
            return cl(out), cl(out_up), [cl(s) for s in skips]
        return cl(out), cl(out_up)


def arch_from_plans(plans: dict, configuration: str = "3d_fullres") -> tuple[dict, list]:
    """Extract arch kwargs + patch size from an nnUNet plans.json dict
    (reference train_all.py:466-493). nnUNet patch sizes are (D, H, W)."""
    cfg = plans["configurations"][configuration]
    ak = cfg["architecture"]["arch_kwargs"]
    arch = dict(
        n_stages=ak["n_stages"],
        features_per_stage=tuple(ak["features_per_stage"]),
        kernel_sizes=tuple(tuple(k) for k in ak["kernel_sizes"]),
        strides=tuple(tuple(s) for s in ak["strides"]),
        n_conv_per_stage=tuple(ak["n_conv_per_stage"]) if not isinstance(
            ak["n_conv_per_stage"], int) else (ak["n_conv_per_stage"],) * ak["n_stages"],
        n_conv_per_stage_decoder=tuple(ak["n_conv_per_stage_decoder"]) if not isinstance(
            ak["n_conv_per_stage_decoder"], int)
        else (ak["n_conv_per_stage_decoder"],) * (ak["n_stages"] - 1),
        conv_bias=ak.get("conv_bias", True),
        norm_eps=(ak.get("norm_op_kwargs") or {}).get("eps", 1e-5),
        norm_affine=(ak.get("norm_op_kwargs") or {}).get("affine", True),
        nonlin_slope=(ak.get("nonlin_kwargs") or {}).get("negative_slope", 0.01),
    )
    patch_size = list(cfg["patch_size"])
    return arch, patch_size
