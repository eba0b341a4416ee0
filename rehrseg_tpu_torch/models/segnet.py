"""SegModel: configurable plain-conv 3D UNet with an SR head
(``rehrseg_tpu.models.segnet`` as ``nn.Module``s), and the same UNet with
nnU-Net's residual encoder (``ResidualEncoderUNet`` of
dynamic_network_architectures, ``BasicBlockD`` blocks: the ResEnc presets
of arXiv:2404.09556), which the JAX package does not have.

The unpacked network is the oracle the packed forward
(:mod:`rehrseg_tpu_torch.models.segnet_packed`) is held against. Submodule
names follow the nnUNet / dynamic_network_architectures state-dict keys that
``rehrseg_tpu.train.torch_import.segmodel_mapping`` encodes
(``encoder.stages.{s}.convs.{i}.conv``, ``decoder.transpconvs.{s}``,
``decoder.seg_layers.{s}``, ``sr_head.0`` / ``sr_head.2``), so a reference
torch checkpoint and the flax bridge (:mod:`.convert`) land on the same keys.

An arch that carries ``n_blocks_per_stage`` (and no ``n_conv_per_stage``)
builds the residual encoder: a stem conv (``encoder.stem.convs.0``), then
per stage ``n_blocks_per_stage[s]`` blocks
(``encoder.stages.{s}.blocks.{b}.conv1`` / ``.conv2``), the first taking
the stage's stride and channel change; its skip is
``AvgPool3d(stride, stride)`` where it strides, then a bias-free 1x1x1
conv + instance norm (``.skip.1``, or ``.skip.0`` with no pool: the
library's ``nn.Sequential`` index) where its channels change. The
decoder and SR head are the plain model's.

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


def is_residual(arch: dict) -> bool:
    """Does ``arch`` build the residual encoder? An arch names one kind of
    encoder: ``n_conv_per_stage`` (plain) or ``n_blocks_per_stage``
    (residual)."""
    res = "n_blocks_per_stage" in arch
    if res == ("n_conv_per_stage" in arch):
        raise ValueError(
            "an arch carries exactly one of n_conv_per_stage (the plain "
            "encoder) and n_blocks_per_stage (the residual encoder)")
    return res


def residual_blocks(arch: dict):
    """(stage, block, pooled, projected) of each BasicBlockD of a residual
    arch, in forward order: only a stage's first block strides or changes
    channels, so only it may pool or project its skip."""
    feats = arch["features_per_stage"]
    for s in range(arch["n_stages"]):
        cin = feats[max(s - 1, 0)]
        first = (_to_tuple3(arch["strides"][s]) != (1, 1, 1),
                 cin != feats[s])
        for b in range(arch["n_blocks_per_stage"][s]):
            yield (s, b) + (first if b == 0 else (False, False))


class ConvNormAct(nn.Module):
    """Conv, instance norm and leaky ReLU; ``nonlin_slope=None`` leaves the
    nonlinearity out (a BasicBlockD's conv2 and skip projection)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides=(1, 1, 1),
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 norm_affine: bool = True, nonlin_slope: float | None = 0.01):
        super().__init__()
        k = _to_tuple3(kernel_size)
        self.conv = nn.Conv3d(in_channels, features, k,
                              stride=_to_tuple3(strides),
                              padding=tuple(kk // 2 for kk in k),
                              bias=conv_bias)
        self.norm = InstanceNorm(features, norm_eps, norm_affine)
        self.nonlin_slope = nonlin_slope

    def forward(self, x):
        y = self.norm(self.conv(x))
        if self.nonlin_slope is None:
            return y
        return leaky_relu(y, self.nonlin_slope)


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


class BasicBlockD(nn.Module):
    """``lrelu(IN(conv2(lrelu(IN(conv1_stride(x))))) + skip(x))``, skip the
    identity, or AvgPool3d(stride) where the block strides, then a
    bias-free 1x1x1 conv + IN where its channels change."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride, **kw):
        super().__init__()
        stride = _to_tuple3(stride)
        self.nonlin_slope = kw["nonlin_slope"]
        lin = dict(kw, nonlin_slope=None)
        self.conv1 = ConvNormAct(in_channels, features, kernel_size, stride,
                                 **kw)
        self.conv2 = ConvNormAct(features, features, kernel_size, **lin)
        ops = []
        if stride != (1, 1, 1):
            ops.append(nn.AvgPool3d(stride, stride))
        if in_channels != features:
            ops.append(ConvNormAct(in_channels, features, 1,
                                   **dict(lin, conv_bias=False)))
        self.skip = nn.Sequential(*ops) if ops else None

    def forward(self, x):
        r = x if self.skip is None else self.skip(x)
        return leaky_relu(self.conv2(self.conv1(x)) + r, self.nonlin_slope)


class StackedResidualBlocks(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size,
                 n_blocks: int, first_stride, **kw):
        super().__init__()
        self.blocks = nn.ModuleList(
            BasicBlockD(in_channels if b == 0 else features, features,
                        kernel_size, first_stride if b == 0 else (1, 1, 1),
                        **kw)
            for b in range(n_blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ResidualEncoder(nn.Module):
    """nnU-Net's ResidualEncoder: a one-conv stem to features[0] at kernel
    ``kernel_sizes[0]``, stride 1, then the stages of BasicBlockD."""

    def __init__(self, arch: dict, input_channels: int = 1):
        super().__init__()
        a = arch
        feats = a["features_per_stage"]
        self.stem = StackedConvs(input_channels, feats[0],
                                 a["kernel_sizes"][0], 1, **_block_kw(a))
        self.stages = nn.ModuleList(
            StackedResidualBlocks(feats[0] if s == 0 else feats[s - 1],
                                  feats[s], a["kernel_sizes"][s],
                                  a["n_blocks_per_stage"][s],
                                  first_stride=a["strides"][s],
                                  **_block_kw(a))
            for s in range(a["n_stages"]))

    def forward(self, x):
        x = self.stem(x)
        skips = []
        for stage in self.stages:
            x = stage(x)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    """Decoder exposing last-stage features (reference MyUnetDecoder,
    seg_model.py:14-58). Without deep supervision only the last stage's
    seg layer exists, under its stage index; with it, every stage has one
    (``seg_layers.{s}``) and forward returns their logits highest
    resolution first."""

    def __init__(self, arch: dict, num_classes: int,
                 deep_supervision: bool = False):
        super().__init__()
        a = arch
        n = a["n_stages"]
        feats = a["features_per_stage"]
        self.n_stages = n
        self.deep_supervision = deep_supervision
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
        heads = range(n - 1) if deep_supervision else (n - 2,)
        self.seg_layers = nn.ModuleDict(
            {str(s): nn.Conv3d(feats[n - 2 - s], num_classes, 1, bias=True)
             for s in heads})

    def forward(self, skips):
        n = self.n_stages
        lres = skips[-1]
        seg_outputs = []
        for s in range(n - 1):
            x = self.transpconvs[s](lres)
            x = torch.cat([x, skips[n - 2 - s]], dim=1)
            lres = self.stages[s](x)
            if str(s) in self.seg_layers:
                seg_outputs.append(self.seg_layers[str(s)](lres))
        seg_outputs = seg_outputs[::-1]
        return (seg_outputs if self.deep_supervision else seg_outputs[0],
                lres)


class SegModel(nn.Module):
    """Full LR-seg + HR-SR-seg model (reference seg_model.py:153-210).

    forward(x (B, D, H, W, input_channels)) -> (lr_logits, hr_logits[,
    skips]), channels-last, hr_logits upsampled x``upscale`` along D. With
    ``deep_supervision`` lr_logits is the list of every decoder stage's
    logits, highest resolution first."""

    def __init__(self, num_classes: int = 2, upscale: int = 4,
                 input_channels: int = 1, arch: dict | None = None,
                 deep_supervision: bool = False):
        super().__init__()
        self.arch = dict(DEFAULT_ARCH if arch is None else arch)
        self.num_classes = num_classes
        self.upscale = upscale
        self.input_channels = input_channels
        self.deep_supervision = deep_supervision
        encoder = (ResidualEncoder if is_residual(self.arch)
                   else PlainConvEncoder)
        self.encoder = encoder(self.arch, input_channels)
        self.decoder = UNetDecoder(self.arch, num_classes, deep_supervision)
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
        out = [cl(o) for o in out] if self.deep_supervision else cl(out)
        if return_intermediate_feature:
            return out, cl(out_up), [cl(s) for s in skips]
        return out, cl(out_up)


_PLAIN_NET = "PlainConvUNet"
_RESIDUAL_NET = "ResidualEncoderUNet"


def _per_stage(v, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def arch_from_plans(plans: dict, configuration: str = "3d_fullres") -> tuple[dict, list]:
    """Extract arch kwargs + patch size from an nnUNet plans.json dict
    (reference train_all.py:466-493). nnUNet patch sizes are (D, H, W).

    ``network_class_name`` picks the encoder: a name ending in
    ``PlainConvUNet`` (or none, as older plans have) the plain one, in
    ``ResidualEncoderUNet`` the residual one (``n_blocks_per_stage``, the
    ResEnc presets); any other class raises rather than be misread."""
    cfg = plans["configurations"][configuration]
    net = cfg["architecture"].get("network_class_name", _PLAIN_NET)
    ak = cfg["architecture"]["arch_kwargs"]
    n = ak["n_stages"]
    if net.endswith(_RESIDUAL_NET):
        block = ak.get("block", "BasicBlockD")
        if not str(block).endswith("BasicBlockD") or ak.get(
                "bottleneck_channels") or ak.get("stochastic_depth_p") or \
                ak.get("squeeze_excitation"):
            raise ValueError(
                f"{net}: only BasicBlockD blocks without bottleneck, "
                f"stochastic depth or squeeze-excitation are implemented")
        enc = dict(n_blocks_per_stage=_per_stage(ak["n_blocks_per_stage"],
                                                 n))
    elif net.endswith(_PLAIN_NET):
        enc = dict(n_conv_per_stage=_per_stage(ak["n_conv_per_stage"], n))
    else:
        raise ValueError(
            f"network_class_name {net!r}: the port builds "
            f"{_PLAIN_NET} and {_RESIDUAL_NET} only")
    arch = dict(
        n_stages=n,
        features_per_stage=tuple(ak["features_per_stage"]),
        kernel_sizes=tuple(tuple(k) for k in ak["kernel_sizes"]),
        strides=tuple(tuple(s) for s in ak["strides"]),
        **enc,
        n_conv_per_stage_decoder=_per_stage(ak["n_conv_per_stage_decoder"],
                                            n - 1),
        conv_bias=ak.get("conv_bias", True),
        norm_eps=(ak.get("norm_op_kwargs") or {}).get("eps", 1e-5),
        norm_affine=(ak.get("norm_op_kwargs") or {}).get("affine", True),
        nonlin_slope=(ak.get("nonlin_kwargs") or {}).get("negative_slope", 0.01),
    )
    patch_size = list(cfg["patch_size"])
    return arch, patch_size
