"""FLAVR UNet_3D_3D in PyTorch (``rehrseg_tpu.models.flavr``): the 3D
encoder-decoder that interpolates through-plane slices, with the plain
head or the uncertainty-aware SR (UASR) head.

Reference models/FLAVR/FLAVR_arch.py:117-247 and resnet_3D.py:100-261: a
video-ResNet-18 encoder (stem 3x7x7 stride (1, 2, 2); four layers of two
BasicBlocks at widths 64/128/256/512, spatial stride 2 at layers 2-3,
SEGating on every block), a transposed-conv decoder with skip concats, a
temporal fold of the slices into channels, then either the plain 2D head
(feature_fuse + reflection-padded 7x7 outconv; tanh and the batch mean
restored on the image channel) or the UASR head (softmax attention over 16
hypotheses per output slice and a sigmoid uncertainty map). No batchnorm,
as shipped.

The public boundary is the JAX package's channels-last layout: input (B, D,
H, W, img_channels), outputs (B, n_outputs, H, W, C); inside, the modules
work channels-first. Module names are the reference's state-dict keys
(``encoder.stem.0``, ``encoder.layer1.0.conv1.0``,
``encoder.layer1.0.fg.attn_layer.0``, ``decoder.1.upconv.0``,
``feature_fuse.conv.0``, ``outconv.1``, ...), so a reference checkpoint
loads with ``load_state_dict``; flax params come in through
``models.convert.load_flax_flavr_params``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SEGating, conv_transpose_torch, leaky_relu

NF = (512, 256, 128, 64)


class BasicBlock3D(nn.Module):
    """resnet_3D.py:118-151 BasicBlock with SEGating, no batchnorm; the 1x1x1
    downsample (no bias) where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride=(1, 1, 1),
                 use_bias: bool = True):
        super().__init__()
        stride = tuple(stride)
        self.conv1 = nn.Sequential(
            nn.Conv3d(inplanes, planes, 3, stride, 1, bias=use_bias),
            nn.ReLU())
        self.conv2 = nn.Sequential(
            nn.Conv3d(planes, planes, 3, 1, 1, bias=use_bias))
        self.fg = SEGating(planes)
        self.downsample = None
        if stride != (1, 1, 1) or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv3d(inplanes, planes, 1, stride, bias=False))

    def forward(self, x):
        out = self.fg(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Encoder3D(nn.Module):
    """The unet_18 video-ResNet encoder returning its 5 feature maps
    (resnet_3D.py:183-189)."""

    def __init__(self, in_channels: int, use_bias: bool = True,
                 layers=(2, 2, 2, 2)):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv3d(in_channels, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                      bias=use_bias),
            nn.ReLU())
        inplanes = 64
        for i, (planes, stride) in enumerate(
                ((64, (1, 1, 1)), (128, (1, 2, 2)), (256, (1, 2, 2)),
                 (512, (1, 1, 1)))):
            blocks = [BasicBlock3D(inplanes, planes, stride, use_bias)]
            blocks += [BasicBlock3D(planes, planes, (1, 1, 1), use_bias)
                       for _ in range(1, layers[i])]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = planes

    def forward(self, x):
        x0 = self.stem(x)
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        return x0, x1, x2, x3, x4


class Conv3dGated(nn.Module):
    """Conv_3d: 3x3x3 conv + SEGating (FLAVR_arch.py:72-88)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv3d(in_features, features, 3, 1, 1),
                                  SEGating(features))

    def forward(self, x):
        return self.conv(x)


class UpConv3D(nn.Module):
    """upConv3D, transpose mode: ConvTranspose3d k(3,4,4) s(1,2,2) p(1,1,1)
    + SEGating (FLAVR_arch.py:40-70)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.upconv = nn.Sequential(
            conv_transpose_torch(in_features, features, (3, 4, 4),
                                 (1, 2, 2), (1, 1, 1)),
            SEGating(features))

    def forward(self, x):
        return self.upconv(x)


class Conv2dBlock(nn.Module):
    """Conv_2d of FLAVR_arch.py (no batchnorm): a 2D conv with SAME
    padding, kept in a ``conv`` Sequential for the reference key names."""

    def __init__(self, in_features: int, features: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(in_features, features,
                                            kernel_size,
                                            padding=kernel_size // 2))

    def forward(self, x):
        return self.conv(x)


class UNet3D(nn.Module):
    """UNet_3D_3D (FLAVR_arch.py:117-247). Input (B, D, H, W, img_channels)
    channels-last, D = n_inputs, H and W multiples of 16. Returns (B,
    n_outputs, H, W, img_channels); with ``use_uncertainty`` a tuple (out
    (B, n_outputs, H, W, 2), uncertainty (B, n_outputs, H, W, 1))."""

    def __init__(self, img_channels: int = 2, n_inputs: int = 4,
                 n_outputs: int = 4, use_uncertainty: bool = False):
        super().__init__()
        self.img_channels = img_channels
        self.n_inputs = n_inputs
        self.n_outputs = n_outputs
        self.use_uncertainty = use_uncertainty
        # the encoder's convs carry a bias only for n_outputs > 1
        self.encoder = Encoder3D(img_channels, use_bias=n_outputs > 1)
        self.decoder = nn.Sequential(
            Conv3dGated(NF[0], NF[1]),
            UpConv3D(NF[0], NF[2]),
            UpConv3D(NF[1], NF[3]),
            Conv3dGated(NF[2], NF[3]),
            UpConv3D(NF[2], NF[3]))
        fold = NF[3] * n_inputs
        fuse_out = fold if use_uncertainty else NF[3]
        self.feature_fuse = Conv2dBlock(fold, fuse_out, 3)
        if use_uncertainty:
            self.n_hyp = (NF[3] * img_channels) // n_outputs // img_channels
            self.feature_fuse1 = Conv2dBlock(fuse_out, NF[3] * img_channels,
                                             1)
            self.uncertainty_early = Conv2dBlock(fuse_out, NF[3], 1)
            self.uncertainty_out = nn.Conv3d(self.n_hyp, 1, 1)
        else:
            self.outconv = nn.Sequential(
                nn.ReflectionPad2d(3),
                nn.Conv2d(NF[3], n_outputs * img_channels, 7))

    def _center(self, images):
        """Subtract the mean of channel 0 (per batch element); returns the
        centered input channels-first and the mean (B, 1, 1, 1, 1)."""
        mean_ = images[..., 0:1].mean((1, 2, 3), keepdim=True)
        centered = torch.cat([images[..., 0:1] - mean_, images[..., 1:]], -1)
        return centered.permute(0, 4, 1, 2, 3), mean_

    def encode(self, images):
        """The stage-2 distillation teacher's interface: the mean-centered
        encoder features (FLAVR_arch.py:180-186), channels-last."""
        feats = self.encoder(self._center(images)[0])
        return tuple(f.permute(0, 2, 3, 4, 1) for f in feats)

    def forward(self, images, return_intermediate_feature: bool = False):
        if return_intermediate_feature:
            return self.encode(images)
        x, mean_ = self._center(images)
        x0, x1, x2, x3, x4 = self.encoder(x)
        dec = self.decoder
        dx = torch.cat([leaky_relu(dec[0](x4), 0.2), x3], 1)
        dx = torch.cat([leaky_relu(dec[1](dx), 0.2), x2], 1)
        dx = torch.cat([leaky_relu(dec[2](dx), 0.2), x1], 1)
        dx = torch.cat([leaky_relu(dec[3](dx), 0.2), x0], 1)
        dx_out = leaky_relu(dec[4](dx), 0.2)
        # temporal fold (B, C, D, H, W) -> (B, D*C, H, W), slice-major as
        # the reference's cat(unbind(dim=2), dim=1) (FLAVR_arch.py:201)
        folded = torch.cat(torch.unbind(dx_out, 2), 1)
        if self.use_uncertainty:
            return self._uasr_head(folded)
        return self._plain_head(folded, mean_)

    def _plain_head(self, folded, mean_):
        out = self.outconv(leaky_relu(self.feature_fuse(folded), 0.2))
        b, _, h, w = out.shape
        ic = self.img_channels
        # n_outputs chunks of img_channels, slice-major
        out = out.reshape(b, self.n_outputs, ic, h, w).permute(0, 1, 3, 4, 2)
        if ic > 1:
            img = torch.tanh(out[..., 0:1] + mean_)
            return torch.cat([img, out[..., 1:]], -1)
        return out + mean_

    def _uasr_head(self, folded):
        """Uncertainty-aware head (FLAVR_arch.py:203-227, 244-246): per
        output slice, 16 (image, seg) hypotheses softmax-attended, channel
        2i the image and 2i+1 the seg of hypothesis i."""
        fused = leaky_relu(self.feature_fuse(folded), 0.2)
        out_multi = self.feature_fuse1(fused)      # (B, 64*ic, H, W)
        unc_early = self.uncertainty_early(fused)  # (B, 64, H, W)
        b, _, h, w = out_multi.shape
        n_out, n_hyp, ic = self.n_outputs, self.n_hyp, self.img_channels
        pairs = out_multi.reshape(b, n_out, n_hyp, ic, h, w)
        unc_softmax = unc_early.reshape(b, n_out, n_hyp, h, w).softmax(2)
        img = (torch.tanh(pairs[:, :, :, 0]) + 1.0) / 2.0
        out_img = (img * unc_softmax).sum(2)
        out_seg = (pairs[:, :, :, 1] * unc_softmax).sum(2)
        out = torch.stack([out_img, out_seg], -1)  # (B, n_out, H, W, 2)
        # a 1x1x1 3D conv with n_out as depth and the hypotheses as channels
        unc = torch.sigmoid(self.uncertainty_out(unc_softmax.transpose(1, 2)))
        return out, unc.permute(0, 2, 3, 4, 1)

    def calc_out_patch_size(self, input_patch_size):
        """Static output patch math: spatial dims are preserved, the slice
        dim becomes n_outputs * n_inputs."""
        d, h, w = input_patch_size
        return [self.n_outputs * self.n_inputs, h, w]
