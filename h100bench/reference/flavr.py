"""A frozen plain-PyTorch copy of FLAVR's UNet_3D_3D with the plain head
(Kalluri et al., arXiv:2012.08512; tarun005/FLAVR ``FLAVR_arch.py``
UNet_3D_3D over ``resnet_3D.py`` unet_18, no batchnorm), as REHRSeg's
stage 1b trains it. It imports nothing of the program; module names follow
the reference's state-dict keys (``encoder.stem.0``,
``encoder.layer1.0.conv1.0``, ``encoder.layer1.0.fg.attn_layer.0``,
``decoder.1.upconv.0``, ``feature_fuse.conv.0``, ``outconv.1``), which
the program's UNet3D uses too.

Input (B, D, H, W, C) channels-last; output (B, n_outputs, H, W, C).
``conv_hook`` and ``conv_observer`` as in :mod:`.segnet`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

WIDTHS = (64, 128, 256, 512)
STRIDES = ((1, 1, 1), (1, 2, 2), (1, 2, 2), (1, 1, 1))


class SEGating(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attn_layer = nn.Sequential(nn.Conv3d(c, c, 1), nn.Sigmoid())


class BasicBlock(nn.Module):
    def __init__(self, cin, c, stride, bias):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv3d(cin, c, 3, stride, 1, bias=bias),
                                   nn.ReLU())
        self.conv2 = nn.Sequential(nn.Conv3d(c, c, 3, 1, 1, bias=bias))
        self.fg = SEGating(c)
        self.downsample = (nn.Sequential(nn.Conv3d(cin, c, 1, stride,
                                                   bias=False))
                           if tuple(stride) != (1, 1, 1) or cin != c
                           else None)


class Encoder(nn.Module):
    def __init__(self, cin, widths, bias):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv3d(cin, widths[0], (3, 7, 7),
                                            (1, 2, 2), (1, 3, 3), bias=bias),
                                  nn.ReLU())
        c_in = widths[0]
        for i, (c, st) in enumerate(zip(widths, STRIDES)):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock(c_in, c, st, bias),
                BasicBlock(c, c, (1, 1, 1), bias)))
            c_in = c


class Gated(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv3d(cin, c, 3, 1, 1), SEGating(c))


class Up(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.upconv = nn.Sequential(
            nn.ConvTranspose3d(cin, c, (3, 4, 4), (1, 2, 2), (1, 1, 1)),
            SEGating(c))


class Conv2d(nn.Module):
    def __init__(self, cin, c, k):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, c, k, padding=k // 2))


class UNet3D(nn.Module):
    def __init__(self, img_channels: int = 2, n_inputs: int = 4,
                 n_outputs: int = 4, widths=WIDTHS):
        super().__init__()
        self.ic, self.n_in, self.n_out = img_channels, n_inputs, n_outputs
        self.encoder = Encoder(img_channels, widths, bias=n_outputs > 1)
        NF = tuple(reversed(widths))        # the decoder's widths
        self.decoder = nn.Sequential(Gated(NF[0], NF[1]), Up(NF[0], NF[2]),
                                     Up(NF[1], NF[3]), Gated(NF[2], NF[3]),
                                     Up(NF[2], NF[3]))
        self.feature_fuse = Conv2d(NF[3] * n_inputs, NF[3], 3)
        self.outconv = nn.Sequential(nn.ReflectionPad2d(3),
                                     nn.Conv2d(NF[3], n_outputs * img_channels,
                                               7))
        self.conv_hook = None
        self.conv_observer = None

    @classmethod
    def from_config(cls, cfg: dict) -> "UNet3D":
        return cls(cfg["img_channels"], cfg["n_inputs"], cfg["n_outputs"],
                   tuple(cfg["encoder_widths"]))

    def _conv(self, m, x):
        w = m.weight
        if self.conv_hook is not None:
            x, w = self.conv_hook(x, w)
        if isinstance(m, nn.ConvTranspose3d):
            y = F.conv_transpose3d(x, w, m.bias, m.stride, m.padding)
        elif isinstance(m, nn.Conv2d):
            y = F.conv2d(x, w, m.bias, m.stride, m.padding)
        else:
            y = F.conv3d(x, w, m.bias, m.stride, m.padding)
        if self.conv_observer is not None:
            self.conv_observer(m, x, y)
        return y

    def _gate(self, g, x):
        return x * torch.sigmoid(self._conv(g.attn_layer[0],
                                            x.mean((2, 3, 4), keepdim=True)))

    def _block(self, b, x):
        out = F.relu(self._conv(b.conv1[0], x))
        out = self._gate(b.fg, self._conv(b.conv2[0], out))
        res = x if b.downsample is None else self._conv(b.downsample[0], x)
        return F.relu(out + res)

    def forward(self, images):
        mean_ = images[..., 0:1].mean((1, 2, 3), keepdim=True)
        x = torch.cat([images[..., 0:1] - mean_, images[..., 1:]], -1)
        x = x.permute(0, 4, 1, 2, 3)
        e = self.encoder
        feats = [F.relu(self._conv(e.stem[0], x))]
        for i in range(1, 5):
            y = feats[-1]
            for b in getattr(e, f"layer{i}"):
                y = self._block(b, y)
            feats.append(y)
        x0, x1, x2, x3, x4 = feats
        d = self.decoder

        def gated(m, t):
            return self._gate(m.conv[1], self._conv(m.conv[0], t))

        def up(m, t):
            return self._gate(m.upconv[1], self._conv(m.upconv[0], t))

        dx = torch.cat([F.leaky_relu(gated(d[0], x4), 0.2), x3], 1)
        dx = torch.cat([F.leaky_relu(up(d[1], dx), 0.2), x2], 1)
        dx = torch.cat([F.leaky_relu(up(d[2], dx), 0.2), x1], 1)
        dx = torch.cat([F.leaky_relu(gated(d[3], dx), 0.2), x0], 1)
        dx = F.leaky_relu(up(d[4], dx), 0.2)
        folded = torch.cat(torch.unbind(dx, 2), 1)
        fused = F.leaky_relu(self._conv(self.feature_fuse.conv[0], folded),
                             0.2)
        out = self._conv(self.outconv[1], F.pad(fused, (3, 3, 3, 3),
                                                mode="reflect"))
        b, _, h, w = out.shape
        out = out.reshape(b, self.n_out, self.ic, h, w).permute(0, 1, 3, 4, 2)
        img = torch.tanh(out[..., 0:1] + mean_)
        return torch.cat([img, out[..., 1:]], -1)
