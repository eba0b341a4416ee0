"""WDSR wide-activation super-resolution network in PyTorch
(``rehrseg_tpu.models.wdsr``; reference models/wdsr.py:58-95).

Weight-normalized convs, ``n_resblocks`` residual blocks (1x1 expand x4 ->
ReLU -> 1x1 linear x0.8 -> 3x3), a head of one conv + pixel shuffle along
the through-plane axis plus a 5x5 skip upsampler, and rational scales split
into an integer pixel-shuffle part and a fractional B-spline pre-resize
(a matmul with a host-built matrix, wdsr.py:61-62, 87).

Input and output are channels-last like the JAX package's: (B, X, Y, C), C
= out_channel, X the through-plane (upsampled) axis. Module names are the
reference's state-dict keys (``head``, ``body.{i}.body.{0,2,3}``,
``tail.conv0``, ``skip.conv0``, each with ``weight_v``, ``weight_g``,
``bias``).
"""

from __future__ import annotations

from torch import nn

from ..ops.bspline import resize_1d
from ..ops.pixel_shuffle import pixel_shuffle_axis
from .layers import WNConv


class Upsample(nn.Module):
    """Conv to scale*out_channel, then the 1-D pixel shuffle along X
    (wdsr.py:23-34); channel c_out*scale + phase lands at x*scale + phase."""

    def __init__(self, in_features: int, out_channel: int, scale: int,
                 kernel_size: int):
        super().__init__()
        self.scale = scale
        self.conv0 = WNConv(in_features, scale * out_channel, kernel_size)

    def forward(self, x):
        """x (B, C, X, Y) -> (B, X*scale, Y, out_channel) channels-last."""
        return pixel_shuffle_axis(self.conv0(x).permute(0, 2, 3, 1),
                                  self.scale)


class Block(nn.Module):
    """Wide-activation residual block (wdsr.py:37-55)."""

    def __init__(self, n_feats: int, res_scale: float = 1.0,
                 expand: int = 4, linear: float = 0.8):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(
            WNConv(n_feats, n_feats * expand, 1), nn.ReLU(),
            WNConv(n_feats * expand, int(n_feats * linear), 1),
            WNConv(int(n_feats * linear), n_feats, 3))

    def forward(self, x):
        return x + self.body(x) * self.res_scale


class WDSR(nn.Module):
    def __init__(self, out_channel: int = 2, n_resblocks: int = 16,
                 num_channels: int = 32, scale: float = 4.0):
        super().__init__()
        self.out_channel = out_channel
        self.scale = float(scale)
        self.head = WNConv(out_channel, num_channels, 3)
        self.body = nn.Sequential(*(Block(num_channels)
                                    for _ in range(n_resblocks)))
        self.tail = Upsample(num_channels, out_channel, self.scale1, 3)
        self.skip = Upsample(out_channel, out_channel, self.scale1, 5)

    @property
    def scale1(self) -> int:
        return int(self.scale)

    @property
    def scale0(self) -> float:
        return self.scale / float(self.scale1)

    def forward(self, x):
        """x (B, X, Y, C) -> (B, X', Y, C), X' = round(X * scale0) *
        scale1."""
        if self.scale0 != 1.0:
            # fractional pre-resize along the through-plane axis (wdsr.py:87)
            x = resize_1d(x, 1.0 / self.scale0, axis=1, order=3)
        x = x.permute(0, 3, 1, 2)
        s = self.skip(x)
        h = self.tail(self.body(self.head(x)))
        return h + s

    def calc_out_patch_size(self, input_patch_size):
        """Static output patch math: X scales by round(X * scale0) *
        scale1, Y is unchanged."""
        nx, ny = input_patch_size
        if self.scale0 != 1.0:
            nx = int(round(nx * self.scale0))
        return [nx * self.scale1, ny]
