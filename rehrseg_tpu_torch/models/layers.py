"""Building blocks of the port's models (``rehrseg_tpu.models.layers``).

Modules here work channels-first (N, C, *spatial), PyTorch's habit; each
model converts from and to the JAX package's channels-last layout at its
public boundary. Parameter names follow the reference PyTorch modules
(``weight_v``/``weight_g`` of ``weight_norm``, ``attn_layer.0`` of FLAVR's
SEGating), so reference state dicts load by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class InstanceNorm(nn.Module):
    """InstanceNorm over all spatial dims, per sample and channel, with the
    biased variance (``jnp.var``; ``torch.var`` needs ``correction=0``).
    Parameter names follow torch's InstanceNorm3d (``weight``/``bias``),
    which are flax's ``scale``/``bias``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(2, x.ndim))
        mean = x.mean(dims, keepdim=True)
        var = x.var(dims, correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            shape = (1, -1) + (1,) * (x.ndim - 2)
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d of an (N, C, H, W) tensor (reference
    FLAVR_arch.py:154)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class WNConv(nn.Module):
    """Weight-normalized 2D convolution with SAME padding (odd kernels),
    the reference WDSR's ``weight_norm(nn.Conv2d)`` (models/wdsr.py:65).

    kernel = g * v / ||v||, the norm per output channel over (I, kh, kw)
    taken in fp32 with 1e-12 under the square root and cast back to v's
    dtype, as the JAX package does (``torch.nn.utils.weight_norm`` has no
    epsilon). g starts at ||v||, so the first kernel equals v."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 bias: bool = True):
        super().__init__()
        self.padding = kernel_size // 2
        v = torch.empty(features, in_features, kernel_size, kernel_size)
        nn.init.kaiming_uniform_(v, a=math.sqrt(5))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            v.pow(2).sum((1, 2, 3), keepdim=True).sqrt())
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        norm = (v.float().pow(2).sum((1, 2, 3), keepdim=True)
                + 1e-12).sqrt().to(v.dtype)
        return F.conv2d(x, self.weight_g * v / norm, self.bias,
                        padding=self.padding)


class SEGating(nn.Module):
    """Squeeze-excite gating of a 3D feature map (reference
    models/FLAVR/resnet_3D.py:100-116): global average pool, 1x1x1 conv,
    sigmoid, multiply."""

    def __init__(self, channels: int):
        super().__init__()
        self.attn_layer = nn.Sequential(nn.Conv3d(channels, channels, 1),
                                        nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attn_layer(x.mean((2, 3, 4), keepdim=True))


def conv_transpose_torch(in_features: int, features: int, kernel_size,
                         strides, padding,
                         use_bias: bool = True) -> nn.ConvTranspose3d:
    """The transposed conv of ``rehrseg_tpu.models.layers
    .conv_transpose_torch``: flax ``ConvTranspose(transpose_kernel=True)``
    with padding ``k - 1 - p`` per dim is torch's ``ConvTranspose3d`` with
    padding ``p``; its kernel (*K, O, I) is this one's (I, O, *K)."""
    return nn.ConvTranspose3d(in_features, features, tuple(kernel_size),
                              stride=tuple(strides), padding=tuple(padding),
                              bias=use_bias)
