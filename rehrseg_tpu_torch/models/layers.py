"""Building blocks of the port's SegModel (``rehrseg_tpu.models.layers``).

Modules here work channels-first (N, C, *spatial), PyTorch's habit; the
SegModel converts from and to the JAX package's channels-last layout at its
public boundary.
"""

from __future__ import annotations

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
