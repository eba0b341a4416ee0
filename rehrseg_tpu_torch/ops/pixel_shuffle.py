"""Pixel shuffle along one spatial axis, channels-last: the port's own copy
of ``rehrseg_tpu.ops.pixel_shuffle`` (the reference WDSR's through-plane
upsampler, models/wdsr.py:13-20)."""

from __future__ import annotations

import torch


def pixel_shuffle_axis(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, X, Y, C*scale) -> (B, X*scale, Y, C).

    Channel index c_in = c_out * scale + phase:
    ``out[b, x*scale + phase, y, c_out] = x[b, x, y, c_out*scale + phase]``.
    """
    b, nx, ny, cs = x.shape
    c = cs // scale
    out = x.reshape(b, nx, ny, c, scale).permute(0, 1, 4, 2, 3)
    return out.reshape(b, nx * scale, ny, c)
