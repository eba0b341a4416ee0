"""The lower-precision controls: the reference's convolutions with their
operands rounded to a narrower type, accumulated in fp32.

For a configuration that states bf16, the next precision below is fp8:
each convolution's input and weight are scaled per tensor so that their
largest magnitude lands on e4m3's largest finite value (448), rounded to
``float8_e4m3fn`` and scaled back, the usual per-tensor fp8 recipe.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 under a per-tensor scale; its gradient
    passes straight through, as an fp8 training recipe's does."""
    x = t.detach()
    scale = E4M3_MAX / x.abs().amax().float().clamp(min=1e-12)
    q = ((x.float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(t.dtype)
    return t + (q - x)


def fp8_conv_hook(x, w):
    return fp8_e4m3(x), fp8_e4m3(w)

