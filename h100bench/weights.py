"""Seeded weights for a model's state dict, made on the device in one draw.

Both sides of a comparison get the same tensors: the program loads them
into its own modules, the reference into its frozen copy. A conv or linear
weight is drawn with He's scale (std sqrt(2 / fan_in)), a norm's scale near
1, every bias and norm shift small, all from one standard normal draw of a
``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import math

import torch


def seeded_state(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for ``shapes`` ({name: torch.Size}, in order)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[i:i + n].view(shape)
        i += n
        if len(shape) >= 2:
            # ConvTranspose keeps its inputs on dim 0
            fan_in = (shape[0] if "transp" in name else shape[1]) \
                * math.prod(shape[2:])
            t.mul_(math.sqrt(2.0 / fan_in))
        elif name.endswith("norm.weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1 if "norm" in name else 0.01)
        out[name] = t
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    """{name: shape} of a module's state dict (a meta module will do)."""
    return {k: v.shape for k, v in module.state_dict().items()}
