"""Fourier burst accumulation (``rehrseg_tpu.ops.fba`` in PyTorch;
reference utils/fba.py:4-21).

Fuses several SR reconstructions in the Fourier domain: with p 'infinity'
the per-frequency maximum, else a magnitude-power-weighted average.
:func:`fba` is the host (numpy) form, :func:`fba_torch` the tensor form
(``fba_jax`` there).
"""

from __future__ import annotations

import numpy as np
import torch


def fba(imgs, p="infinity"):
    vs_hat = [np.fft.rfftn(img) for img in imgs]
    if p in ("infinity", "inf"):
        out = np.max(vs_hat, axis=0)
    else:
        p = float(p)
        denominator = np.sum([np.abs(v) ** p for v in vs_hat], axis=0)
        ws = [np.abs(v) ** p / denominator for v in vs_hat]
        out = np.sum([w * v for w, v in zip(ws, vs_hat)], axis=0)
    return np.fft.irfftn(out).astype(np.float32)


def _complex_max(v: torch.Tensor) -> torch.Tensor:
    """The maximum over dim 0 of a complex tensor in lexicographic order
    (real part, then imaginary part), as numpy and XLA order complex
    numbers; the first of equal entries wins."""
    best = v[0]
    for cand in v[1:]:
        take = (cand.real > best.real) | ((cand.real == best.real)
                                          & (cand.imag > best.imag))
        best = torch.where(take, cand, best)
    return best


def fba_torch(imgs: torch.Tensor, p: float | None = None) -> torch.Tensor:
    """imgs: a (K, ...) stack. p None is the 'infinity' max rule."""
    vs_hat = torch.fft.rfftn(imgs, dim=tuple(range(1, imgs.ndim)))
    if p is None:
        out = _complex_max(vs_hat)
    else:
        mags = vs_hat.abs() ** p
        ws = mags / mags.sum(0, keepdim=True)
        out = (ws * vs_hat).sum(0)
    return torch.fft.irfftn(out, dim=tuple(range(out.ndim))).to(
        torch.float32)
