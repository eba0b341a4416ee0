"""Mixed-precision training policy: bf16 compute, fp32 master weights
(``rehrseg_tpu.train.precision``).

The loss function casts the parameter tree and the batch to
``compute_dtype`` before the forward with a differentiable ``.to()`` (its
backward casts the bf16 gradients back to fp32, so the optimizer updates
fp32 master weights), and casts the outputs to ``reduce_dtype`` before any
loss reduction. Only floating leaves are cast: labels and index tensors
stay integral. ``torch.autocast`` is not used: it chooses per op which
ones run in fp32, where the JAX package casts explicitly once at the
boundary. bf16 needs no loss scaling (fp32's exponent range);
``policy("fp32")`` is the identity.

:func:`step_guard` wraps a train step's forward and backward: oneDNN's
bf16 convolution backward races between threads on the CPU (its gradients
vary from run to run and are at times NaN), so a bf16 step whose
parameters live on the CPU runs without oneDNN; anywhere else it does
nothing.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@dataclass(frozen=True)
class Policy:
    """compute_dtype: the dtype parameters and inputs are cast to for the
    forward; reduce_dtype: the dtype losses and reductions run in."""

    compute_dtype: torch.dtype
    reduce_dtype: torch.dtype = torch.float32

    @property
    def is_identity(self) -> bool:
        return self.compute_dtype == torch.float32

    def _cast(self, tree, dtype):
        if self.is_identity:
            return tree
        from ..parallel.spatial import HBlocks

        return _map(tree, lambda t: t.to(dtype)
                    if (isinstance(t, torch.Tensor) and t.is_floating_point())
                    or isinstance(t, HBlocks) else t)

    def cast_compute(self, tree):
        """Cast every floating leaf to compute_dtype."""
        return self._cast(tree, self.compute_dtype)

    def cast_reduce(self, tree):
        return self._cast(tree, self.reduce_dtype)


def step_guard(pol: "Policy", params):
    """The context a train step's forward and backward run in: oneDNN off
    for a bf16 policy over CPU parameters (``params``: a module or a dict
    of modules), else a no-op."""
    if pol.compute_dtype != torch.bfloat16:
        return contextlib.nullcontext()
    module = next(iter(params.values())) if isinstance(params, dict) \
        else params
    if next(module.parameters()).device.type != "cpu":
        return contextlib.nullcontext()
    return torch.backends.mkldnn.flags(enabled=False)


_POLICIES = {
    "fp32": Policy(compute_dtype=torch.float32),
    "f32": Policy(compute_dtype=torch.float32),
    "bf16": Policy(compute_dtype=torch.bfloat16),
    "bfloat16": Policy(compute_dtype=torch.bfloat16),
}


def policy(name: str | Policy | None) -> Policy:
    """Resolve a policy by name ('bf16' / 'fp32'); None -> fp32 identity."""
    if name is None:
        return _POLICIES["fp32"]
    if isinstance(name, Policy):
        return name
    try:
        return _POLICIES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; use 'bf16' or 'fp32'"
        ) from None
