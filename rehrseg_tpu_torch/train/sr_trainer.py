"""Stage-1 SR training step for WDSR and FLAVR, with or without the UASR
uncertainty head (``rehrseg_tpu.train.sr_trainer``; the reference's
``train_sr`` inner loop, train_all.py:114-152):

  - the HR target is cropped to the centre slice gap when num_slices > 1
    (train_all.py:122-123);
  - loss = L1(image) [+ the heteroscedastic uncertainty terms] +
    BCEDice(label) (train_all.py:125-134).

Batches are channels-last like the JAX package's: LR (B, X, Y, C) for WDSR
and (B, D, H, W, C) for FLAVR, HR likewise.

Under data parallelism (a ``torch.distributed`` group, ``parallel.
multihost``) each process steps on its slice of the global batch: the
label dice sums its statistics across processes, the gradients are
averaged across processes before the update, and the returned loss is the
global batch's. Without a group all three are no-ops.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..losses import sr_loss, sr_uncertainty_loss
from ..parallel import multihost
from ..utils.timer import count, span
from .precision import policy as _policy, step_guard


def crop_hr_target(patches_hr: torch.Tensor, slice_separation: int,
                   num_slices: int) -> torch.Tensor:
    """The centre slice-gap crop (train_all.py:122-123) of a (B, D, H, W,
    C) batch."""
    if num_slices <= 1:
        return patches_hr
    sep = int(slice_separation)
    lo = sep * (num_slices // 2 - 1)
    hi = sep * (num_slices // 2)
    return patches_hr[:, lo:hi]


def make_sr_train_step(model, *, enable_uncertainty: bool,
                       slice_separation: float, num_slices: int,
                       precision: str | None = None) -> Callable:
    """Returns step(state, patches_lr, patches_hr) -> (state, metrics).

    ``state``: a :class:`..train.state.TrainState` over ``model`` (its
    optimizer the stage-1 ``onecycle_adam``). The step zeroes the
    gradients, runs forward and backward, and applies one update at
    ``schedule(state.step)``; ``metrics["loss"]`` is a 0-d tensor on the
    device, so steps chain without a sync until the caller reads it. The
    gradients stay in each parameter's ``.grad`` (averaged across
    processes under data parallelism); ``step.loss_fn(lr, hr, reduce=
    None)`` is the forward alone, ``reduce`` the dice's cross-process sum.

    precision: 'bf16' runs the forward and backward in bfloat16 against
    the fp32 master weights, the outputs cast back to fp32 before the loss
    (:mod:`.precision`; on the CPU without oneDNN, :func:`.precision
    .step_guard`); None / 'fp32' is the reference's fp32 step."""
    pol = _policy(precision)

    def loss_fn(patches_lr, patches_hr, reduce=None):
        target = crop_hr_target(patches_hr, int(slice_separation),
                                num_slices)
        params = pol.cast_compute(dict(model.named_parameters()))
        out = torch.func.functional_call(model, params,
                                         (pol.cast_compute(patches_lr),))
        if enable_uncertainty:
            pred, uncertainty = out
            return sr_uncertainty_loss(pol.cast_reduce(pred),
                                       pol.cast_reduce(uncertainty), target,
                                       reduce=reduce)
        return sr_loss(pol.cast_reduce(out), target, reduce=reduce)

    def step(state, patches_lr, patches_hr):
        with span("rehrseg.sr_step", step=state.step):
            count("train.steps")
            count("train.samples", patches_lr.shape[0])
            state.optimizer.zero_grad(set_to_none=True)
            with step_guard(pol, model):
                with span("rehrseg.sr_step.forward"):
                    loss = loss_fn(patches_lr, patches_hr,
                                   reduce=multihost.global_sum)
                with span("rehrseg.sr_step.backward"):
                    loss.backward()
            with (span("rehrseg.sr_step.all_reduce")
                  if multihost.is_multihost() else contextlib.nullcontext()):
                multihost.all_reduce_grads(state.params)
            with span("rehrseg.sr_step.optimizer"):
                state.apply_gradients()
            return state, {"loss": multihost.global_mean(loss.detach())}

    step.loss_fn = loss_fn
    return step
