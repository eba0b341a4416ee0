"""Optimizers and learning-rate schedules of the reference recipes
(``rehrseg_tpu.train.optim``, optax there).

  - Stage 1 (SR): Adam(betas=(0.9, 0.99), eps=1e-8) with a one-cycle
    cosine schedule (torch OneCycleLR's defaults: pct_start 0.3,
    div_factor 25, final_div_factor 1e4), defined for any total >= 1.
  - Stage 2 (seg): SGD(momentum=0.99, nesterov, weight_decay=3e-5) with
    PolynomialLR stepped per epoch (power 1): lr(e) = lr0 * (1 - e/E).
    torch's SGD adds the decay to the gradient before the momentum buffer
    and starts the buffer at the first gradient: optax's
    ``add_decayed_weights -> trace(nesterov)`` from a zero trace.

Schedules are plain functions of ``count``, the number of updates already
applied (0 for the first, as optax counts). The optimizers are
``torch.optim`` objects whose param groups carry an ``lr_scale``;
:func:`set_lr` writes ``schedule(count) * lr_scale`` into every group
before each ``step()`` (:class:`rehrseg_tpu_torch.train.state.TrainState`
does it), so no ``lr_scheduler`` and no off-by-one.
"""

from __future__ import annotations

import math

import torch


def cosine_onecycle_schedule(max_lr: float, total_steps: int,
                             pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """Torch-OneCycleLR-shaped schedule, safe for any total_steps >= 1:
    cosine ramp init_lr -> max_lr over pct_start*total, then cosine anneal
    max_lr -> final_lr over the remainder."""
    total = max(float(total_steps), 1.0)
    warm = pct_start * total
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div_factor

    def _anneal(start, end, pct):
        return end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * pct))

    def sched(count):
        c = min(max(float(count), 0.0), total)
        if c < warm:
            return _anneal(init_lr, max_lr,
                           min(max(c / max(warm, 1e-9), 0.0), 1.0))
        pct = (c - warm) / max(total - warm, 1e-9)
        return _anneal(max_lr, final_lr, min(max(pct, 0.0), 1.0))

    return sched


def poly_epoch_schedule(base_lr: float, total_epochs: int,
                        iters_per_epoch: int, power: float = 1.0):
    """PolynomialLR stepped once per epoch, on the iteration axis."""
    def sched(count):
        epoch = int(count) // max(iters_per_epoch, 1)
        frac = 1.0 - min(epoch, total_epochs) / total_epochs
        return base_lr * frac ** power
    return sched


def set_lr(optimizer, schedule, count: int) -> None:
    """lr of every group = ``schedule(count) * group["lr_scale"]``."""
    lr = float(schedule(count))
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


def _params(modules):
    if isinstance(modules, dict):
        return [p for m in modules.values() for p in _params(m)]
    if isinstance(modules, torch.nn.Module):
        return list(modules.parameters())
    return list(modules)


def onecycle_adam(params, max_lr: float, total_steps: int,
                  betas=(0.9, 0.99)):
    """(Adam, its schedule); params: a module, a dict of modules or an
    iterable of tensors."""
    sched = cosine_onecycle_schedule(max_lr, total_steps)
    opt = torch.optim.Adam([{"params": _params(params), "lr_scale": 1.0}],
                           lr=sched(0), betas=tuple(betas), eps=1e-8)
    return opt, sched


def nesterov_sgd(params, momentum: float = 0.99,
                 weight_decay: float = 3e-5):
    """torch SGD: decay added to the gradient before the momentum update,
    nesterov lookahead; one group at the schedule's full lr."""
    return torch.optim.SGD(
        [{"params": _params(params), "lr_scale": 1.0}], lr=0.0,
        momentum=momentum, nesterov=True, weight_decay=weight_decay)


def sr_head_split(model) -> tuple[list, list]:
    """(sr_head params, the others) of a SegModel: the reference's
    separate_weight_extensive_params (train_all.py:64-83)."""
    head, other = [], []
    for name, p in model.named_parameters():
        (head if "sr_head" in name else other).append(p)
    return head, other


def nesterov_sgd_grouped(model, momentum: float = 0.99,
                         weight_decay: float = 3e-5):
    """Two groups (train_all.py:64-83, used without distillation): the SR
    head at the full lr with weight decay, every other parameter at 0.1x
    the lr and NO weight decay."""
    head, other = sr_head_split(model)
    return torch.optim.SGD(
        [{"params": head, "lr_scale": 1.0, "weight_decay": weight_decay},
         {"params": other, "lr_scale": 0.1, "weight_decay": 0.0}],
        lr=0.0, momentum=momentum, nesterov=True)
