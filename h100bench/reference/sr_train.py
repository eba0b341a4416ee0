"""The plain reference of the first stage-1b FLAVR steps (REHRSeg
``train_all.py:114-152``), fp32 with TF32 off: the batch rules of
:mod:`.sr_data`, the frozen UNet3D of :mod:`.flavr`, the loss L1(image) +
BCE + sigmoid dice (label) on the HR target's centre slice gap, and torch's
Adam (betas 0.9, 0.99; eps 1e-8) under a one-cycle cosine schedule
(OneCycleLR's defaults: 30 % warm-up, div 25, final div 1e4).

:func:`compare` sets the program's readings beside the reference's: each
step's loss, the first gradient and the change of the parameters, the last
two by the worst leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import flavr, sr_data


def onecycle(max_lr: float, total: int, pct=0.3, div=25.0, final=1e4):
    total = max(float(total), 1.0)
    warm, lo = pct * total, max_lr / div

    def anneal(a, b, t):
        return b + (a - b) * 0.5 * (1.0 + math.cos(math.pi * t))

    def sched(k):
        c = min(max(float(k), 0.0), total)
        if c < warm:
            return anneal(lo, max_lr, min(c / max(warm, 1e-9), 1.0))
        return anneal(max_lr, lo / final,
                      min((c - warm) / max(total - warm, 1e-9), 1.0))
    return sched


def sr_loss(pred, target):
    """L1 on channel 0; BCE with logits + sigmoid dice (squared
    denominator, sums over the batch) on channel 1."""
    l1 = (pred[..., 0:1] - target[..., 0:1]).abs().mean()
    lg, t = pred[..., 1:], target[..., 1:]
    bce = F.binary_cross_entropy_with_logits(lg, t)
    p = torch.sigmoid(lg)
    dice = 1.0 - 2.0 * (p * t).sum() / ((p * p).sum() + (t * t).sum()
                                        ).clamp(min=1e-6)
    return l1 + bce + dice


def follow(cfg: dict, tr: dict, seed: int, stores, weights: dict, device,
           steps: int = 3, conv_hook=None) -> dict:
    """The reference's first ``steps`` steps from ``weights`` on batches
    drawn from ``stores`` and ``seed``. Returns each step's loss, the
    first gradient's norm per leaf and the change's norm per leaf after
    the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = flavr.UNet3D.from_config(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    model.conv_hook = conv_hook
    n_in, n_out = int(cfg["n_inputs"]), int(cfg["n_outputs"])
    ps = (n_out * n_in, int(cfg["patch_size"]), int(cfg["patch_size"]))
    sep = float(cfg["slice_separation"])
    cv, shapes, margin = sr_data.canvas(stores, ps)
    rng = np.random.default_rng(int(seed))
    sim = torch.Generator(device=device).manual_seed(int(seed)
                                                     + int(tr["sim_seed"]))
    aug = torch.Generator(device=device).manual_seed(int(seed)
                                                     + int(tr["aug_seed"]))
    sched = onecycle(float(tr["max_lr"]), int(tr["total_steps"]))
    opt = torch.optim.Adam(model.parameters(), lr=sched(0),
                           betas=(0.9, 0.99), eps=1e-8)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    lo, hi = int(sep) * (n_in // 2 - 1), int(sep) * (n_in // 2)
    losses, first = [], {}
    for k in range(steps):
        decs = [sr_data.decisions(rng, shapes, ps, margin,
                                  bool(tr["random_flip"]))
                for _ in range(int(tr["batch"]))]
        pairs = [sr_data.crop(cv, d, ps) for d in decs]
        lr_src = torch.from_numpy(np.stack([a for a, _ in pairs])).to(device)
        hr = torch.from_numpy(np.stack([b for _, b in pairs])).to(device)
        hr = sr_data.augment_hr(aug, hr)
        lr = sr_data.simulate_lr(sim, lr_src, sep)
        loss = sr_loss(model(lr), hr[:, lo:hi])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if k == 0:
            first = {n: float(p.grad.norm())
                     for n, p in model.named_parameters()}
        for g in opt.param_groups:
            g["lr"] = sched(k)
        opt.step()
        losses.append(float(loss.detach()))
    change = {n: float((p.detach() - p0[n]).norm())
              for n, p in model.named_parameters()}
    return dict(losses=losses, first_grad=first, change=change)


def _worst_leaf(got: dict, want: dict, keep=None) -> float:
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in names)


def compare(prog: dict, ref: dict) -> list:
    """[(name, reading)]: ``loss`` the largest relative gap of a step's
    loss; ``first_grad`` and ``change`` the largest gap of a leaf's norm,
    over the larger of the reference leaf's norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of ``change``."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["first_grad"]
    med = float(np.median(list(g.values())))
    moving = {n for n, v in g.items() if v >= 1e-3 * med}
    return [("loss", loss),
            ("first_grad", _worst_leaf(prog["first_grad"], g)),
            ("change", _worst_leaf(prog["change"], ref["change"], moving))]
