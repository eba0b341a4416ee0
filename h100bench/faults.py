"""Faults planted underneath the timed path, to see the comparison catch
them: the CPU tests plant each in a toy run, and ``control.py --fault``
reads them at a cell's own size. Each fault is a function of a
``monkeypatch``-like object (``setattr(obj, name, value)``) that replaces
one function of the program.
"""

from __future__ import annotations

import torch


def half_tta(mp):
    """Serving: half of each tile's mirror batch left out, the mean taken
    over the rest (the parity grid's flips cut to four; on the aligned
    grid the z-flipped half replaced by the other half, z-flipped)."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.ops import tail

    combos = sw._flip_axes_combinations
    real = tail.accumulate_tta_tile

    def half(logits, preds, g, off, *, z_scale=1):
        return real(logits, torch.cat([preds[:4], preds[:4].flip(2)]), g,
                    off, z_scale=z_scale)

    mp.setattr(sw, "_flip_axes_combinations", lambda n=3: combos(n)[:4])
    mp.setattr(sw, "accumulate_tta_tile", half)


def altered_labels(mp):
    """Serving: an answer altered where it is produced, the first half of
    each label map flipped."""
    from rehrseg_tpu_torch.infer import sliding_window as sw

    real = sw._argmax_uint8

    def altered(logits, dim=-1):
        lab = real(logits, dim).clone()
        lab[:lab.shape[0] // 2 + 1] ^= 1
        return lab

    mp.setattr(sw, "_argmax_uint8", altered)


def unchanged_state(mp):
    """Training: a step that returns its state unchanged."""
    from rehrseg_tpu_torch.train.state import TrainState

    def no_update(self):
        self.step += 1

    mp.setattr(TrainState, "apply_gradients", no_update)


def half_batch(mp):
    """Training: half of the batch left out, the mean taken over the
    rest."""
    from rehrseg_tpu_torch.train import sr_trainer

    real = sr_trainer.sr_loss

    def half(pred, target, **kw):
        n = max(pred.shape[0] // 2, 1)
        return real(pred[:n], target[:n], **kw)

    mp.setattr(sr_trainer, "sr_loss", half)


def altered_batch(mp):
    """Training: an answer altered where it is produced, the first
    gathered HR patch zeroed."""
    from rehrseg_tpu_torch.data import device_sampler

    real = device_sampler.gather_batch

    def altered(canvas, dec, ps):
        lr, hr = real(canvas, dec, ps)
        hr = hr.clone()
        hr[0] = 0
        return lr, hr

    mp.setattr(device_sampler, "gather_batch", altered)


SERVE = {"half_batch": half_tta, "altered_answer": altered_labels}
TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_answer": altered_batch}
BY_DRIVER = {"serve_volumes": SERVE, "train_stage1_sr": TRAIN}


class Patch:
    """A minimal ``monkeypatch``: ``setattr`` now, ``undo`` later."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)
