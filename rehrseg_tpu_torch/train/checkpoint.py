"""Checkpoints with true resume (step, params, optimizer state) in PyTorch's
idiom: the counterpart of ``rehrseg_tpu.train.checkpoint`` (orbax there).

A checkpoint is ``<directory>/<step or tag>/<name>.pt``, one ``torch.save``
of ``{"params", "opt_state", "step"}``: params a module's state dict (or a
dict of them, e.g. ``{"seg": ..., "distiller": ...}``), opt_state an
optimizer's state dict or None, step an int. Tensors are stored on the CPU,
and everything is a tensor, a container or a plain number, so it loads with
``torch.load(weights_only=True)``. A save writes a temporary file and
renames it, so a process killed mid-save leaves a step directory that
:func:`latest_step` does not see. The port does not read orbax checkpoints;
JAX params cross over through ``models.convert.load_flax_params``. Under
data parallelism every process calls :func:`save_checkpoint` in lockstep
and the primary alone writes; all pass a barrier after the write, so any
of them can restore it at once.
"""

from __future__ import annotations

import os

import torch

_SUFFIX = ".pt"
_TMP = ".tmp"


def _host(obj):
    """State dicts (or anything with ``state_dict``) as nested containers
    of CPU tensors."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return type(obj)((k, _host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _path(directory: str, step, name: str) -> str:
    return os.path.join(os.path.abspath(directory), str(step), name + _SUFFIX)


def save_checkpoint(directory: str, params, opt_state=None, *, step: int,
                    tag: str | None = None, name: str = "state") -> str:
    """Write ``{"params", "opt_state", "step"}`` under
    ``directory/<tag or step>/<name>.pt``; returns the step directory.

    params / opt_state: a module / optimizer or their state dicts (nested
    dicts of them allowed). ``tag`` (e.g. "best") names the directory in
    place of the step; tag directories are ignored by :func:`latest_step`,
    so a tagged save never interferes with step-based resume."""
    from ..parallel import multihost

    path = _path(directory, step if tag is None else tag, name)
    if multihost.is_primary():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"params": _host(params), "opt_state": _host(opt_state),
                    "step": int(step)}, path + _TMP)
        os.replace(path + _TMP, path)
    multihost.barrier("checkpoint")
    return os.path.dirname(path)


def restore_checkpoint_raw(directory: str, step: int | str | None = None,
                           name: str = "state") -> dict:
    """The saved ``{"params", "opt_state", "step"}`` (CPU tensors).
    ``step``: a step number, a tag such as "best", or None for the latest
    complete step."""
    if step is None:
        step = latest_step(directory, name)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {os.path.abspath(directory)}")
    return torch.load(_path(directory, step, name), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(directory: str, model, optimizer=None,
                       step: int | str | None = None,
                       name: str = "state") -> int:
    """Load a checkpoint into ``model`` (strict) and, when given,
    ``optimizer``; returns the saved step."""
    restored = restore_checkpoint_raw(directory, step, name)
    model.load_state_dict(restored["params"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(restored["opt_state"])
    return int(restored["step"])


def latest_step(directory: str, name: str = "state") -> int | None:
    """Latest COMPLETE step: a step directory holding only the temporary
    file of a save that did not finish is not one."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit()
             and os.path.isfile(os.path.join(directory, d, name + _SUFFIX))]
    return max(steps) if steps else None


def has_checkpoint(directory: str) -> bool:
    return latest_step(directory) is not None
