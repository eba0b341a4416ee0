"""Fold-parallel training (``rehrseg_tpu.parallel.fold_parallel``): the K
cross-validation folds trained side by side, one fold per device, in one
process.

The JAX package stacks the folds' states on a leading axis sharded over a
``('fold',)`` mesh and runs the unchanged per-fold step under
``shard_map``. Here fold k's state, batch and teacher copy live on device
k, and one fold-parallel step dispatches every fold's unchanged step in
turn: the launches are asynchronous, so folds on distinct cards overlap.
There is no communication between folds. The folds' states are a plain
list, fold k's on device k, so the JAX package's ``stack_fold_states`` /
``unstack_fold_state`` have no counterpart.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable

import torch

from .mesh import Mesh, visible_cards


def make_fold_mesh(n_folds: int, devices=None) -> Mesh:
    """A one-axis mesh (as a Mesh with data = n_folds) over the first
    ``n_folds`` of ``devices`` (default: the distinct visible cards).
    Fewer devices than folds raises: a fold never falls back to another
    card or to the CPU. ``devices`` may name one device more than once."""
    if devices is None:
        devices = visible_cards()
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_folds:
        raise AssertionError(f"need {n_folds} devices, have {len(devices)}")
    return Mesh([[d] for d in devices[:n_folds]])


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def make_fold_parallel_step(step_fn, mesh: Mesh) -> Callable:
    """Lift a per-fold ``(state, *batch) -> (state, metrics)`` step to the
    folds: ``step(states, batches)`` with a list of K states and a list of
    K batches (each a tuple of the step's batch arguments) returns (states,
    [metrics of fold k]). Fold k's batch is moved to device k. step_fn: one
    step for every fold, or a list of K (e.g. each closing over the teacher
    copy on its device)."""
    devices = mesh.data_devices
    k_folds = len(devices)
    steps = list(step_fn) if isinstance(step_fn, (list, tuple)) \
        else [step_fn] * k_folds
    if len(steps) != k_folds:
        raise ValueError(f"{len(steps)} step functions for {k_folds} folds")

    def step(states, batches):
        if len(states) != k_folds or len(batches) != k_folds:
            raise ValueError(f"expected {k_folds} states and batches, got "
                             f"{len(states)} and {len(batches)}")
        new_states, metrics = [], []
        for k in range(k_folds):
            with (torch.cuda.device(devices[k])
                  if devices[k].type == "cuda" else nullcontext()):
                st, m = steps[k](states[k], *_to(tuple(batches[k]),
                                                 devices[k]))
            new_states.append(st)
            metrics.append(m)
        return new_states, metrics

    return step
