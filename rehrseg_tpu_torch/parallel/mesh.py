"""Device meshes (``rehrseg_tpu.parallel.mesh``): a grid of devices with the
axes ``("data", "spatial")``.

The JAX package shards with ``jax.sharding``: a batch placed over the
mesh's ``'data'`` axis, a tile's or a patch's H over ``'spatial'``, params
replicated, and XLA's partitioner inserting the collectives and the halo
exchanges. PyTorch has no such partitioner, so the mesh here is a
description that the code which runs on it reads:

  - the sliding-window engines split each forward's mirror-TTA batch over
    the mesh's rows (``infer.sliding_window``, ``tta_mesh=``), and each
    row's block runs H-sharded over that row's devices (its *spatial
    group*, :meth:`Mesh.groups`) through :mod:`.spatial`;
  - data-parallel training is one process per card over
    ``torch.distributed`` (:mod:`.multihost`): each process loads its slice
    of the global batch (``BatchLoader(shard=)``) and the step all-reduces
    the gradients (:func:`.multihost.all_reduce_grads`); with a spatial
    extent above 1 each process drives a group of cards and its step runs
    H-sharded over them (:func:`.multihost.place_global`).

So ``batch_sharding``, ``shard_batch``, ``replicate`` and ``replicated``
have no counterpart: the engine places each block of a batch on its
device itself, and :func:`.multihost.replicate_global` broadcasts the
primary's parameters.
"""

from __future__ import annotations

import torch


class Mesh:
    """A (data, spatial) grid of ``torch.device``s. A device may appear more
    than once (as XLA's forced host device count names one CPU several
    times); code that runs on the mesh keeps one replica per distinct
    device."""

    axis_names = ("data", "spatial")

    def __init__(self, grid):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        if not self.devices or not self.devices[0] or len(
                {len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "spatial": len(self.devices[0])}

    @property
    def data_devices(self) -> list:
        """The device of each data index (spatial index 0)."""
        return [row[0] for row in self.devices]

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def groups(self) -> list:
        """Each data index's spatial devices (a row of the grid)."""
        return [list(row) for row in self.devices]

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def visible_cards() -> list:
    """Every CUDA device this process sees, once each."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, spatial: int = 1,
              devices=None) -> Mesh:
    """A (data, spatial) mesh over ``devices`` (default: every visible card)
    or their first ``n_devices``: the JAX package's (n / spatial, spatial)
    grid, device i at row i // spatial, column i % spatial. Asking for more
    devices than there are raises; so does a ``spatial`` that does not
    divide the count (the JAX package's ValueError)."""
    if devices is None:
        devices = visible_cards()
        if not devices:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; name the devices "
                "(devices=[torch.device('cpu')] * n) to build a mesh on the "
                "CPU")
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"{len(devices)} available")
    devices = devices[:n_devices]
    if spatial < 1 or n_devices % spatial != 0:
        raise ValueError(
            f"mesh_spatial={spatial} must divide the visible device count "
            f"({n_devices}); on a single card only mesh_spatial=1 works — "
            f"for CPU validation name the devices "
            f"(devices=[torch.device('cpu')] * N)")
    return Mesh([devices[i * spatial:(i + 1) * spatial]
                 for i in range(n_devices // spatial)])
