"""Data-parallel helpers over ``torch.distributed`` (``rehrseg_tpu.parallel.
multihost``): one process per card, each holding the whole model and its
slice of the global batch.

In the JAX package a plain ``jax.jit`` step compiles SPMD over a mesh that
spans the processes, and XLA inserts the gradient all-reduce. Here the
step calls :func:`all_reduce_grads` itself, after the backward and before
the update; the stage-1 loss, whose dice couples the batch, sums its
statistics across processes through :func:`global_sum`.

- ``globalize_batch``, ``globalize_key`` and ``localize`` have no
  counterpart, as they would be identities: each process keeps its slice
  of the global batch as an ordinary tensor (there is no global array to
  assemble), its modules are its own (nothing to fetch to the host), and
  the random draws of a global batch are taken by every process from a
  generator seeded alike, which advances in lockstep (each process draws
  for the whole global batch and applies its own rows, ``device_aug``'s
  and ``device_sr_sim``'s ``shard=``).
- with a ``'spatial'`` extent S > 1 each process drives S cards (its
  *spatial group*): :func:`place_global` places its batch as H-blocks
  over them and :func:`replicate_any` keeps the parameters on the group's
  first card, from which the step copies them to each block's card
  (differentiably: autograd adds the blocks' gradients into the leaf), so
  :func:`all_reduce_grads` runs across processes as without S.

Every function is a no-op in a process without a process group, so call
sites do not branch. Collectives run whenever a group exists, of one
process too (where they are identities). Every process must call them in
the same order.
"""

from __future__ import annotations

import zlib

import torch
import torch.distributed as dist

# the largest flat gradient bucket of one all-reduce
_BUCKET_BYTES = 256 << 20


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def is_multihost() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on process 0 (and in a single process). Host-side side effects
    (NIfTI, HDF5, checkpoint and metrics writes, evaluation) run on the
    primary only: concurrent writers corrupt shared files."""
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where a collective's small tensors live: the current card for
    NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(tag: str) -> None:
    """A sync point that also checks every process passed the same tag
    (the tags' hashes, min and max, must agree). Placed after primary-only
    artifact writes so other processes never read half-written outputs."""
    if not _active():
        return
    h = float(zlib.crc32(tag.encode()))
    t = torch.tensor([h, -h], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t[0].item() != h or -t[1].item() != h:
        raise RuntimeError(f"barrier {tag!r}: the processes passed "
                           f"different barriers")


def broadcast_scalar(value: float) -> float:
    """The primary's scalar on every process (e.g. a validation dice
    computed on process 0 that gates a save every process makes)."""
    if not _active():
        return float(value)
    t = torch.tensor([float(value) if is_primary() else 0.0],
                     dtype=torch.float64, device=_comm_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def any_flag(flag: bool) -> bool:
    """OR of a local flag across processes: a SIGTERM caught by one
    process still checkpoints and stops them all."""
    if not _active():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def data_shard() -> tuple[int, int] | None:
    """(process_index, process_count) for ``BatchLoader(shard=...)``, or
    None in a single process (keeps the single-process stream
    byte-identical)."""
    if not is_multihost():
        return None
    return (process_index(), process_count())


def validate_global_batch(global_batch: int, mesh=None, axis: str = "data",
                          what: str = "batch") -> None:
    """Data parallelism needs the global batch divisible by the data
    extent: ``mesh.shape[axis]``, or the process count without a mesh."""
    n = int(mesh.shape[axis]) if mesh is not None else process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"{what}={global_batch} must be a multiple of the mesh '{axis}' "
            f"axis ({n} devices across {process_count()} processes); "
            f"raise {what} to {((global_batch // n) + 1) * n} or run a "
            f"smaller slice")


def _modules(tree) -> list:
    """The modules of a module, a dict of modules or a TrainState."""
    if hasattr(tree, "params") and hasattr(tree, "optimizer"):
        tree = tree.params
    if isinstance(tree, dict):
        return [m for v in tree.values() for m in _modules(v)]
    if isinstance(tree, (list, tuple)):
        return [m for v in tree for m in _modules(v)]
    return [tree]


def replicate_global(tree):
    """Broadcast the primary's parameters and buffers (of a module, a dict
    of modules or a TrainState's ``params``) to every process; returns
    ``tree``. Processes that restored the same checkpoint or seeded alike
    hold the same values already: this makes it so by construction."""
    if not _active():
        return tree
    with torch.no_grad():
        for m in _modules(tree):
            for t in list(m.parameters()) + list(m.buffers()):
                dist.broadcast(t.data, src=0)
    return tree


def _bucket_grads(params):
    """Buckets of gradients, each of one device and dtype and at most
    ``_BUCKET_BYTES`` (a larger gradient has a bucket of its own), in
    parameter order."""
    buckets, open_ = [], {}
    for m in _modules(params):
        for p in m.parameters():
            if p.grad is None:
                continue
            key = (p.grad.device, p.grad.dtype)
            cur = open_.get(key)
            size = p.grad.numel() * p.grad.element_size()
            if cur is None or cur[1] + size > _BUCKET_BYTES:
                cur = [[], 0]
                open_[key] = cur
                buckets.append(cur[0])
            cur[0].append(p.grad)
            cur[1] += size
    return buckets


def all_reduce_grads(params) -> None:
    """Replace every gradient of ``params`` (a module, a dict of modules or
    a TrainState) by its mean across processes: the gradient all-reduce
    XLA inserts in the JAX package's data-parallel step. Gradients go as
    a few flat buckets. Every process must hold gradients for the same
    parameters (an unused parameter keeps None everywhere)."""
    if not _active():
        return
    world = dist.get_world_size()
    for grads in _bucket_grads(params):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(world)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` across processes, differentiable: its backward
    sums the upstream gradients across processes too. A loss term built
    from it has the same value on every process, so each process's
    gradient of it is N times its share; the mean that
    :func:`all_reduce_grads` takes then gives exactly the gradient of the
    term over the global batch."""
    if not _active():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a detached tensor across processes (a logged loss)."""
    if not _active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()


def place_global(tree, spatial_devices):
    """A batch (a tensor, or a dict / tuple / NamedTuple of them, each
    (B, D, H, W, ...) with H at dim 2) placed for a spatially sharded step:
    each tensor split along H into even blocks over ``spatial_devices``
    (:class:`.spatial.HBlocks`), or moved to the one device of a group of
    one. The process's slice of the global batch stays whole along B."""
    from . import spatial

    group = [torch.device(d) for d in spatial_devices]

    def place(t):
        if not isinstance(t, torch.Tensor):
            return t
        if len(group) == 1:
            return t.to(group[0], non_blocking=True)
        return spatial.split(t.to(group[0], non_blocking=True), group)

    if isinstance(tree, dict):
        return {k: place(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(place(v) for v in tree)) \
            if hasattr(tree, "_fields") else tuple(place(v) for v in tree)
    return place(tree)


def replicate_any(tree, spatial_devices):
    """Parameters (a module, a dict of modules or a TrainState) on the
    spatial group's first device, broadcast from the primary when a
    process group exists (:func:`replicate_global`); returns ``tree``.
    The step copies them to every block's device itself."""
    home = torch.device(spatial_devices[0])
    for m in _modules(tree):
        m.to(home)
    return replicate_global(tree)
