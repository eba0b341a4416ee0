"""Gaussian-weighted sliding-window inference engines
(``rehrseg_tpu.infer.sliding_window`` in PyTorch).

Tile the volume with step = patch * 0.5 (steps evenly redistributed), run
each tile as one batched forward of its mirror-TTA flips, accumulate
``prediction * gaussian`` in fp32 and argmax. The JAX package's jitted
``lax.scan`` over tiles becomes a Python loop over tiles here, and the
accumulators are updated in place.

Two tile grids and a streamed form of the first:

  - the parity grid (:func:`sliding_window_starts`), bit-identical to the
    reference's, with the flip combos in ``_flip_axes_combinations`` order;
  - the aligned grid (:func:`aligned_sliding_window_starts`): H starts
    snapped to multiples of 8 and W starts to multiples of 128, the volume
    padded just enough and the result cropped back. Its model emits
    per-class planes for a z-grouped mirror batch and K2
    (:func:`rehrseg_tpu_torch.ops.tail.accumulate_tta_tile`) does unmirror,
    mean, gaussian weight and accumulate in one pass. Its labels differ
    from the parity grid's by design;
  - z-slab streaming of the parity grid (``*_streamed``): the grid's tiles
    grouped by z-start, each group's slab uploaded alone with slab-sized
    accumulators on the device, its fp32 logits fetched and added into
    host buffers; the weighted sums are additive, so the labels are the
    whole-volume engine's (up to fp32 summation order).

``model_fn(batch)`` maps a (B, pd, ph, pw, C) batch to logits; unlike the
JAX engines it takes no params argument (a torch model holds its own).
The volume is uploaded as bf16 by default, as the JAX engines do, whatever
the compute dtype. On the card the upload and the label fetch go through
pinned host memory without blocking, so the ``_many`` engines enqueue every
volume's tiles and argmax before they wait once for all label maps.

One volume shards over several devices with ``tta_mesh=`` (a
:class:`..parallel.mesh.Mesh`): each forward's mirror batch splits over the
mesh's 'data' rows, and ``model_fn`` runs each block on its row's first
device (the Segmenter keeps one weight replica per distinct device). With
a 'spatial' extent S above 1 nothing the size of the volume or of a tile's
logits is whole on one device, as in the JAX engine: the volume, the fp32
accumulators and the label maps are :class:`..parallel.spatial.HBlocks`,
S even H blocks over the first data row's devices; each tile is read from
the volume's blocks straight into its own S blocks on each data row's
devices (an H flip reverses the blocks and their rows), ``model_fn`` runs
it H-sharded and hands its logits back as blocks, and each accumulator
block adds the rows it owns, unmirrored and weighted on its device
(:func:`_run_h_sharded`). The other data rows' logits go to the owners on
the first row: one copy of the accumulators, where JAX replicates them over
'data'. The labels' blocks are joined on the host; :data:`BUFFERS` records
each buffer's blocks.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.normalize import zscore_normalization
from ..losses import calculate_dice
from ..ops.gaussian import compute_gaussian
from ..ops.tail import accumulate_tta_tile, zgrouped_combos
from ..parallel import spatial
from ..parallel.spatial import HBlocks
from ..utils.device import resolve_device
from ..utils.pad import crop, target_pad
from ..utils.timer import count, span


def compute_steps_for_sliding_window(image_size, tile_size, tile_step_size):
    """Evenly redistributed tile starts per dim (seg_utils.py:176-199)."""
    assert all(i >= j for i, j in zip(image_size, tile_size)), \
        "image size must be as large or larger than patch_size"
    assert 0 < tile_step_size <= 1

    target_step = [i * tile_step_size for i in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target_step, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_step_value = image_size[dim] - tile_size[dim]
        if num_steps[dim] > 1:
            actual = max_step_value / (num_steps[dim] - 1)
        else:
            actual = 1e13
        steps.append([int(np.round(actual * i)) for i in range(num_steps[dim])])
    return steps


def sliding_window_starts(image_size, patch_size, tile_step_size=0.5) -> np.ndarray:
    """All (z, y, x) tile start coordinates as an (N, 3) int32 array."""
    steps = compute_steps_for_sliding_window(image_size, patch_size,
                                             tile_step_size)
    starts = [(sx, sy, sz) for sx in steps[0] for sy in steps[1]
              for sz in steps[2]]
    return np.asarray(starts, dtype=np.int32)


def _flip_axes_combinations(ndim_spatial: int = 3):
    """Identity + all 2^n - 1 mirror combinations over spatial axes 0..n-1
    (reference mirror order, seg_utils.py:213-215)."""
    combos = [()]
    for i in range(ndim_spatial):
        combos.extend(itertools.combinations(range(ndim_spatial), i + 1))
    return combos


def _mirror_batch(tile: torch.Tensor, combos) -> torch.Tensor:
    """(D, H, W, C) -> (n_combos, D, H, W, C) stacking every flip."""
    return torch.stack([tile.flip(c) if c else tile for c in combos])


def _unmirror_mean(preds, combos) -> torch.Tensor:
    """Invert each flip and average over the TTA batch ``preds`` (a tensor,
    or a list of each flip's output) in preds' dtype, summed in combo
    order, as the JAX engine does."""
    acc = None
    for i, c in enumerate(combos):
        part = preds[i].flip(c) if c else preds[i]
        acc = part if acc is None else acc + part
    return acc / len(combos)


def _gaussian(out_patch, use_gaussian: bool, device) -> torch.Tensor:
    if use_gaussian:
        g = np.array(compute_gaussian(tuple(out_patch), 1.0 / 8, 10.0))
    else:
        g = np.ones(out_patch, dtype=np.float32)
    return torch.from_numpy(g).to(device)


def _upload(data: np.ndarray, input_dtype, device) -> torch.Tensor:
    """The volume on ``device``; a copy to the card is enqueued from pinned
    memory and does not wait for the work queued before it."""
    with span("rehrseg.segment.upload"):
        t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        return t.to(device=device, dtype=input_dtype or torch.float32)


def _argmax_uint8(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The uint8 label map, on the logits' device (nothing waits)."""
    with span("rehrseg.segment.argmax"):
        return logits.argmax(dim).to(torch.uint8)


def _to_host(labels: Sequence) -> list:
    """Label maps (tensors, or :class:`..parallel.spatial.HBlocks` whose
    blocks are joined on the host) as numpy arrays. From the card: one
    non-blocking copy into pinned host memory per map or block, then one
    wait on each card for all of them, before any array is handed back
    (the wait counted in ``serve.fetch_wait_ns``)."""
    with span("rehrseg.segment.fetch"):
        parts = [p for t in labels
                 for p in (t.parts if isinstance(t, HBlocks) else [t])]
        cards = {p.device for p in parts if p.device.type == "cuda"}
        host = []
        for p in parts:
            if p.device.type == "cuda":
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                host.append(h)
            else:
                host.append(p)
        t0 = time.perf_counter_ns()
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        count("serve.fetch_wait_ns", time.perf_counter_ns() - t0)
        out, i = [], 0
        for t in labels:
            if isinstance(t, HBlocks):
                n = len(t.parts)
                out.append(np.concatenate([h.numpy()
                                           for h in host[i:i + n]],
                                          axis=t.dim))
                i += n
            else:
                out.append(host[i].numpy())
                i += 1
        return out


def _mesh_groups(tta_mesh, n_batch: int):
    """The spatial device groups (mesh rows) a mirror batch of ``n_batch``
    splits over, or None without a mesh."""
    if tta_mesh is None:
        return None
    groups = tta_mesh.groups()
    if n_batch % len(groups):
        raise ValueError(
            f"the mesh's 'data' axis of {len(groups)} devices must divide "
            f"the mirror batch of {n_batch} (tiles_per_step x flips)")
    return groups


def _h_sharded(tta_mesh) -> bool:
    """Does ``tta_mesh`` split H (a 'spatial' extent above 1)?"""
    return tta_mesh is not None and tta_mesh.shape["spatial"] > 1


def _mesh_home(tta_mesh, device):
    """The accumulators' device: ``device``, else the mesh's first."""
    if device is None and tta_mesh is not None:
        return tta_mesh.first
    return device


def _sharded_forward(model_fn: Callable, batch: torch.Tensor, groups):
    """The forward of ``batch`` split into len(groups) contiguous blocks in
    flip order, block i run on the one device of groups[i], the outputs (a
    tensor or a tuple of them) gathered back on the batch's device in
    order. Every block is enqueued before any output is copied back, so
    blocks on distinct cards run side by side."""
    if groups is None:
        return model_fn(batch)
    outs = [model_fn(block.to(group[0], non_blocking=True))
            for block, group in zip(batch.chunk(len(groups)), groups)]

    def cat(parts):
        return torch.cat([o.to(batch.device, non_blocking=True)
                          for o in parts])
    if isinstance(outs[0], tuple):
        return tuple(cat(p) for p in zip(*outs))
    return cat(outs)


def _padded_starts(image_size, patch_size, tile_step_size,
                   tiles_per_step: int) -> list:
    """(sx, sy, sz, valid) rows of the parity grid, padded to a multiple of
    tiles_per_step with repeats of the last start at valid = 0."""
    starts = sliding_window_starts(image_size, patch_size,
                                   tile_step_size).tolist()
    rows = [(*s, 1) for s in starts]
    rows += [(*starts[-1], 0)] * ((-len(rows)) % tiles_per_step)
    return rows


# ------------------------------------------------- H-sharded engine buffers
#
# With a mesh whose 'spatial' extent S is above 1, no device holds the
# volume, an accumulator, a label map or a tile's logits whole: each is an
# HBlocks of its H (the volume's dim 1, a batch's dim 2) in even blocks
# over the first data row's group, as the JAX engine's P(None, 'spatial')
# lays them out. Its accumulators are not replicated over 'data' as JAX's
# are: the other rows' outputs go to the owner of their rows.

# (name, block starts, devices) of each engine buffer, in order, for the
# volumes served on an H-sharded mesh since reset_buffers() (the last
# entries only: a server's record stays bounded)
BUFFERS: collections.deque = collections.deque(maxlen=1024)


def reset_buffers() -> None:
    BUFFERS.clear()


def _record(name: str, x: HBlocks) -> HBlocks:
    BUFFERS.append((name, *spatial.layout(x)))
    return x


def _upload_blocks(data: np.ndarray, input_dtype, group) -> HBlocks:
    """The volume as even H blocks over ``group``, each block's rows
    uploaded to its own device."""
    starts = spatial.partition(data.shape[1], len(group))
    return HBlocks([_upload(data[:, a:b], input_dtype, dev) for a, b, dev
                    in zip(starts, starts[1:], group)], starts, group, dim=1)


def _zeros_blocks(vol: HBlocks, depth: int, *channels) -> HBlocks:
    """fp32 zeros of (depth, H, W, *channels) on ``vol``'s blocks."""
    w = vol.parts[0].shape[2]
    return HBlocks([torch.zeros((depth, b - a, w, *channels),
                                dtype=torch.float32, device=p.device)
                    for p, a, b in zip(vol.parts, vol.starts, vol.starts[1:])],
                   vol.starts, vol.group, dim=1)


def _mirror_blocks(vol: HBlocks, tiles, combos, patch, groups) -> list:
    """The mirror batch of ``tiles`` ((sx, sy, sz) starts), flip-major per
    tile as :func:`_mirror_batch` stacks it, split into len(groups)
    contiguous blocks: block r an HBlocks of the tile's even H blocks on
    groups[r]. Each tile block's rows come straight from the volume blocks
    that hold them; an H flip reads the mirrored rows (block S-1-j of an
    even partition) and reverses them, D and W flips stay in the block."""
    pd, ph, pw = patch
    t_starts = spatial.partition(ph, len(groups[0]))
    n_tta = len(combos)
    per_row = len(tiles) * n_tta // len(groups)
    out = []
    for r, group in enumerate(groups):
        parts = []
        for a, b, dev in zip(t_starts, t_starts[1:], group):
            src, stack = {}, []
            for i in range(r * per_row, (r + 1) * per_row):
                (sx, sy, sz), c = tiles[i // n_tta], combos[i % n_tta]
                g0, g1 = (ph - b, ph - a) if 1 in c else (a, b)
                key = (i // n_tta, g0)
                if key not in src:
                    src[key] = spatial.rows(
                        vol, sy + g0, sy + g1, dev,
                        pick=lambda t, sx=sx, sz=sz:
                        t[sx:sx + pd, :, sz:sz + pw])
                stack.append(src[key].flip(c) if c else src[key])
            parts.append(torch.stack(stack))
        out.append(HBlocks(parts, t_starts, group))
    return out


def _accumulate_blocks(acc: HBlocks, weights, outs, tiles, combos, g,
                       z_scale: int, patch) -> None:
    """Unmirror, mean, gaussian-weight and add each valid tile of ``tiles``
    ((sx, sy, sz, valid) rows) into the accumulator blocks that own its
    rows, on their devices. ``outs``: the forward's output HBlocks of each
    data row (the mirror batch split as :func:`_mirror_blocks` splits it);
    each accumulator block reads the tile rows it owns from the blocks
    that hold them (the mirrored rows for an H flip) and averages them
    with :func:`_unmirror_mean`."""
    pd, ph, pw = patch
    od = pd * z_scale
    n_tta = len(combos)
    per_row = len(tiles) * n_tta // len(outs)
    for k, (a0, a1, dev) in enumerate(zip(acc.starts, acc.starts[1:],
                                          acc.group)):
        slabs = {}
        for t, (sx, sy, sz, valid) in enumerate(tiles):
            r0, r1 = max(a0 - sy, 0), min(a1 - sy, ph)
            if not valid or r0 >= r1:
                continue
            parts = []
            for ci, c in enumerate(combos):
                r, li = divmod(t * n_tta + ci, per_row)
                g0, g1 = (ph - r1, ph - r0) if 1 in c else (r0, r1)
                if (r, g0, g1) not in slabs:
                    slabs[r, g0, g1] = spatial.rows(outs[r], g0, g1, dev)
                parts.append(slabs[r, g0, g1][li])
            gk = g[dev][:, r0:r1]
            zo, y0 = sx * z_scale, sy + r0 - a0
            acc.parts[k][zo:zo + od, y0:y0 + r1 - r0, sz:sz + pw] += \
                _unmirror_mean(parts, combos).float() * gk[..., None]
            if weights is not None:
                weights.parts[k][zo:zo + od, y0:y0 + r1 - r0,
                                 sz:sz + pw] += gk


@torch.no_grad()
def _run_h_sharded(model_fn: Callable, data: np.ndarray, patch_size,
                   z_scales, tile_step_size, use_gaussian, mirror,
                   num_classes, input_dtype, need_weights: bool, rows,
                   tiles_per_step: int, tta_mesh):
    """The tile loop on an H-sharded mesh: the volume, one fp32 logit
    accumulator per head (``z_scales``: 1 for LR, the HR head's z factor)
    and, for a single head with ``need_weights``, the weights, all as
    even H blocks over the first data row's group. ``model_fn`` takes an
    HBlocks and returns the logits (a tuple of them for two heads) as
    HBlocks. Returns (accumulators, weights or None)."""
    pd, ph, pw = (int(p) for p in patch_size)
    k = int(tiles_per_step)
    combos = _flip_axes_combinations(3) if mirror else [()]
    groups = _mesh_groups(tta_mesh, k * len(combos))
    home = groups[0]
    vol = _record("volume", _upload_blocks(data, input_dtype, home))
    d = vol.shape[0]
    accs = [_record(f"logits_x{z}", _zeros_blocks(vol, d * z, num_classes))
            for z in z_scales]
    weights = (_record("weights", _zeros_blocks(vol, d * z_scales[0]))
               if need_weights else None)
    gs = []
    for z in z_scales:
        g = _gaussian((pd * z, ph, pw), bool(use_gaussian), home[0])
        gs.append({dev: g.to(dev) for dev in set(home)})
    if rows is None:
        rows = _padded_starts(vol.shape[:3], (pd, ph, pw), tile_step_size, k)
    for i in range(0, len(rows), k):
        step = rows[i:i + k]
        with span("rehrseg.segment.tile"):
            count("serve.tiles", sum(r[3] for r in step))
            with span("rehrseg.segment.mirror"):
                batch = _mirror_blocks(vol, [r[:3] for r in step], combos,
                                       (pd, ph, pw), groups)
            with span("rehrseg.segment.forward"):
                # every row enqueued first; each row's heads as HBlocks
                outs = [model_fn(b) for b in batch]
            outs = [o if isinstance(o, tuple) else (o,) for o in outs]
            if i == 0:
                _record("tile", batch[0])
                for h, z in enumerate(z_scales):
                    _record(f"tile_logits_x{z}", outs[0][h])
            with span("rehrseg.segment.accumulate"):
                for h, z in enumerate(z_scales):
                    _accumulate_blocks(accs[h], weights if h == 0 else None,
                                       [o[h] for o in outs], step, combos,
                                       gs[h], z, (pd, ph, pw))
    return accs, weights


def _labels(logits):
    """The uint8 argmax of the logits, block by block on each block's
    device for an HBlocks (recorded as ``labels``)."""
    if isinstance(logits, HBlocks):
        return _record("labels", spatial.local(_argmax_uint8, logits))
    return _argmax_uint8(logits)


@torch.no_grad()
def _run_sliding_window(model_fn: Callable, data: np.ndarray, patch_size,
                        slice_separation, tile_step_size, use_gaussian,
                        mirror, num_classes, input_dtype=torch.bfloat16,
                        need_weights: bool = True, device=None,
                        tiles_per_step: int = 1, rows=None, tta_mesh=None):
    """The tile loop; returns (logits (D*sep, H, W, C) fp32, weights or
    None) on the device. need_weights=False skips the weight accumulator:
    argmax(logits / weights) == argmax(logits) since the weights are
    strictly positive. tiles_per_step: k tiles' mirror stacks go through
    one forward of batch k * n_tta; the padded rows (valid = 0) of the last
    forward add nothing. rows: the (sx, sy, sz, valid) tile starts, by
    default the parity grid of ``data``'s own shape (a streamed slab passes
    the whole volume's grid rows that fall in it). tta_mesh: a
    :class:`..parallel.mesh.Mesh` whose 'data' axis splits each forward's
    mirror batch (k tiles x n_tta flips) into contiguous blocks, one per
    data row (``P("data", None, "spatial")`` in the JAX engine);
    ``model_fn`` runs each block on its row (H-sharded over the row's
    devices when the 'spatial' extent is above 1), the outputs come back
    to ``device`` and are unmirrored in the same order as without a
    mesh. With a 'spatial' extent above 1 the volume, the accumulators
    and each tile's logits stay in even H blocks over the first data
    row's group (:func:`_run_h_sharded`), and both come back as HBlocks."""
    if _h_sharded(tta_mesh):
        (logits,), weights = _run_h_sharded(
            model_fn, data, patch_size, [int(slice_separation)],
            tile_step_size, use_gaussian, mirror, num_classes, input_dtype,
            need_weights, rows, tiles_per_step, tta_mesh)
        return logits, weights
    device = resolve_device(device)
    pd, ph, pw = (int(p) for p in patch_size)
    z_scale = int(slice_separation)
    od = pd * z_scale
    k = int(tiles_per_step)
    g = _gaussian((od, ph, pw), bool(use_gaussian), device)
    combos = _flip_axes_combinations(3) if mirror else [()]
    n_tta = len(combos)
    mesh_groups = _mesh_groups(tta_mesh, k * n_tta)
    vol = _upload(data, input_dtype, device)
    out_shape = (vol.shape[0] * z_scale, vol.shape[1], vol.shape[2])
    logits = torch.zeros((*out_shape, num_classes), dtype=torch.float32,
                         device=device)
    weights = (torch.zeros(out_shape, dtype=torch.float32, device=device)
               if need_weights else None)
    if rows is None:
        rows = _padded_starts(vol.shape[:3], (pd, ph, pw), tile_step_size,
                              k)
    for i in range(0, len(rows), k):
        group = rows[i:i + k]
        with span("rehrseg.segment.tile"):
            count("serve.tiles", sum(r[3] for r in group))
            with span("rehrseg.segment.mirror"):
                stacks = [_mirror_batch(
                    vol[sx:sx + pd, sy:sy + ph, sz:sz + pw], combos)
                    for sx, sy, sz, _ in group]
                batch = stacks[0] if k == 1 else torch.cat(stacks)
            with span("rehrseg.segment.forward"):
                preds = _sharded_forward(model_fn, batch, mesh_groups)
            with span("rehrseg.segment.accumulate"):
                for j, (sx, sy, sz, valid) in enumerate(group):
                    if not valid:
                        continue
                    pred = _unmirror_mean(preds[j * n_tta:(j + 1) * n_tta],
                                          combos).float() * g[..., None]
                    zo = sx * z_scale
                    logits[zo:zo + od, sy:sy + ph, sz:sz + pw] += pred
                    if need_weights:
                        weights[zo:zo + od, sy:sy + ph, sz:sz + pw] += g
    return logits, weights


def predict_sliding_window_logits(model_fn: Callable, data: np.ndarray,
                                  patch_size: Sequence[int], *,
                                  slice_separation: int = 1,
                                  tile_step_size: float = 0.5,
                                  use_gaussian: bool = True,
                                  mirror: bool = True,
                                  num_classes: int = 2,
                                  input_dtype=torch.bfloat16,
                                  device=None,
                                  tiles_per_step: int = 1,
                                  tta_mesh=None) -> np.ndarray:
    """Full sliding-window prediction of one volume. model_fn maps
    (B, pd, ph, pw, C) -> (B, pd*slice_separation, ph, pw, num_classes).
    data: (D, H, W, C) numpy, already normalized. Returns
    (D*slice_separation, H, W, num_classes) fp32 logits. tta_mesh: the
    mirror batch split over the mesh's 'data' devices
    (:func:`_run_sliding_window`); ``device`` defaults to its first."""
    logits, weights = _run_sliding_window(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype,
        device=_mesh_home(tta_mesh, device), tiles_per_step=tiles_per_step,
        tta_mesh=tta_mesh)
    # divided on the device (block by block), joined on the host
    logits = _to_host([spatial.local(lambda lg, wt: lg / wt[..., None],
                                     logits, weights)])[0]
    if np.any(np.isinf(logits)):
        raise RuntimeError("Encountered inf in predicted array.")
    return logits


def _labels_on_device(model_fn, data, patch_size, slice_separation=1,
                      tile_step_size=0.5, use_gaussian=True, mirror=True,
                      num_classes=2, input_dtype=torch.bfloat16, device=None,
                      tiles_per_step=1, tta_mesh=None) -> torch.Tensor:
    """The parity grid's uint8 label map of ``data`` on the device
    (nothing waits)."""
    logits, _ = _run_sliding_window(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, need_weights=False,
        device=_mesh_home(tta_mesh, device), tiles_per_step=tiles_per_step,
        tta_mesh=tta_mesh)
    return _labels(logits)


def predict_sliding_window_labels(model_fn: Callable, data: np.ndarray,
                                  patch_size: Sequence[int], *,
                                  slice_separation: int = 1,
                                  tile_step_size: float = 0.5,
                                  use_gaussian: bool = True,
                                  mirror: bool = True,
                                  num_classes: int = 2,
                                  input_dtype=torch.bfloat16,
                                  device=None,
                                  tiles_per_step: int = 1,
                                  tta_mesh=None) -> np.ndarray:
    """Like :func:`predict_sliding_window_logits` but returns the uint8
    argmax label map (D*slice_separation, H, W). tta_mesh: the mirror
    batch split over the mesh's 'data' devices."""
    return _to_host([_labels_on_device(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, device,
        tiles_per_step, tta_mesh)])[0]


def predict_sliding_window_labels_many(model_fn: Callable, volumes,
                                       patch_size, *,
                                       slice_separation: int = 1,
                                       tile_step_size: float = 0.5,
                                       use_gaussian: bool = True,
                                       mirror: bool = True,
                                       num_classes: int = 2,
                                       input_dtype=torch.bfloat16,
                                       device=None,
                                       tiles_per_step: int = 1,
                                       tta_mesh=None):
    """Label maps of many volumes, in order. Every volume's tiles and
    argmax are enqueued before any label map is fetched, so one volume's
    upload and the fetches overlap the card's work on the others.
    tta_mesh: as in :func:`predict_sliding_window_labels`."""
    return _to_host([_labels_on_device(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, device,
        tiles_per_step, tta_mesh) for data in volumes])


@torch.no_grad()
def _dual_logits(model_fn: Callable, data: np.ndarray, patch_size,
                 slice_separation, tile_step_size, use_gaussian, mirror,
                 num_classes, input_dtype, device, rows=None, tta_mesh=None):
    """Dual-head tile loop: model_fn returns (lr_pred, hr_pred); both
    heads accumulate in one pass. Returns (LR, HR) logits on the device.
    rows: tile starts as in :func:`_run_sliding_window`; tta_mesh: each
    mirror batch split over the mesh as there (both accumulators HBlocks
    with a 'spatial' extent above 1)."""
    if _h_sharded(tta_mesh):
        return tuple(_run_h_sharded(
            model_fn, data, patch_size, [1, int(slice_separation)],
            tile_step_size, use_gaussian, mirror, num_classes, input_dtype,
            False, rows, 1, tta_mesh)[0])
    device = resolve_device(_mesh_home(tta_mesh, device))
    pd, ph, pw = (int(p) for p in patch_size)
    sep = int(slice_separation)
    g_lr = _gaussian((pd, ph, pw), bool(use_gaussian), device)
    g_hr = _gaussian((pd * sep, ph, pw), bool(use_gaussian), device)
    combos = _flip_axes_combinations(3) if mirror else [()]
    mesh_groups = _mesh_groups(tta_mesh, len(combos))
    vol = _upload(data, input_dtype, device)
    d, h, w = vol.shape[:3]
    llr = torch.zeros((d, h, w, num_classes), dtype=torch.float32,
                      device=device)
    lhr = torch.zeros((d * sep, h, w, num_classes), dtype=torch.float32,
                      device=device)
    if rows is None:
        rows = sliding_window_starts((d, h, w), (pd, ph, pw),
                                     tile_step_size).tolist()
    for sx, sy, sz, *_ in rows:
        with span("rehrseg.segment.tile"):
            count("serve.tiles")
            with span("rehrseg.segment.mirror"):
                batch = _mirror_batch(vol[sx:sx + pd, sy:sy + ph, sz:sz + pw],
                                      combos)
            with span("rehrseg.segment.forward"):
                p_lr, p_hr = _sharded_forward(model_fn, batch, mesh_groups)
            with span("rehrseg.segment.accumulate"):
                pred_lr = _unmirror_mean(p_lr, combos).float()
                pred_hr = _unmirror_mean(p_hr, combos).float()
                llr[sx:sx + pd, sy:sy + ph, sz:sz + pw] += \
                    pred_lr * g_lr[..., None]
                zo = sx * sep
                lhr[zo:zo + pd * sep, sy:sy + ph, sz:sz + pw] += \
                    pred_hr * g_hr[..., None]
    return llr, lhr


def predict_sliding_window_dual_labels(model_fn: Callable, data: np.ndarray,
                                       patch_size, *, slice_separation: int,
                                       tile_step_size: float = 0.5,
                                       use_gaussian: bool = True,
                                       mirror: bool = True,
                                       num_classes: int = 2,
                                       input_dtype=torch.bfloat16,
                                       device=None, tta_mesh=None):
    """One-pass LR+HR prediction: returns (lr_labels, hr_labels) uint8.
    model_fn(batch) -> (lr_logits, hr_logits), HR z-upscaled by
    slice_separation. tta_mesh: as in
    :func:`predict_sliding_window_labels`."""
    llr, lhr = _dual_logits(model_fn, data, patch_size, slice_separation,
                            tile_step_size, use_gaussian, mirror,
                            num_classes, input_dtype, device,
                            tta_mesh=tta_mesh)
    return tuple(_to_host([_labels(llr), _labels(lhr)]))


# ------------------------------------------------------------ streamed slabs

def _slabs(image_size, patch_size, tile_step_size, z_slab_tiles: int):
    """(z_lo, z_hi, rows) per slab: ``z_slab_tiles`` consecutive z-starts of
    the WHOLE volume's parity grid, the slab [z_lo, z_hi) they cover and
    their (sz - z_lo, sy, sx, 1) rows (a grid computed on the slab's own
    shape would place other tiles)."""
    pd = int(patch_size[0])
    z_starts, y_steps, x_steps = compute_steps_for_sliding_window(
        image_size, patch_size, tile_step_size)
    for g0 in range(0, len(z_starts), z_slab_tiles):
        group = z_starts[g0:g0 + z_slab_tiles]
        z_lo = group[0]
        rows = [(sz - z_lo, sy, sx, 1) for sz in group for sy in y_steps
                for sx in x_steps]
        yield z_lo, group[-1] + pd, rows


def predict_sliding_window_labels_streamed(model_fn: Callable,
                                           data: np.ndarray, patch_size, *,
                                           z_slab_tiles: int = 2,
                                           tile_step_size: float = 0.5,
                                           use_gaussian: bool = True,
                                           mirror: bool = True,
                                           num_classes: int = 2,
                                           input_dtype=torch.bfloat16,
                                           device=None) -> np.ndarray:
    """Sliding-window labels with the volume streamed in z-slabs, for
    volumes whose accumulators do not fit on the device: each group of
    ``z_slab_tiles`` z-rows of tiles forms a slab that is uploaded alone,
    run with slab-sized fp32 accumulators on the device, fetched and added
    into host fp32 logits at its z offset. Returns the (D, H, W) uint8
    argmax, taken on the host."""
    patch_size = tuple(int(p) for p in patch_size)
    d, h, w = data.shape[:3]
    logits_host = np.zeros((d, h, w, num_classes), dtype=np.float32)
    for z_lo, z_hi, rows in _slabs((d, h, w), patch_size, tile_step_size,
                                   int(z_slab_tiles)):
        logits, _ = _run_sliding_window(
            model_fn, data[z_lo:z_hi], patch_size, 1, tile_step_size,
            use_gaussian, mirror, num_classes, input_dtype,
            need_weights=False, device=device, rows=rows)
        logits_host[z_lo:z_hi] += logits.cpu().numpy()
        del logits      # free this slab's accumulator before the next's
    return np.argmax(logits_host, axis=-1).astype(np.uint8)


def predict_sliding_window_dual_labels_streamed(
        model_fn: Callable, data: np.ndarray, patch_size, *,
        slice_separation: int, z_slab_tiles: int = 2,
        tile_step_size: float = 0.5, use_gaussian: bool = True,
        mirror: bool = True, num_classes: int = 2,
        input_dtype=torch.bfloat16, device=None):
    """Streamed LR+HR labels: slabs as in
    :func:`predict_sliding_window_labels_streamed`; each slab keeps LR and
    HR accumulators on the device, added into host fp32 buffers at z_lo and
    at z_lo * slice_separation. Returns (lr_labels, hr_labels) uint8."""
    patch_size = tuple(int(p) for p in patch_size)
    sep = int(slice_separation)
    d, h, w = data.shape[:3]
    llr_host = np.zeros((d, h, w, num_classes), dtype=np.float32)
    lhr_host = np.zeros((d * sep, h, w, num_classes), dtype=np.float32)
    for z_lo, z_hi, rows in _slabs((d, h, w), patch_size, tile_step_size,
                                   int(z_slab_tiles)):
        llr, lhr = _dual_logits(model_fn, data[z_lo:z_hi], patch_size, sep,
                                tile_step_size, use_gaussian, mirror,
                                num_classes, input_dtype, device, rows=rows)
        llr_host[z_lo:z_hi] += llr.cpu().numpy()
        lhr_host[z_lo * sep:z_hi * sep] += lhr.cpu().numpy()
        del llr, lhr    # free this slab's accumulators before the next's
    return (np.argmax(llr_host, -1).astype(np.uint8),
            np.argmax(lhr_host, -1).astype(np.uint8))


# --------------------------------------------------------------- aligned grid

_ALIGN_HW = (8, 128)


def aligned_sliding_window_starts(image_size, patch_size,
                                  tile_step_size=0.5):
    """Aligned tile grid. Returns (starts (N, 4) int32 rows of
    (sx, sy, sz, valid), padded_size (D, H', W')). Raises ValueError where
    snapping cannot cover every voxel (a patch narrower than the snap on a
    multi-tile axis)."""
    steps = compute_steps_for_sliding_window(image_size, patch_size,
                                             tile_step_size)
    out_steps = [list(steps[0])]
    padded = [int(image_size[0])]
    for dim, snap in zip((1, 2), _ALIGN_HW):
        n = len(steps[dim])
        if n == 1:
            out_steps.append([0])
            padded.append(int(image_size[dim]))
            continue
        span = image_size[dim] - patch_size[dim]
        span_pad = -(-span // snap) * snap
        actual = span_pad / (n - 1)
        ss = [int(np.round(actual * i / snap)) * snap for i in range(n)]
        ss[-1] = span_pad
        ss = sorted(set(ss))
        # coverage guard: rebuild the axis with the widest aligned step
        # that still covers when snapping opened a gap wider than the patch
        if any(b - a > patch_size[dim] for a, b in zip(ss, ss[1:])):
            max_step = patch_size[dim] // snap * snap
            if max_step == 0:
                raise ValueError(
                    f"aligned tile grid needs patch_size[{dim}] "
                    f"({patch_size[dim]}) >= its snap ({snap}) when the "
                    f"axis takes more than one tile; use the parity grid")
            ss = sorted(set(list(range(0, span_pad, max_step))
                            + [span_pad]))
        out_steps.append(ss)
        padded.append(int(patch_size[dim] + span_pad))
    starts = [(sx, sy, sz, 1) for sx in out_steps[0] for sy in out_steps[1]
              for sz in out_steps[2]]
    return np.asarray(starts, dtype=np.int32), tuple(padded)


def _mirror_batch_zgrouped(tile: torch.Tensor) -> torch.Tensor:
    return _mirror_batch(tile, zgrouped_combos())


def _aligned_prep(data, patch_size, tile_step_size, input_dtype, device):
    patch_size = tuple(int(p) for p in patch_size)
    with span("rehrseg.segment.prep"):
        starts, padded = aligned_sliding_window_starts(
            data.shape[:3], patch_size, tile_step_size)
        pads = [(0, padded[i] - data.shape[i]) for i in range(3)]
        if any(p[1] for p in pads):
            data = np.pad(data, pads + [(0, 0)])
    return _upload(data, input_dtype, device), starts.tolist(), patch_size


@torch.no_grad()
def _aligned_logits(model_fn: Callable, data: np.ndarray, patch_size, *,
                    slice_separation: int = 0, tile_step_size: float = 0.5,
                    use_gaussian: bool = True, num_classes: int = 2,
                    input_dtype=torch.bfloat16, device=None):
    """Aligned-grid tile loop over the padded volume; K2 accumulates each
    tile. slice_separation=0: LR only, model_fn returns planes (8, C, pd,
    ph, pw) and this returns the (C, D, H', W') logits; > 0: dual,
    model_fn returns (lr_planes, hr_planes) and this returns both
    accumulators, the HR one (C, D*sep, H', W')."""
    device = resolve_device(device)
    vol, starts, (pd, ph, pw) = _aligned_prep(data, patch_size,
                                              tile_step_size, input_dtype,
                                              device)
    shape = tuple(vol.shape[:3])
    sep = int(slice_separation)
    g_lr = _gaussian((pd, ph, pw), bool(use_gaussian), device)
    llr = torch.zeros((num_classes, *shape), dtype=torch.float32,
                      device=device)
    if sep:
        g_hr = _gaussian((pd * sep, ph, pw), bool(use_gaussian), device)
        lhr = torch.zeros((num_classes, shape[0] * sep, *shape[1:]),
                          dtype=torch.float32, device=device)
    for row in starts:
        sx, sy, sz = row[:3]
        with span("rehrseg.segment.tile"):
            count("serve.tiles")
            with span("rehrseg.segment.mirror"):
                batch = _mirror_batch_zgrouped(vol[sx:sx + pd, sy:sy + ph,
                                                   sz:sz + pw])
            with span("rehrseg.segment.forward"):
                out = model_fn(batch)
            with span("rehrseg.segment.accumulate"):
                lr = (out[0] if sep else out).contiguous()
                # K2 rounds the gaussian to the preds' dtype: cast it once,
                # at the first tile (a no-op from then on), not in every call
                g_lr = g_lr.to(lr.dtype)
                accumulate_tta_tile(llr, lr, g_lr, row, z_scale=1)
                if sep:
                    hr = out[1].contiguous()
                    g_hr = g_hr.to(hr.dtype)
                    accumulate_tta_tile(lhr, hr, g_hr, row, z_scale=sep)
    return (llr, lhr) if sep else llr


def _aligned_labels_on_device(model_fn: Callable, data: np.ndarray,
                              patch_size, **kw) -> torch.Tensor:
    """The aligned grid's uint8 label map of ``data`` on the device, still
    padded to the grid (nothing waits); ``kw`` as :func:`_aligned_logits`
    takes them."""
    return _argmax_uint8(_aligned_logits(model_fn, data, patch_size, **kw),
                         0)


def predict_sliding_window_labels_aligned(model_fn: Callable,
                                          data: np.ndarray, patch_size, *,
                                          tile_step_size: float = 0.5,
                                          use_gaussian: bool = True,
                                          num_classes: int = 2,
                                          input_dtype=torch.bfloat16,
                                          device=None) -> np.ndarray:
    """Aligned-grid label prediction (always 8-way mirror TTA). model_fn
    emits per-class planes. Returns (D, H, W) uint8 cropped to the input
    size."""
    return predict_sliding_window_labels_aligned_many(
        model_fn, [data], patch_size, tile_step_size=tile_step_size,
        use_gaussian=use_gaussian, num_classes=num_classes,
        input_dtype=input_dtype, device=device)[0]


def predict_sliding_window_labels_aligned_many(
        model_fn: Callable, volumes, patch_size, *,
        tile_step_size: float = 0.5, use_gaussian: bool = True,
        num_classes: int = 2, input_dtype=torch.bfloat16, device=None):
    """Aligned-grid label maps of many volumes, in order; like
    :func:`predict_sliding_window_labels_many`, every volume is enqueued
    before the first fetch."""
    labels = [_aligned_labels_on_device(
        model_fn, data, patch_size, tile_step_size=tile_step_size,
        use_gaussian=use_gaussian, num_classes=num_classes,
        input_dtype=input_dtype, device=device) for data in volumes]
    return [lab[:d, :h, :w] for lab, (d, h, w) in zip(
        _to_host(labels), (v.shape[:3] for v in volumes))]


def predict_sliding_window_dual_labels_aligned(
        model_fn: Callable, data: np.ndarray, patch_size, *,
        slice_separation: int, tile_step_size: float = 0.5,
        use_gaussian: bool = True, num_classes: int = 2,
        input_dtype=torch.bfloat16, device=None):
    """One-pass aligned-grid LR+HR prediction with K2 on both heads.
    model_fn returns (lr_planes, hr_planes). Returns (lr_labels,
    hr_labels) uint8 cropped to the input size."""
    d0, h0, w0 = data.shape[:3]
    sep = int(slice_separation)
    llr, lhr = _aligned_logits(model_fn, data, patch_size,
                               slice_separation=sep,
                               tile_step_size=tile_step_size,
                               use_gaussian=use_gaussian,
                               num_classes=num_classes,
                               input_dtype=input_dtype, device=device)
    lr, hr = _to_host([_argmax_uint8(llr, 0), _argmax_uint8(lhr, 0)])
    return lr[:d0, :h0, :w0], hr[:d0 * sep, :h0, :w0]


def evaluate_case_volume(model_fn: Callable, volume: np.ndarray,
                         label: np.ndarray | None, patch_size, *,
                         slice_separation: int = 1,
                         hr_model_fn: Callable | None = None,
                         dual_model_fn: Callable | None = None,
                         tile_step_size: float = 0.5,
                         mirror: bool = True, num_classes: int = 2,
                         device=None):
    """Sliding-window evaluation of one (D, H, W) volume: z-score, pad to
    at least the patch, LR labels on the parity grid, padding cropped,
    dice against ``label``. With ``dual_model_fn`` one pass gives the LR
    and the HR labels; else with ``hr_model_fn`` a second pass gives the
    HR labels; else the HR labels are the LR ones. HR labels are cropped
    by the z-pads times ``slice_separation``.

    Returns (pred_lr, pred_hr, dice_lr); dice_lr is None without a label.
    """
    vol = zscore_normalization(volume)[..., None]  # (D, H, W, 1)
    target_shape = [max(s, p) for s, p in zip(vol.shape[:3], patch_size)]
    vol_p, pads = target_pad(vol, target_shape + [1], mode="constant")
    sep = int(slice_separation)
    hr_pads = ((pads[0][0] * sep, pads[0][1] * sep),) + tuple(pads[1:3])
    common = dict(tile_step_size=tile_step_size, use_gaussian=True,
                  mirror=mirror, num_classes=num_classes, device=device)

    if dual_model_fn is not None:
        pred_lr_full, pred_hr_full = predict_sliding_window_dual_labels(
            dual_model_fn, vol_p, patch_size, slice_separation=sep, **common)
        pred_lr = crop(pred_lr_full, pads[:3])
        pred_hr = crop(pred_hr_full, hr_pads)
    else:
        pred_lr = crop(predict_sliding_window_labels(
            model_fn, vol_p, patch_size, slice_separation=1, **common),
            pads[:3])
        pred_hr = pred_lr
        if hr_model_fn is not None:
            pred_hr = crop(predict_sliding_window_labels(
                hr_model_fn, vol_p, patch_size, slice_separation=sep,
                **common), hr_pads)
    dice_lr = (calculate_dice(pred_lr, label.astype(np.uint8))
               if label is not None else None)
    return pred_lr, pred_hr, dice_lr
