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
device (the Segmenter keeps one weight replica per distinct device); with
a 'spatial' extent above 1 the block goes to ``model_fn`` as an
:class:`..parallel.spatial.HBlocks`, its tile's H split over the row's
devices, and the forward runs H-sharded (halo exchanges, moment sums)
and hands back its logits gathered on the row's first device. The
accumulators stay whole on the mesh's first device (the JAX engine shards
them along H too).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.normalize import zscore_normalization
from ..losses import calculate_dice
from ..ops.gaussian import compute_gaussian
from ..ops.tail import accumulate_tta_tile, zgrouped_combos
from ..parallel import spatial
from ..utils.device import resolve_device
from ..utils.pad import crop, target_pad


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


def _unmirror_mean(preds: torch.Tensor, combos) -> torch.Tensor:
    """Invert each flip and average over the TTA batch (in preds' dtype,
    summed in combo order, as the JAX engine does)."""
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
    t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=input_dtype or torch.float32)


def _argmax_uint8(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The uint8 label map, on the logits' device (nothing waits)."""
    return logits.argmax(dim).to(torch.uint8)


def _to_host(labels: Sequence[torch.Tensor]) -> list:
    """Label maps as numpy arrays. From the card: one non-blocking copy
    into pinned host memory per map, then one wait for all of them, before
    any array is handed back."""
    if not labels or labels[0].device.type != "cuda":
        return [t.numpy() for t in labels]
    host = []
    for t in labels:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    torch.cuda.current_stream(labels[0].device).synchronize()
    return [h.numpy() for h in host]


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


def _mesh_home(tta_mesh, device):
    """The accumulators' device: ``device``, else the mesh's first."""
    if device is None and tta_mesh is not None:
        return tta_mesh.first
    return device


def _sharded_forward(model_fn: Callable, batch: torch.Tensor, groups):
    """The forward of ``batch`` split into len(groups) contiguous blocks in
    flip order, block i run on groups[i] (on its first device, or H-split
    over the group as an HBlocks when it holds several), the outputs (a
    tensor or a tuple of them) gathered back on the batch's device in
    order. Every block is enqueued before any output is copied back, so
    blocks on distinct cards run side by side."""
    if groups is None:
        return model_fn(batch)
    outs = []
    for block, group in zip(batch.chunk(len(groups)), groups):
        block = block.to(group[0], non_blocking=True)
        outs.append(model_fn(block if len(group) == 1
                             else spatial.split(block, group)))

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
    mesh."""
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
        stacks = [_mirror_batch(vol[sx:sx + pd, sy:sy + ph, sz:sz + pw],
                                combos) for sx, sy, sz, _ in group]
        preds = _sharded_forward(
            model_fn, stacks[0] if k == 1 else torch.cat(stacks),
            mesh_groups)
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
    logits = (logits / weights[..., None]).cpu().numpy()
    if np.any(np.isinf(logits)):
        raise RuntimeError("Encountered inf in predicted array.")
    return logits


def _labels_on_device(model_fn, data, patch_size, slice_separation,
                      tile_step_size, use_gaussian, mirror, num_classes,
                      input_dtype, device, tiles_per_step,
                      tta_mesh=None) -> torch.Tensor:
    logits, _ = _run_sliding_window(
        model_fn, data, patch_size, slice_separation, tile_step_size,
        use_gaussian, mirror, num_classes, input_dtype, need_weights=False,
        device=_mesh_home(tta_mesh, device), tiles_per_step=tiles_per_step,
        tta_mesh=tta_mesh)
    return _argmax_uint8(logits)


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
    mirror batch split over the mesh as there."""
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
        tile = vol[sx:sx + pd, sy:sy + ph, sz:sz + pw]
        p_lr, p_hr = _sharded_forward(model_fn, _mirror_batch(tile, combos),
                                      mesh_groups)
        pred_lr = _unmirror_mean(p_lr, combos).float()
        pred_hr = _unmirror_mean(p_hr, combos).float()
        llr[sx:sx + pd, sy:sy + ph, sz:sz + pw] += pred_lr * g_lr[..., None]
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
    return tuple(_to_host([_argmax_uint8(llr), _argmax_uint8(lhr)]))


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
        batch = _mirror_batch_zgrouped(vol[sx:sx + pd, sy:sy + ph,
                                           sz:sz + pw])
        out = model_fn(batch)
        lr = (out[0] if sep else out).contiguous()
        # K2 rounds the gaussian to the preds' dtype: cast it once, at the
        # first tile (a no-op from then on), not in every call
        g_lr = g_lr.to(lr.dtype)
        accumulate_tta_tile(llr, lr, g_lr, row, z_scale=1)
        if sep:
            hr = out[1].contiguous()
            g_hr = g_hr.to(hr.dtype)
            accumulate_tta_tile(lhr, hr, g_hr, row, z_scale=sep)
    return (llr, lhr) if sep else llr


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
    labels = [_argmax_uint8(_aligned_logits(
        model_fn, data, patch_size, tile_step_size=tile_step_size,
        use_gaussian=use_gaussian, num_classes=num_classes,
        input_dtype=input_dtype, device=device), 0)
        for data in volumes]
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
