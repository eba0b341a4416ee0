"""Stage-1 SR volume inference (``rehrseg_tpu.infer.sr_infer``; reference
utils/sr_utils.py:20-304).

  - :func:`infer_wdsr_volume`: the 2D WDSR over every x-slice of a (x, y,
    z, c) volume, upsampling the thin z axis, in chunks of ``batch``
    slices;
  - :func:`infer_flavr_volume`: FLAVR over the 4-slice z-windows of the
    zero-padded volume (sr_utils.py:115-125), H and W zero-padded to
    multiples of 16 for the encoder's strides; the output has 4 * (z - 1)
    slices, the reference's concatenation (sr_utils.py:133). The resident
    path uploads the volume once, gathers the windows on the device by
    index, runs chunks of ``batch`` windows (the last chunk zero-padded to
    ``batch``, as the JAX package does) and fetches once; the host loop
    (``resident=False``) uploads each chunk of windows, the oracle.
    :func:`infer_flavr_volume_async` returns a ``finalize()`` over work
    already enqueued on the device.

These functions take the module (it holds its weights), not params; the
module is moved to ``device`` (default the card), and with
``compute_dtype`` the forward runs a copy of it cast to that dtype. The JAX
package's jit caches have no counterpart: nothing is compiled per call.

:func:`postprocess_sr_volume` makes the blurred copies of a pseudo-HR
image that stage-1 training reads as its LR sources;
:func:`interpolate_pseudo_sr` is the pseudo-HR volume without SMORE
(``smore_initialization: false``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..io.volume import inv_normalize
from ..ops.blur import blur_axis_np, parse_kernel
from ..ops.bspline import zoom_axis_np
from ..utils.device import resolve_device
from ..utils.patch import calc_slices_to_crop, find_integer_p


def _pad_z_for_rational_sr(vol: np.ndarray, slice_separation: float):
    """Reflect-pad z so the rational SR factor lands on the ideal slice
    count (sr_utils.py:46-48). vol: (..., z, c) with z at axis -2."""
    n = vol.shape[-2]
    n_pad = find_integer_p(n, slice_separation)
    n_crop = calc_slices_to_crop(n_pad, slice_separation)
    if n_pad:
        pads = [(0, 0)] * vol.ndim
        pads[-2] = (0, n_pad)
        vol = np.pad(vol, pads, mode="reflect")
    return vol, n_crop


def _module_on(model, device, compute_dtype):
    """(module, dtype): ``model`` moved to ``device``; a copy cast to
    ``compute_dtype`` when that differs from the module's own dtype."""
    model.to(device)
    dtype = next(model.parameters()).dtype
    if compute_dtype is not None and compute_dtype != dtype:
        model, dtype = copy.deepcopy(model).to(compute_dtype), compute_dtype
    return model.eval(), dtype


def _forward(model, batch, out_index):
    out = model(batch)
    if isinstance(out, tuple):
        out = out[out_index]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """Fetch (in the tensor's dtype) and widen to fp32 on the host."""
    return t.cpu().float().numpy()


def _pad_to_batch(x, batch: int):
    """Zero-pad axis 0 to a multiple of ``batch`` (numpy or torch)."""
    pad_n = (-x.shape[0]) % batch
    if not pad_n:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.zeros((pad_n, *x.shape[1:]), x.dtype)])
    return torch.cat([x, x.new_zeros((pad_n, *x.shape[1:]))])


@torch.no_grad()
def infer_wdsr_volume(model, volume: np.ndarray, slice_separation: float,
                      batch: int = 8, device=None) -> np.ndarray:
    """volume: (x, y, z, c) with thin z. Returns (x, y, z*sep, c) fp32.
    Each x-slice is a (z, y, c) image whose first axis WDSR upsamples."""
    device = resolve_device(device)
    model, dtype = _module_on(model, device, None)
    vol, n_crop = _pad_z_for_rational_sr(volume, slice_separation)
    x_slices = vol.transpose(0, 2, 1, 3)  # (x, z, y, c)
    nx = x_slices.shape[0]
    x_slices = _pad_to_batch(x_slices, batch)
    outs = []
    for st in range(0, x_slices.shape[0], batch):
        chunk = torch.from_numpy(np.ascontiguousarray(
            x_slices[st:st + batch], dtype=np.float32))
        outs.append(_host(model(chunk.to(device=device, dtype=dtype))))
    out = np.concatenate(outs, axis=0)[:nx]  # (x, z*sep, y, c)
    if n_crop:
        out = out[:, :-n_crop]
    return out.transpose(0, 2, 1, 3)  # (x, y, z*sep, c)


def flavr_windows(vol_zhw: np.ndarray) -> np.ndarray:
    """(z, H, W, C) -> (z-1, 4, H, W, C) zero-padded 4-slice windows
    (sr_utils.py:115-125)."""
    z = vol_zhw.shape[0]
    padded = np.concatenate([
        np.zeros((1, *vol_zhw.shape[1:]), vol_zhw.dtype), vol_zhw,
        np.zeros((1, *vol_zhw.shape[1:]), vol_zhw.dtype)], axis=0)
    idx = np.arange(z - 1)[:, None] + np.arange(4)[None]
    return padded[idx]


def _flavr_prep(volume, slice_separation):
    """(vol_zhw (z, H16, W16, c), x, y, z, n_crop): the rational z pad, z
    first, H and W zero-padded to multiples of 16."""
    vol, n_crop = _pad_z_for_rational_sr(volume, slice_separation)
    x, y, z, _ = vol.shape
    vol_zhw = vol.transpose(2, 0, 1, 3)  # (z, H=x, W=y, c)
    pad_h, pad_w = (-x) % 16, (-y) % 16
    if pad_h or pad_w:
        vol_zhw = np.pad(vol_zhw, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    return vol_zhw, x, y, z, n_crop


def _flavr_finish(out: np.ndarray, x, y, n_crop) -> np.ndarray:
    """(windows, n_out, H16, W16, c) -> (x, y, z_out, c): windows' slices
    in order, the x16 padding and the rational pad's slices cropped."""
    out = out[:, :, :x, :y]
    out = out.reshape(-1, x, y, out.shape[-1])
    if n_crop:
        out = out[:-n_crop]
    return out.transpose(1, 2, 0, 3)


@torch.no_grad()
def _dispatch_volume_forward(model, vol_zhw, out_index, batch, dtype,
                             device) -> torch.Tensor:
    """The resident forward, enqueued: the volume uploaded once, the
    windows gathered on the device by index, chunks of ``batch`` windows
    through the module. Returns the (z-1, n_out, H, W, c_out) output on the
    device."""
    vol = torch.from_numpy(np.ascontiguousarray(vol_zhw, dtype=np.float32))
    if device.type == "cuda":
        vol = vol.pin_memory().to(device, non_blocking=True)
    vol = vol.to(device=device, dtype=dtype)
    z = vol.shape[0]
    padded = torch.cat([vol.new_zeros((1, *vol.shape[1:])), vol,
                        vol.new_zeros((1, *vol.shape[1:]))])
    idx = (torch.arange(z - 1, device=device)[:, None]
           + torch.arange(4, device=device)[None])
    windows = _pad_to_batch(padded[idx], batch)  # (nw + pad, 4, H, W, c)
    outs = [_forward(model, windows[st:st + batch], out_index)
            for st in range(0, windows.shape[0], batch)]
    return torch.cat(outs)[:z - 1]


def infer_flavr_volume_async(model, volume: np.ndarray,
                             slice_separation: float,
                             out_index: int | None = None, batch: int = 8,
                             compute_dtype=None, device=None):
    """The resident path of :func:`infer_flavr_volume`, enqueued: returns
    ``finalize() -> (x, y, z_out, c_out)``, which fetches. A caller can
    prepare the next volume while the device works on this one."""
    device = resolve_device(device)
    model, dtype = _module_on(model, device, compute_dtype)
    vol_zhw, x, y, _, n_crop = _flavr_prep(volume, slice_separation)
    pending = _dispatch_volume_forward(model, vol_zhw, out_index or 0,
                                       batch, dtype, device)

    def finalize():
        return _flavr_finish(_host(pending), x, y, n_crop)

    return finalize


@torch.no_grad()
def infer_flavr_volume(model, volume: np.ndarray, slice_separation: float,
                       out_index: int | None = None, batch: int = 8,
                       resident: bool = True, compute_dtype=None,
                       device=None) -> np.ndarray:
    """volume: (x, y, z, c). Returns (x, y, 4*(z_pad-1), c_out) fp32, c_out
    of the selected model output (0 = SR image + label, 1 = uncertainty).

    resident=True (default) uploads the volume once and gathers the
    windows on the device; resident=False is the host-loop oracle (each
    chunk of windows uploaded, the same output). compute_dtype: the forward
    runs in it (e.g. torch.bfloat16); None keeps the module's dtype."""
    if resident:
        return infer_flavr_volume_async(
            model, volume, slice_separation, out_index=out_index,
            batch=batch, compute_dtype=compute_dtype, device=device)()
    device = resolve_device(device)
    model, dtype = _module_on(model, device, compute_dtype)
    vol_zhw, x, y, _, n_crop = _flavr_prep(volume, slice_separation)
    windows = flavr_windows(vol_zhw)  # (z-1, 4, H, W, c)
    nw = windows.shape[0]
    windows = _pad_to_batch(windows, batch)
    outs = []
    for st in range(0, windows.shape[0], batch):
        chunk = torch.from_numpy(np.ascontiguousarray(
            windows[st:st + batch], dtype=np.float32))
        outs.append(_host(_forward(
            model, chunk.to(device=device, dtype=dtype), out_index or 0)))
    return _flavr_finish(np.concatenate(outs)[:nw], x, y, n_crop)


def postprocess_sr_volume(image_xyz: np.ndarray, blur_fwhm: float,
                          blur_kernel_name: str = "rf-pulse-slr"):
    """The slice-profile re-blur of a pseudo-HR image along x and along y
    (sr_utils.py:267-277). image_xyz: (x, y, z) or (x, y, z, c), channel 0
    taken. Returns (image_x_rgb (z, 1, x, y), image_y_rgb (z, 1, y, x))
    fp32, the stage-1 training LR sources."""
    kernel = parse_kernel(None, blur_kernel_name, blur_fwhm)
    img = image_xyz if image_xyz.ndim == 4 else image_xyz[..., None]
    zcxy = img.transpose(2, 3, 0, 1)[:, 0:1]
    image_x_rgb = blur_axis_np(zcxy.astype(np.float32), kernel, axis=2)
    zcyx = img.transpose(2, 3, 1, 0)[:, 0:1]
    image_y_rgb = blur_axis_np(zcyx.astype(np.float32), kernel, axis=2)
    return image_x_rgb, image_y_rgb


def interpolate_pseudo_sr(image: np.ndarray, label: np.ndarray,
                          slice_separation: float):
    """The interpolation fallback without SMORE: cubic zoom of the image
    and nearest of the label along z (sr_utils.py:256-265)."""
    up_img = zoom_axis_np(image, slice_separation, axis=2, order=3)
    up_lab = zoom_axis_np(label, slice_separation, axis=2, order=0)
    return up_img, up_lab


def zeroonenorm255(data: np.ndarray) -> np.ndarray:
    """(x - min)/(max - min) * 255 (sr_utils.py:279-282)."""
    data = (data - np.min(data)) / (np.max(data) - np.min(data))
    return data * 255.0


def restore_intensity(out01: np.ndarray, orig_min, orig_max) -> np.ndarray:
    """Map model [0, 1] outputs back to the source intensity range
    (sr_utils.py:175, inv_normalize with a=0, b=1)."""
    return inv_normalize(out01, orig_min, orig_max, a=0, b=1)
