"""K2: fused mirror-TTA unmirror + mean + gaussian weight + accumulate
(``accumulate_tta_tile``) for the aligned sliding-window engine.

Replaces the TPU kernel ``rehrseg_tpu/ops/pallas_tail.py``
``accumulate_tta_tile`` (:222; body ``_kernel`` :71). For one tile it does

    logits[c, sx*z_scale + d, sy:sy+ph, sz:sz+pw] +=
        valid * 0.125 * g[d] * sum_i unflip_i(preds[i, c])

in place, with preds (8, C, od, ph, pw) in the z-grouped combo order of
:func:`zgrouped_combos`, the gaussian g (od, ph, pw) rounded to the preds
dtype (as the TPU kernel does, pallas_tail.py:241-244), and the per-element
sum taken in fp32 in the TPU kernel's order.

On the H100 (``csrc/accumulate_tta_tile.cu``) it is one streaming pass
with no matrix work: bound by bytes alone (8 pred reads, one gaussian read
and one accumulator read + write per output element; about 98 MB per LR
launch and 393 MB per HR launch at the serving shapes). Its vector
instance gives each thread one 16-byte chunk of a row (8 bf16 or 4 fp32
lanes): the unflips are index arithmetic (d -> od-1-d for the last four
combos, row y -> ph-1-y for an h-flip, the mirrored chunk for a w-flip,
its lanes taken in reverse in registers) and the accumulator moves as
float4s, without atomics: an element belongs to one thread and launches on
one stream are serialized. A general instance, one element a thread,
takes the operands the vector one cannot (:func:`_k2_vector_ok`), so any
offsets are accepted; the aligned grid's sy % 8 / sz % 128 starts take
the vector instance.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .pconv import refuse_grad


def zgrouped_combos():
    """Mirror combos ordered so the z-flip bit is the high bit:
    [(), (1,), (2,), (1,2), (0,), (0,1), (0,2), (0,1,2)] over tile axes
    (z, h, w) = (0, 1, 2)."""
    return [(), (1,), (2,), (1, 2), (0,), (0, 1), (0, 2), (0, 1, 2)]


def _check_region(logits, preds, offsets, z_scale):
    c, d, h, w = logits.shape
    n_tta, n_classes, od, ph, pw = preds.shape
    if n_tta != 8 or n_classes != c:
        raise ValueError(f"accumulate_tta_tile: preds {tuple(preds.shape)} "
                         f"vs logits {tuple(logits.shape)}")
    sx, sy, sz, valid = (int(v) for v in offsets)
    zo = sx * z_scale
    if not (0 <= zo and zo + od <= d and 0 <= sy and sy + ph <= h
            and 0 <= sz and sz + pw <= w):
        raise ValueError(f"accumulate_tta_tile: tile at {(zo, sy, sz)} of "
                         f"{(od, ph, pw)} outside logits {(d, h, w)}")
    return zo, sy, sz, valid


def accumulate_tta_tile_plain(logits, preds, gaussian, offsets, z_scale=1):
    """The plain PyTorch version: flips, sum in the kernel's order, weight,
    slice-add. Updates ``logits`` in place and returns it."""
    zo, sy, sz, valid = _check_region(logits, preds, offsets, z_scale)
    od, ph, pw = preds.shape[2:]
    p = preds.float()
    a = p[:4]                        # combos (), h, w, hw at plane d
    b = p[4:].flip(2)                # their z-flipped partners
    u = a[0] + b[0]
    u = u + a[1].flip(-2)
    u = u + b[1].flip(-2)
    u = u + a[2].flip(-1)
    u = u + b[2].flip(-1)
    u = u + a[3].flip(-1).flip(-2)
    u = u + b[3].flip(-1).flip(-2)
    g = gaussian.to(preds.dtype).float() * (float(valid) * 0.125)
    logits[:, zo:zo + od, sy:sy + ph, sz:sz + pw] += u * g
    return logits


# the C launchers by the dtype of preds: (library of ``kernels.SOURCES``,
# entry declared ``extern "C"`` in its source)
C_ENTRIES = {
    torch.bfloat16: ("accumulate_tta_tile", "accumulate_tta_tile_bf16"),
    torch.float32: ("accumulate_tta_tile", "accumulate_tta_tile_f32"),
}


def _k2_vector_ok(logits, preds, gaussian, sz):
    """Whether K2's vector instance takes these (contiguous) operands:
    rows of preds and gaussian in whole 16-byte chunks, float4 rows of the
    accumulator (W and the tile's start sz multiples of 4), and every base
    pointer 16-byte aligned. Otherwise the general instance runs."""
    lanes = 16 // preds.element_size()
    return (preds.shape[-1] % lanes == 0 and logits.shape[-1] % 4 == 0
            and sz % 4 == 0
            and all(t.data_ptr() % 16 == 0
                    for t in (logits, preds, gaussian)))


def _launch(logits, preds, gaussian, region, z_scale):
    zo, sy, sz, valid = region
    c, d, h, w = logits.shape
    od, ph, pw = preds.shape[2:]
    for name, t in (("logits", logits), ("preds", preds),
                    ("gaussian", gaussian)):
        if not t.is_cuda or t.device != logits.device:
            raise ValueError(f"accumulate_tta_tile: {name} must be on "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"accumulate_tta_tile: {name} must be "
                             f"contiguous")
    if logits.dtype != torch.float32:
        raise TypeError("accumulate_tta_tile: logits must be float32")
    if preds.dtype not in C_ENTRIES:
        raise TypeError(f"accumulate_tta_tile: no kernel for {preds.dtype}")
    lib, fn_name = C_ENTRIES[preds.dtype]
    vec = int(_k2_vector_ok(logits, preds, gaussian, sz))
    # build (at first use) and launch on the tensors' device
    with torch.cuda.device(logits.device):
        fn = getattr(kernels.load(lib), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), preds.data_ptr(), gaussian.data_ptr(),
                 c, d, h, w, od, ph, pw, zo, sy, sz, valid, vec, stream)
    kernels.check(err, fn_name)
    accumulate_tta_tile.launches += 1
    return logits


def accumulate_tta_tile(logits, preds, gaussian, offsets, *, z_scale=1):
    """Fused unmirror + mean + gauss + accumulate of one tile's TTA
    predictions, in place (see the module docstring).

    logits (C, D, H, W) fp32; preds (8, C, od, ph, pw); gaussian
    (od, ph, pw); offsets (sx, sy, sz, valid) ints, sx on the LR z grid.
    Returns ``logits``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (its vector or its general instance) or raise;
    inputs that require grad in grad mode raise (the kernel has no
    backward). A gaussian already in the preds' dtype is used as it is,
    so a caller that casts it once saves a pass per call."""
    refuse_grad("accumulate_tta_tile", logits, preds, gaussian)
    if logits.device.type == "cpu":
        return accumulate_tta_tile_plain(logits, preds, gaussian, offsets,
                                         z_scale)
    region = _check_region(logits, preds, offsets, z_scale)
    g = gaussian.to(preds.dtype).contiguous()
    return _launch(logits, preds, g, region, z_scale)


accumulate_tta_tile.launches = 0
