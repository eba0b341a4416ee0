"""K1: fused decoder-concat + pad(1,1) packed conv (``pconv_pad11_cat``).

Replaces the TPU kernel ``rehrseg_tpu/ops/pallas_pconv.py``
``pconv_pad11_cat`` (:889; body ``_pad11_cat_kernel`` :641). It computes

    y = conv2d(concat([xa, xb], -1), w, pad (1, 1)) + b

for aligned-packed xa (N, h, w, Ca), xb (N, h, w, Cb) and packed weights
w (2, 2, Ca+Cb, Co) with input channels ordered [xa | xb], and emits the
offset-parity tensor (N, h+1, wp8, Co), wp8 = round_up(w+1, 8), whose
columns > w are exact zeros (the 8-aligned layout the packed forward
tracks with its true width). The concatenated tensor never exists.

On the H100 (``csrc/pconv_pad11_cat.cu``) it is an implicit GEMM: M =
output pixels, N = Co, K = 4 taps x (Ca+Cb), with the K loop reading
channels [0, Ca) from xa and [Ca, Ca+Cb) from xb. At the serving shape
(N = 128, h = 160, w = 192, Ca = Cb = Co = 128) it does 1.04 TFLOP and
moves about 3.07 GB, so it sits near the balance point of the card's
bf16 tensor-core rate and memory rate. The bf16 kernel stages a 32-channel
input slab per kernel row in shared memory, which both column taps read
(shifted by one row), plus the two taps' weights, through a 3-stage
``cp.async`` pipeline (zero fill at the image rim), and multiplies with
WMMA (``mma.sync``) into fp32 accumulators; the bias and the zero columns
are applied in the epilogue. fp32 inputs take a plain FMA kernel.

The coverage predicate is the JAX one (pallas_pconv.py:907-911): None
where the shapes or dtypes do not fit, so the packed forward concatenates
at the same sites. The TPU's VMEM block choice (``_pick_bi``) is a TPU
limit and is not carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def pconv_pad11_cat_plain(xa, xb, w, b):
    """The plain PyTorch version: concat, then a pad (1,1) 2x2 conv, then
    the zero columns up to wp8."""
    n, h, w_in, _ = xa.shape
    x = torch.cat([xa, xb], dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(x, w.permute(3, 2, 0, 1), None, padding=1)
    y = y + b.view(1, -1, 1, 1)
    y = y.permute(0, 2, 3, 1)
    return F.pad(y, (0, 0, 0, _round8(w_in + 1) - (w_in + 1)))


def _launch(xa, xb, w, b):
    n, h, w_in, ca = xa.shape
    cb, c_out = xb.shape[-1], w.shape[-1]
    for name, t in (("xa", xa), ("xb", xb), ("w", w), ("b", b)):
        if not t.is_cuda or t.device != xa.device:
            raise ValueError(f"pconv_pad11_cat: {name} must be on "
                             f"{xa.device}")
        if not t.is_contiguous():
            raise ValueError(f"pconv_pad11_cat: {name} must be contiguous")
    if xa.dtype == torch.bfloat16:
        fn_name = "pconv_pad11_cat_bf16"
    elif xa.dtype == torch.float32:
        fn_name = "pconv_pad11_cat_f32"
    else:
        raise TypeError(f"pconv_pad11_cat: no kernel for {xa.dtype}")
    if n * (h + 1) * _round8(w_in + 1) >= 2 ** 31:
        raise ValueError("pconv_pad11_cat: output too large for int32 rows")
    wp8 = _round8(w_in + 1)
    y = torch.empty((n, h + 1, wp8, c_out), dtype=xa.dtype, device=xa.device)
    fn = getattr(kernels.load("pconv_pad11_cat"), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(xa.device).cuda_stream
    err = fn(xa.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(),
             y.data_ptr(), n, h, w_in, ca, cb, c_out, wp8, stream)
    kernels.check(err, fn_name)
    pconv_pad11_cat.launches += 1
    return y


def pconv_pad11_cat(xa, xb, w, b=None, *, want_stats=False):
    """Fused concat + pad11 (see the module docstring). Returns None when
    the shapes are not covered (w % 8, or a channel count % 128, nonzero;
    mismatched inputs). On CPU tensors it runs the plain version; on CUDA
    tensors it launches the kernel or raises."""
    if want_stats:
        raise NotImplementedError(
            "pconv_pad11_cat(want_stats=True) is the deferred-norm K6 "
            "variant, still to be ported (ROADMAP queue 2, K6)")
    n, h, w_in, ca = xa.shape
    cb = xb.shape[-1]
    c_out = w.shape[-1]
    if (tuple(xb.shape[:3]) != (n, h, w_in) or xa.dtype != xb.dtype
            or w.shape[2] != ca + cb):
        return None
    if w_in % 8 or ca % 128 or cb % 128 or c_out % 128:
        return None
    w = w.to(xa.dtype)
    b = (torch.zeros(c_out, dtype=xa.dtype, device=xa.device) if b is None
         else b.to(xa.dtype))
    if xa.device.type == "cpu":
        return pconv_pad11_cat_plain(xa, xb, w, b)
    return _launch(xa, xb, w.contiguous(), b.contiguous())


pconv_pad11_cat.launches = 0
