"""K7: the VALID 2x2 packed conv + bias on exact widths (the JAX package's
``rehrseg_tpu/ops/pallas_conv.py`` ``conv2x2_valid_bias`` :126, body
``_kernel`` :34), with its plain PyTorch version beside it.

    y[n, i, j, co] = b[co] + sum_{s,t in {0,1}} sum_c x[n, i+s, j+t, c]
                                                     * W[s, t, c, co]

x (N, h+1, w+1, Ci) offset-packed at its exact (odd) width, W (2, 2, Ci,
Co) -> y (N, h, w, Co). Nothing on the packed forward calls it: the
forward keeps offset tensors 8-aligned wide and reaches the same math
through K3 (:func:`rehrseg_tpu_torch.ops.pconv.pconv_valid`). On the H100
it follows K3's kernels, with the input's row pitch w+1 and the output width
w, which need no 8-alignment: bf16 calls K3's entry of
``csrc/pconv2d_sm90.cu`` (the Hopper kernel; its tensor map's strides are
multiples of 16 bytes at any width because Ci % 128 == 0), fp32 a third
entry point of ``csrc/pconv_valid.cu`` (the kd = 1 FMA kernel).

The call contract is JAX's: ``None`` when Ci or Co is not a multiple of
128. The TPU kernel's block-height choice (``_pick_bi``, which also refuses
a height with no divisor in (16, 20, 8, 10, 32, 4, 5, 2)) is a TPU limit
and is not carried over. On CPU tensors the wrapper runs the plain version;
on CUDA tensors it launches the kernel, on x's device, or raises.
``.launches`` counts its launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .pconv import (_INT, _PTR, _bias, _check, _entry, _stream, _suffix,
                    refuse_grad)


def conv2x2_valid_bias_plain(x, w, b):
    """The plain PyTorch version of K7: a VALID 2x2 conv, then the bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None)
    return (y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1).contiguous()


def conv2x2_valid_bias(x, w, b=None):
    """(N, h+1, w+1, Ci) offset-packed x, (2, 2, Ci, Co) packed weights ->
    (N, h, w, Co), VALID, + bias. None when Ci % 128 or Co % 128 is
    nonzero."""
    refuse_grad("conv2x2_valid_bias", x, w, b)
    n, hp, wp, c_in = x.shape
    c_out = w.shape[-1]
    if c_in % 128 or c_out % 128:
        return None
    w = w.to(x.dtype)
    b = _bias(b, c_out, x)
    if x.device.type == "cpu":
        return conv2x2_valid_bias_plain(x, w, b)
    what = "conv2x2_valid_bias"
    w, b = w.contiguous(), b.contiguous()
    if tuple(w.shape) != (2, 2, c_in, c_out):
        raise ValueError(f"{what}: weights {tuple(w.shape)}, want "
                         f"(2, 2, {c_in}, {c_out})")
    _check(what, ("x", x), ("w", w), ("b", b))
    y = torch.empty((n, hp - 1, wp - 1, c_out), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):   # the build and the launch: x's device
        if _suffix(what, x.dtype) == "bf16":
            # K3's Hopper kernel: stored width wp, output width wp - 1
            fn, fn_name = _entry("k7_bf16", [_PTR] * 4 + [_INT] * 6)
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     n, hp, wp, c_in, c_out, wp - 1, _stream(x))
        else:
            fn, fn_name = _entry("k7_f32", [_PTR] * 4 + [_INT] * 5)
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     n, hp, wp, c_in, c_out, _stream(x))
    kernels.check(err, fn_name)
    conv2x2_valid_bias.launches += 1
    return y


conv2x2_valid_bias.launches = 0
