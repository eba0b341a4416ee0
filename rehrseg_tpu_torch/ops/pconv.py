"""The stride-1 packed 2x2 conv kernels of the packed forward (the JAX
package's ``rehrseg_tpu/ops/pallas_pconv.py``), each with its plain
PyTorch version beside it:

- K1 ``pconv_pad11_cat`` (TPU kernel :889, body ``_pad11_cat_kernel``
  :641): concat + pad(1,1) conv, aligned pair -> offset;
- K3 ``pconv_valid`` (:519, body ``_valid_kernel`` :75): VALID conv,
  offset -> aligned, kd = 1;
- K4 ``pconv_pad11`` (:576, body ``_pad11_kernel`` :272): pad(1,1) conv,
  aligned -> offset;
- K5 ``pconv3_valid`` (:1117, body ``_valid3_kernel`` :930): the kd = 3,
  z-SAME form of K3.

With packed weights w (kd, 2, 2, Ci, Co) from ``pack2d.pack_conv_weights``
they compute

    pad11:  y = conv2d(x, w, pad (1, 1)) + b, (N, h+1, wp8, Co) with
            wp8 = round_up(w+1, 8) and columns > w exact zeros;
    valid:  y = conv(x[..., :w_out+1, :], w, VALID in-plane, SAME in z) + b,
            (.., hp-1, w_out, Co), reading only the true columns of an
            offset input stored 8-aligned wide.

Offset tensors live at 8-aligned widths with their true width tracked
beside them (the layout the packed forward keeps under
``pallas_conv=True``); the pad columns a VALID kernel never reads may hold
anything.

On the H100 each is an implicit GEMM in CUDA C++ (M = output pixels, N =
Co, K = taps x Ci) with a bf16 WMMA (``mma.sync``) kernel and an fp32 FMA
kernel; K1 and K4 share ``csrc/pconv_pad11_cat.cu`` (K4 is K1 with no
second input), K3 and K5 share ``csrc/pconv_valid.cu``. Every kernel adds
the bias in fp32 and rounds once.

Each wrapper keeps the JAX call contract: the same shapes, dtypes, default
``w_out`` rule and ``None`` where the shape predicate does not cover the
operands (the packed forward then runs the cuDNN conv at the same site).
The TPU's VMEM block choice (``_pick_bi``, ``fits``: it also refuses
heights with no 2/4/8/16 divisor) is a TPU limit and is not carried over.
On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. Each carries a ``.launches`` count.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _k6(name: str):
    return NotImplementedError(
        f"{name} is the deferred-norm K6 variant, still to be ported "
        f"(ROADMAP queue 2, K6)")


def _bias(b, c_out: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.zeros(c_out, dtype=like.dtype, device=like.device)
            if b is None else b.to(like.dtype))


# ------------------------------------------------------------ plain versions

def pconv_pad11_plain(x, w, b):
    """The plain PyTorch version of K4: a pad (1,1) 2x2 conv, the bias,
    then zero columns up to wp8."""
    w_in = x.shape[2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 padding=1)
    y = (y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1)
    return F.pad(y, (0, 0, 0, _round8(w_in + 1) - (w_in + 1)))


def pconv_pad11_cat_plain(xa, xb, w, b):
    """The plain PyTorch version of K1: concat, then K4's plain version."""
    return pconv_pad11_plain(torch.cat([xa, xb], dim=-1), w, b)


def pconv_valid_plain(x, w, b, w_out):
    """The plain PyTorch version of K3: a VALID 2x2 conv on the true
    columns 0..w_out, then the bias."""
    xs = x[:, :, :w_out + 1].permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.permute(3, 2, 0, 1), None)
    return (y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1).contiguous()


def pconv3_valid_plain(x, w, b, w_out):
    """The plain PyTorch version of K5: a (3, 2, 2) conv, SAME in z and
    VALID in-plane on the true columns 0..w_out, then the bias."""
    xs = x[:, :, :, :w_out + 1].permute(0, 4, 1, 2, 3)
    y = F.conv3d(xs, w.permute(4, 3, 0, 1, 2), None, padding=(1, 0, 0))
    return (y + b.view(1, -1, 1, 1, 1)).permute(0, 2, 3, 4, 1).contiguous()


# ------------------------------------------------------------ launches

def _check(what: str, *named):
    dev = named[0][1].device
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _entry(lib: str, fn_name: str, n_ptr: int, n_int: int):
    fn = getattr(kernels.load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    return fn


def _suffix(what: str, dtype) -> str:
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"{what}: no kernel for {dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_pad11(counter, x, w, b, xb=None):
    """K1 when xb is given, K4 otherwise: (n, h+1, wp8, co). Adds one to
    ``counter.launches`` once the kernel is launched."""
    n, h, w_in, ca = x.shape
    c_out = w.shape[-1]
    what = "pconv_pad11" if xb is None else "pconv_pad11_cat"
    cin = ca + (0 if xb is None else xb.shape[-1])
    if tuple(w.shape) != (2, 2, cin, c_out) or tuple(b.shape) != (c_out,):
        raise ValueError(f"{what}: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit {cin} -> {c_out}")
    named = [("x", x), ("w", w), ("b", b)]
    if xb is not None:
        named.append(("xb", xb))
    _check(what, *named)
    fn_name = f"{what}_{_suffix(what, x.dtype)}"
    wp8 = _round8(w_in + 1)
    if n * (h + 1) * wp8 >= 2 ** 31:
        raise ValueError(f"{what}: output too large for int32 rows")
    y = torch.empty((n, h + 1, wp8, c_out), dtype=x.dtype, device=x.device)
    if xb is None:
        fn = _entry("pconv_pad11_cat", fn_name, 4, 6)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 n, h, w_in, ca, c_out, wp8, _stream(x))
    else:
        fn = _entry("pconv_pad11_cat", fn_name, 5, 7)
        err = fn(x.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(),
                 y.data_ptr(), n, h, w_in, ca, xb.shape[-1], c_out, wp8,
                 _stream(x))
    kernels.check(err, fn_name)
    counter.launches += 1
    return y


def _launch_valid(counter, x, w, b, w_out):
    """K3 (x 4D, w (2, 2, Ci, Co)) or K5 (x 5D, w (3, 2, 2, Ci, Co)).
    Adds one to ``counter.launches`` once the kernel is launched."""
    what = "pconv_valid" if x.ndim == 4 else "pconv3_valid"
    kd = 1 if x.ndim == 4 else 3
    *lead, hp, wp8, c_in = x.shape
    nb, nd = (lead[0], 1) if kd == 1 else lead
    c_out = w.shape[-1]
    want_w = (2, 2, c_in, c_out) if kd == 1 else (3, 2, 2, c_in, c_out)
    if tuple(w.shape) != want_w or tuple(b.shape) != (c_out,):
        raise ValueError(f"{what}: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)}, want {want_w} / ({c_out},)")
    _check(what, ("x", x), ("w", w), ("b", b))
    fn_name = f"pconv_valid_{_suffix(what, x.dtype)}"
    y = torch.empty((*lead, hp - 1, w_out, c_out), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    fn = _entry("pconv_valid", fn_name, 4, 8)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
             nb, nd, hp, wp8, c_in, c_out, w_out, kd, _stream(x))
    kernels.check(err, fn_name)
    counter.launches += 1
    return y


# ------------------------------------------------------------ wrappers

def pconv_pad11_cat(xa, xb, w, b=None, *, want_stats=False):
    """K1: fused concat + pad11. xa (N, h, w, Ca), xb (N, h, w, Cb), w
    (2, 2, Ca+Cb, Co) with input channels ordered [xa | xb] -> offset
    (N, h+1, wp8, Co). None when the shapes are not covered (w % 8, or a
    channel count % 128, nonzero; mismatched inputs)."""
    if want_stats:
        raise _k6("pconv_pad11_cat(want_stats=True)")
    n, h, w_in, ca = xa.shape
    cb = xb.shape[-1]
    c_out = w.shape[-1]
    if (tuple(xb.shape[:3]) != (n, h, w_in) or xa.dtype != xb.dtype
            or w.shape[2] != ca + cb):
        return None
    if w_in % 8 or ca % 128 or cb % 128 or c_out % 128:
        return None
    w = w.to(xa.dtype)
    b = _bias(b, c_out, xa)
    if xa.device.type == "cpu":
        return pconv_pad11_cat_plain(xa, xb, w, b)
    return _launch_pad11(pconv_pad11_cat, xa, w.contiguous(),
                         b.contiguous(), xb=xb)


def pconv_pad11(x, w, b=None):
    """K4: aligned x (N, h, w, Ci), w (2, 2, Ci, Co) -> offset (N, h+1,
    wp8, Co), wp8 = round_up(w+1, 8), columns > w exact zeros (the caller's
    rim mask zeroes the usual parity rim). None when w % 8, Ci % 128 or
    Co % 128 is nonzero."""
    n, h, w_in, c_in = x.shape
    c_out = w.shape[-1]
    if w_in % 8 or c_in % 128 or c_out % 128:
        return None
    w = w.to(x.dtype)
    b = _bias(b, c_out, x)
    if x.device.type == "cpu":
        return pconv_pad11_plain(x, w, b)
    return _launch_pad11(pconv_pad11, x, w.contiguous(), b.contiguous())


def _default_w_out(wp8: int) -> int:
    """JAX's rule (pallas_pconv.py:539-540); a wp8 that is an odd multiple
    of 8 gives an uncovered width."""
    return wp8 - 8 if wp8 % 16 == 0 else wp8 - 1


def pconv_valid(x, w, b=None, *, w_out=None, pre=None, want_stats=False):
    """K3: offset x (N, hp, wp8, Ci), w (2, 2, Ci, Co) -> aligned
    (N, hp-1, w_out, Co), reading only columns 0..w_out of x. None when
    wp8 % 8, w_out % 8, Ci % 128 or Co % 128 is nonzero, or w_out + 1 >
    wp8. ``pre`` and ``want_stats`` belong to K6."""
    if pre is not None or want_stats:
        raise _k6("pconv_valid(pre=, want_stats=)")
    n, hp, wp8, c_in = x.shape
    c_out = w.shape[-1]
    if w_out is None:
        w_out = _default_w_out(wp8)
    if (wp8 % 8 or w_out % 8 or w_out + 1 > wp8 or c_in % 128
            or c_out % 128):
        return None
    w = w.to(x.dtype)
    b = _bias(b, c_out, x)
    if x.device.type == "cpu":
        return pconv_valid_plain(x, w, b, w_out)
    return _launch_valid(pconv_valid, x, w.contiguous(), b.contiguous(),
                         w_out)


def pconv3_valid(x, w, b=None, *, w_out=None, pre=None, want_stats=False):
    """K5: offset x (B, D, hp, wp8, Ci), w (3, 2, 2, Ci, Co) -> aligned
    (B, D, hp-1, w_out, Co), SAME in z, reading only columns 0..w_out of
    x. None where K3 would be, or when w is not kd = 3. ``pre`` and
    ``want_stats`` belong to K6."""
    if pre is not None or want_stats:
        raise _k6("pconv3_valid(pre=, want_stats=)")
    n_b, n_z, hp, wp8, c_in = x.shape
    c_out = w.shape[-1]
    if w_out is None:
        w_out = _default_w_out(wp8)
    if (wp8 % 8 or w_out % 8 or w_out + 1 > wp8 or c_in % 128
            or c_out % 128 or w.shape[0] != 3):
        return None
    w = w.to(x.dtype)
    b = _bias(b, c_out, x)
    if x.device.type == "cpu":
        return pconv3_valid_plain(x, w, b, w_out)
    return _launch_valid(pconv3_valid, x, w.contiguous(), b.contiguous(),
                         w_out)


pconv_pad11_cat.launches = 0
pconv_pad11.launches = 0
pconv_valid.launches = 0
pconv3_valid.launches = 0
