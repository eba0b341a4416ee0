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
  z-SAME form of K3;
- K6, the deferred-norm forms of ``pallas_conv="fused"``: K6a
  ``pconv_pad11_cat(want_stats=True)`` (the full offset rim mask applied
  to the output, plus its moment partials), K6b ``pconv_valid(pre=,
  want_stats=)`` (body ``_valid_fused_kernel`` :148) and K6c
  ``pconv3_valid(pre=, want_stats=)``.

With packed weights w (kd, 2, 2, Ci, Co) from ``pack2d.pack_conv_weights``
they compute

    pad11:  y = conv2d(x, w, pad (1, 1)) + b, (N, h+1, wp8, Co) with
            wp8 = round_up(w+1, 8) and columns > w exact zeros;
    valid:  y = conv(x[..., :w_out+1, :], w, VALID in-plane, SAME in z) + b,
            (.., hp-1, w_out, Co), reading only the true columns of an
            offset input stored 8-aligned wide.

Offset tensors live at 8-aligned widths with their true width tracked
beside them; the pad columns a VALID kernel never reads may hold anything.

The deferred-norm contract (``pack2d``'s glue turns the statistics into
the per-image scale and shift):

- ``pre=(sa, ta, slope)``: x is a raw offset conv output whose instance
  norm was deferred; the conv reads ``leaky(x * sa + ta) * rim_mask``
  (the offset rim mask of x's true width w_out + 1), computed in x.dtype
  with a rounding after the multiply, the add and the leaky product. sa
  and ta are (N, 8, Ci) per image for K6b and (B, 8, Ci) per batch element
  for K6c; row 0 is read. Taps outside the input (K5's z taps outside
  [0, D)) contribute zero after the transform.
- ``want_stats=True``: also return (N, 16, Co) fp32 moment partials of
  the stored (rounded) output, per (b, z) image: the sum of rows 0:8 is the
  sum, of rows 8:16 the sum of squares. Only the two half-sums are the
  contract; how they spread over the rows is not.

On the H100 each is an implicit GEMM in CUDA C++ (M = output pixels, N =
Co, K = taps x Ci). In bf16 every form runs a Hopper kernel (TMA-fed shared
memory, ``wgmma``; shared code in ``csrc/sm90_pipeline.cuh``, where the K6
forms' parts are: the ``pre`` transform of the landed input in shared
memory, the rim mask and moment sums in the epilogue): K1 and K6a
``csrc/pconv_pad11_cat_sm90.cu``, K5 and K6c ``csrc/pconv3_valid_sm90.cu``
(weights streamed with the input), K3, K6b and K4 ``csrc/pconv2d_sm90.cu``
(and bf16 K7, :mod:`.conv2x2`): the weights resident in shared memory where
they fit (Ci = 128), the streamed kernel on the same tap geometry where they
do not. In fp32 every form runs the same Hopper kernels by 3xTF32 (each
operand split into two TF32 parts, :func:`split_tf32`, three TF32 products
summed in fp32: the weights split once a call by :func:`tf32x3_weights`,
the input in the kernel's registers, where the K6b / K6c ``pre`` transform
is applied too): K1, K4 and K6a in ``csrc/pconv_pad11_cat_sm90.cu``, K5 and
K6c in ``csrc/pconv3_valid_sm90.cu``, K3, K6b and K7 on the streamed kernel
in ``csrc/pconv2d_sm90.cu``. The fp32 forms with moment sums (K6a-c) make
their large product exact and their weights whole
(:func:`tf32x3_exact_weights`: high parts on grids, a third, bf16, part
of the weights): the tensor cores' truncating accumulation, and the bits
two TF32 parts leave of a weight, would shift the output of every pixel
alike, which an image's sum adds up. Every kernel adds the bias
in fp32; a bf16 kernel rounds once, an fp32 one not at all.

Each wrapper keeps the JAX call contract: the same shapes, dtypes, default
``w_out`` rule, ``(y, stats)`` when ``want_stats``, and ``None`` where the
shape predicate does not cover the operands (the packed forward then runs
the cuDNN conv at the same site). The TPU's VMEM block choice
(``_pick_bi``, ``_pick_bi_fused``, ``fits``: they also refuse heights with
no 2/4/8/16(/32) divisor) is a TPU limit and is not carried over. On CPU
tensors a wrapper runs its plain version; on CUDA tensors it launches its
kernel, on the tensors' device, or raises. Each carries a ``.launches``
count of its plain form's launches; K1, K3 and K5 also carry
``.fused_launches``, the launches of their K6 form.

The kernels have no backward (nor do the Pallas kernels in JAX): a wrapper
called in grad mode with an input that requires grad raises
(:func:`refuse_grad`) rather than return a tensor cut from the graph, on
either device. Training runs the packed forward with ``pallas_conv=False``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import kernels
from .pack2d import leaky_scale_shift, offset_rim_mask


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _bias(b, c_out: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.zeros(c_out, dtype=like.dtype, device=like.device)
            if b is None else b.to(like.dtype))


# ------------------------------------------------------------ plain versions

def stats16_plain(y: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols, C) -> (N, 16, C) fp32 moment partials of y as
    stored, one image per leading index: row 0 the sum, row 8 the sum of
    squares, the other rows zero."""
    y32 = y.float().reshape(-1, y.shape[-3] * y.shape[-2], y.shape[-1])
    out = torch.zeros((y32.shape[0], 16, y32.shape[-1]), dtype=torch.float32,
                      device=y.device)
    out[:, 0] = y32.sum(1)
    out[:, 8] = y32.square().sum(1)
    return out


def pre_plain(x, sa, ta, slope):
    """The consumer-side transform ``leaky(x * sa + ta) * rim_mask`` of an
    offset tensor x (..., hp, tw, Ci) at its true width tw, in x.dtype. sa,
    ta broadcast against x without its last three axes (row 0 of the
    (.., 8, Ci) layout)."""
    hp, tw, ci = x.shape[-3:]
    shape = (*sa.shape[:-2], *([1] * (x.ndim - sa.ndim + 1)), ci)
    z = leaky_scale_shift(x, sa[..., 0, :].reshape(shape),
                          ta[..., 0, :].reshape(shape), slope)
    return z * offset_rim_mask(hp, tw, ci // 4, z.dtype, z.device)


def pconv_pad11_plain(x, w, b):
    """The plain PyTorch version of K4: a pad (1,1) 2x2 conv, the bias,
    then zero columns up to wp8."""
    w_in = x.shape[2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 padding=1)
    y = (y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1)
    return F.pad(y, (0, 0, 0, _round8(w_in + 1) - (w_in + 1)))


def pconv_pad11_cat_plain(xa, xb, w, b, want_stats=False):
    """The plain PyTorch version of K1: concat, then K4's plain version.
    want_stats (K6a): the output times the full offset rim mask, and its
    moment partials."""
    y = pconv_pad11_plain(torch.cat([xa, xb], dim=-1), w, b)
    if not want_stats:
        return y
    hp, wp8, c_out = y.shape[1:]
    y = y * offset_rim_mask(hp, wp8, c_out // 4, y.dtype, y.device,
                            true_w=xa.shape[2] + 1)
    return y, stats16_plain(y)


def pconv_valid_plain(x, w, b, w_out, pre=None, want_stats=False):
    """The plain PyTorch version of K3 (and K6b): the ``pre`` transform if
    given, a VALID 2x2 conv on the true columns 0..w_out, then the bias;
    with want_stats also the output's moment partials."""
    xs = x[:, :, :w_out + 1]
    if pre is not None:
        xs = pre_plain(xs, *pre)
    y = F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None)
    y = (y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1).contiguous()
    return (y, stats16_plain(y)) if want_stats else y


def pconv3_valid_plain(x, w, b, w_out, pre=None, want_stats=False):
    """The plain PyTorch version of K5 (and K6c): the ``pre`` transform
    per batch element if given, a (3, 2, 2) conv, SAME in z (zero planes,
    after the transform) and VALID in-plane on the true columns 0..w_out,
    then the bias; with want_stats also per-(b, z) moment partials."""
    xs = x[:, :, :, :w_out + 1]
    if pre is not None:
        xs = pre_plain(xs, *pre)
    y = F.conv3d(xs.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), None,
                 padding=(1, 0, 0))
    y = (y + b.view(1, -1, 1, 1, 1)).permute(0, 2, 3, 4, 1).contiguous()
    return (y, stats16_plain(y)) if want_stats else y


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 t rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: 0x1000 added to the bits, the low 13 cleared (what
    ``cvt.rna.tf32.f32`` computes for finite values)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """(hi, lo): fp32 t as two TF32 values, hi = round_tf32(t) and lo =
    round_tf32(t - hi) (the remainder is exact in fp32), so that hi + lo is
    within 2^-21 of t, relatively. The kernels' 3xTF32 products
    (hi * lo + lo * hi + hi * hi) are fp32-accurate."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """Weights (taps..., Ci, Co) -> (Co, T Ci), T the product of the tap
    axes, K-major (column k = tap * Ci + c, tap the row-major index of the
    tap axes: 2 s + t for (2, 2, Ci, Co), (u * 2 + s) * 2 + t for (3, 2,
    2, Ci, Co)), each 32-channel chunk in the order of the kernels' A
    fragments: channel 8 a + 4 b + kk at position 8 kk + 4 b + a."""
    co = w.shape[-1]
    k = w.numel() // co
    wk = w.reshape(k, co).t().reshape(co, k // 32, 4, 2, 4)
    return wk.permute(0, 1, 4, 3, 2).reshape(co, k)


def tf32x3_weights(w: torch.Tensor) -> torch.Tensor:
    """fp32 weights (taps..., Ci, Co) -> (2, Co, T Ci): W_hi and W_lo of
    :func:`split_tf32`, laid out by :func:`_k_major`."""
    return torch.stack(split_tf32(_k_major(w)))


def round_tf32_even(t: torch.Tensor) -> torch.Tensor:
    """fp32 t rounded to TF32 to nearest, ties to even: for the weights'
    W_lo in :func:`tf32x3_exact_weights`, whose rounding every pixel
    shares, so that no tie leans away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0xfff + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


# a 32-channel chunk's channel at each row of tf32x3_exact_weights' third
# part (16 t + r holds 8 (r % 8 // 2) + 4 t + r % 2 + 2 (r // 8): the k of
# the kernel's bf16 A fragments)
_BF16_ORDER = [8 * (r % 8 // 2) + 4 * t + r % 2 + 2 * (r // 8)
               for t in range(2) for r in range(16)]


def tf32x3_exact_weights(w: torch.Tensor):
    """fp32 weights (taps..., Ci, Co) -> (split, third) for the fp32 forms
    with moment sums (``csrc/sm90_pipeline.cuh`` ``tf32x3_exact_step``).
    split (2, Co, T Ci) is laid out as :func:`tf32x3_weights`', but W_hi
    is w rounded (to nearest even) to the grid of its column's 32-channel
    chunk, 2^-8 of the power of two of the chunk's largest magnitude (at
    most 2^9 steps: 10 bits), so that a row tap's products with A_hi on its
    own grid sum exactly; W_lo is the remainder rounded to TF32, to nearest
    even. third (T Ci, Co) bf16 is what W_hi + W_lo leave, rounded to
    nearest (exact for weights within 2^-4 of their chunk's largest, the
    others within 2^-30 of it), the rows of each chunk in the order of the
    kernel's bf16 A fragments."""
    co = w.shape[-1]
    g = w.reshape(-1, 32, co)
    step = torch.ldexp(torch.ones_like(g[:, :1]),
                       torch.frexp(g.abs().amax(1, keepdim=True))[1] - 9)
    hi = torch.round(g / step) * step
    rem = g - hi
    lo = round_tf32_even(rem)
    third = (rem - lo)[:, torch.tensor(_BF16_ORDER, device=w.device)]
    split = torch.stack([_k_major(t.reshape(w.shape)) for t in (hi, lo)])
    return split, third.reshape(-1, co).to(torch.bfloat16).contiguous()


# ------------------------------------------------------------ launches

def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would need a gradient through a kernel that has
    none: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward; call it under "
            f"torch.no_grad() or on inputs that do not require grad (the "
            f"packed forward trains with pallas_conv=False)")


def _check(what: str, *named):
    dev = named[0][1].device
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# Every C launcher this package's conv wrappers call: form and dtype ->
# (library of ``kernels.SOURCES``, entry declared ``extern "C"`` in its
# source). A "_variant" key is the same Hopper kernel with its timed variant
# named by more ints (three; four for K6b).
C_ENTRIES = {
    "k1_bf16": ("pconv_pad11_cat_sm90", "pconv_pad11_cat_sm90_bf16"),
    "k1_bf16_variant": ("pconv_pad11_cat_sm90",
                        "pconv_pad11_cat_sm90_bf16_variant"),
    # fp32 K1, K6a with stats, K4 with Cb = 0
    "pad11_f32": ("pconv_pad11_cat_sm90", "pconv_pad11_cat_sm90_f32"),
    "k6a_bf16": ("pconv_pad11_cat_sm90", "pconv_pad11_cat_stats_sm90_bf16"),
    "k6a_bf16_variant": ("pconv_pad11_cat_sm90",
                         "pconv_pad11_cat_stats_sm90_bf16_variant"),
    "k4_bf16": ("pconv2d_sm90", "pconv_pad11_sm90_bf16"),
    "k4_bf16_variant": ("pconv2d_sm90", "pconv_pad11_sm90_bf16_variant"),
    "k3_bf16": ("pconv2d_sm90", "pconv_valid_sm90_bf16"),
    "k3_bf16_variant": ("pconv2d_sm90", "pconv_valid_sm90_bf16_variant"),
    "k5_bf16": ("pconv3_valid_sm90", "pconv3_valid_sm90_bf16"),
    "k5_bf16_variant": ("pconv3_valid_sm90",
                        "pconv3_valid_sm90_bf16_variant"),
    "k6c_bf16": ("pconv3_valid_sm90", "pconv3_valid_fused_sm90_bf16"),
    "k6c_bf16_variant": ("pconv3_valid_sm90",
                         "pconv3_valid_fused_sm90_bf16_variant"),
    "k6b_bf16": ("pconv2d_sm90", "pconv_valid_fused_sm90_bf16"),
    "k6b_bf16_variant": ("pconv2d_sm90",
                         "pconv_valid_fused_sm90_bf16_variant"),
    # fp32 K3 and K6b (sa, ta, stats or null); K5 and K6c
    "k3_f32": ("pconv2d_sm90", "pconv_valid_sm90_f32"),
    "k5_f32": ("pconv3_valid_sm90", "pconv3_valid_sm90_f32"),
    "k7_bf16": ("pconv2d_sm90", "pconv_valid_sm90_bf16"),
    "k7_f32": ("pconv2d_sm90", "pconv_valid_sm90_f32"),
}


def _entry(key: str, argtypes, variant=None):
    """(C launcher, its name) for ``C_ENTRIES[key]``, or for its
    "_variant" twin when a variant (a tuple of ints) is named; argtypes
    lists the arguments before the variant's ints and the trailing stream
    pointer. Builds the library at its first use, on the current
    device."""
    lib, fn_name = C_ENTRIES[key + ("_variant" if variant else "")]
    fn = getattr(kernels.load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes) + [_INT] * len(variant or ()) + [_PTR]
    return fn, fn_name


def _suffix(what: str, dtype) -> str:
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"{what}: no kernel for {dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(counter, attr: str):
    setattr(counter, attr, getattr(counter, attr) + 1)


def _on_device(launch):
    """Run a launcher with the device of x, its first tensor, current: the
    build at first use, the allocations and the launch go there, whatever
    device the caller has current."""
    @functools.wraps(launch)
    def on_device(counter, x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return launch(counter, x, *args, **kwargs)
    return on_device


@_on_device
def _launch_pad11(counter, x, w, b, xb=None, want_stats=False,
                  variant=None):
    """K1 when xb is given (K6a with want_stats), K4 otherwise: (n, h+1,
    wp8, co) [and (n, 16, co) stats]. Adds one to the counter's
    ``launches`` (``fused_launches`` for K6a) once the kernel is
    launched, on x's device. Every form runs a Hopper kernel; ``variant``
    names one of its timed variants: in bf16, (cluster, stages, log2 tile
    width) for K1; (measure, stages, log2 tile width) for K6a, measure 0
    the kernel and, for measuring what its epilogue costs (the stats come
    out wrong), 1 the sums stored without atomics, 2 the rim mask alone;
    (mode, stages, log2 tile width) for K4, with mode 0 the streamed
    weights, 1 resident weights without the overlapped store, 2 with it.
    fp32 (3xTF32) has no variants."""
    n, h, w_in, ca = x.shape
    c_out = w.shape[-1]
    what = "pconv_pad11" if xb is None else "pconv_pad11_cat"
    cb = 0 if xb is None else xb.shape[-1]
    if tuple(w.shape) != (2, 2, ca + cb, c_out) or tuple(b.shape) != (c_out,):
        raise ValueError(f"{what}: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit {ca + cb} -> {c_out}")
    named = [("x", x), ("w", w), ("b", b)]
    if xb is not None:
        named.append(("xb", xb))
    _check(what, *named)
    sfx = _suffix(what, x.dtype)
    wp8 = _round8(w_in + 1)
    if n * (h + 1) * wp8 >= 2 ** 31:
        raise ValueError(f"{what}: output too large for int32 rows")
    y = torch.empty((n, h + 1, wp8, c_out), dtype=x.dtype, device=x.device)
    stats = (torch.zeros((n, 16, c_out), dtype=torch.float32,
                         device=x.device) if want_stats else None)
    if sfx == "f32":
        # K1, K6a and K4 (cb = 0, xb unread): one 3xTF32 entry on the
        # split weights, K6a's exact with their third part, stats or null
        # (no variants)
        ws, w3 = (tf32x3_exact_weights(w) if want_stats
                  else (tf32x3_weights(w), None))
        fn, fn_name = _entry("pad11_f32", [_PTR] * 7 + [_INT] * 7)
        err = fn(x.data_ptr(), (x if xb is None else xb).data_ptr(),
                 ws.data_ptr(), w3.data_ptr() if want_stats else None,
                 b.data_ptr(), y.data_ptr(),
                 stats.data_ptr() if want_stats else None, n, h, w_in, ca,
                 cb, c_out, wp8, _stream(x))
    elif xb is None:
        fn, fn_name = _entry("k4_bf16", [_PTR] * 4 + [_INT] * 6, variant)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 n, h, w_in, ca, c_out, wp8, *(variant or ()), _stream(x))
    elif not want_stats:
        fn, fn_name = _entry("k1_bf16", [_PTR] * 5 + [_INT] * 7, variant)
        err = fn(x.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(),
                 y.data_ptr(), n, h, w_in, ca, cb, c_out, wp8,
                 *(variant or ()), _stream(x))
    else:
        fn, fn_name = _entry("k6a_bf16", [_PTR] * 6 + [_INT] * 7, variant)
        err = fn(x.data_ptr(), xb.data_ptr(), w.data_ptr(), b.data_ptr(),
                 y.data_ptr(), stats.data_ptr(), n, h, w_in, ca, cb, c_out,
                 wp8, *(variant or ()), _stream(x))
    kernels.check(err, fn_name)
    if want_stats:
        _count(counter, "fused_launches")
        return y, stats
    _count(counter, "launches")
    return y


@_on_device
def _launch_valid(counter, x, w, b, w_out, pre=None, want_stats=False,
                  variant=None):
    """K3 (x 4D, w (2, 2, Ci, Co)) or K5 (x 5D, w (3, 2, 2, Ci, Co)); K6b
    / K6c with ``pre`` or ``want_stats``. Adds one to the counter's
    ``launches`` (``fused_launches`` for a K6 form) once the kernel is
    launched, on x's device. Every form runs a Hopper kernel; ``variant``
    names one of its timed variants in bf16: (cluster, stages, log2 tile
    width) for K5; (mode, stages, log2 tile width) for K3, as for K4;
    (measure, stages, log2 tile width) for K6c and (measure, mode, stages,
    log2 tile width) for K6b, measure 0 the kernel, 1 as for K6a, and, with
    y wrong too, 2 the ``pre`` rewrite skipped, 3 its loads and stores
    alone. fp32 (3xTF32) has no variants."""
    what = "pconv_valid" if x.ndim == 4 else "pconv3_valid"
    kd = 1 if x.ndim == 4 else 3
    *lead, hp, wp8, c_in = x.shape
    nb, nd = (lead[0], 1) if kd == 1 else lead
    c_out = w.shape[-1]
    want_w = (2, 2, c_in, c_out) if kd == 1 else (3, 2, 2, c_in, c_out)
    if tuple(w.shape) != want_w or tuple(b.shape) != (c_out,):
        raise ValueError(f"{what}: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)}, want {want_w} / ({c_out},)")
    fused = pre is not None or want_stats
    named = [("x", x), ("w", w), ("b", b)]
    if pre is not None:
        sa, ta, slope = pre
        if tuple(sa.shape) != (nb, 8, c_in) or sa.shape != ta.shape:
            raise ValueError(f"{what}: pre sa/ta {tuple(sa.shape)} / "
                             f"{tuple(ta.shape)}, want ({nb}, 8, {c_in})")
        # row 0 of each image's (8, Ci) block, in x.dtype
        sa = sa[:, 0].to(x.dtype).contiguous()
        ta = ta[:, 0].to(x.dtype).contiguous()
        slope = float(torch.tensor(slope, dtype=x.dtype))
        named += [("sa", sa), ("ta", ta)]
    _check(what, *named)
    sfx = _suffix(what, x.dtype)
    y = torch.empty((*lead, hp - 1, w_out, c_out), dtype=x.dtype,
                    device=x.device)
    stats = (torch.zeros((nb * nd, 16, c_out), dtype=torch.float32,
                         device=x.device) if want_stats else None)
    if y.numel() == 0:
        return (y, stats) if want_stats else y
    # the deferred-norm operands, null for the part that is not wanted
    fused_args = (sa.data_ptr() if pre is not None else None,
                  ta.data_ptr() if pre is not None else None,
                  stats.data_ptr() if want_stats else None)
    slope = slope if pre is not None else 0.0
    if sfx == "f32":
        # K3 / K6b and K5 / K6c: one 3xTF32 entry each on the split
        # weights (exact, with their third part, for the forms with stats),
        # the deferred-norm operands or null (no variants)
        ws, w3 = (tf32x3_exact_weights(w) if want_stats
                  else (tf32x3_weights(w), None))
        if kd == 1:
            fn, fn_name = _entry("k3_f32", [_PTR] * 8 + [_INT] * 6 + [_FLT])
            lead_ints = (nb,)
        else:
            fn, fn_name = _entry("k5_f32", [_PTR] * 8 + [_INT] * 7 + [_FLT])
            lead_ints = (nb, nd)
        err = fn(x.data_ptr(), ws.data_ptr(),
                 w3.data_ptr() if want_stats else None, b.data_ptr(),
                 y.data_ptr(), *fused_args, *lead_ints, hp, wp8, c_in, c_out,
                 w_out, slope, _stream(x))
    elif kd == 3 and not fused:
        fn, fn_name = _entry("k5_bf16", [_PTR] * 4 + [_INT] * 7, variant)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 nb, nd, hp, wp8, c_in, c_out, w_out, *(variant or ()),
                 _stream(x))
    elif kd == 3:
        fn, fn_name = _entry("k6c_bf16",
                             [_PTR] * 7 + [_INT] * 7 + [_FLT], variant)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 *fused_args, nb, nd, hp, wp8, c_in, c_out, w_out, slope,
                 *(variant or ()), _stream(x))
    elif not fused:
        fn, fn_name = _entry("k3_bf16", [_PTR] * 4 + [_INT] * 6, variant)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 nb, hp, wp8, c_in, c_out, w_out, *(variant or ()),
                 _stream(x))
    else:
        fn, fn_name = _entry("k6b_bf16",
                             [_PTR] * 7 + [_INT] * 6 + [_FLT], variant)
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 *fused_args, nb, hp, wp8, c_in, c_out, w_out, slope,
                 *(variant or ()), _stream(x))
    kernels.check(err, fn_name)
    _count(counter, "fused_launches" if fused else "launches")
    return (y, stats) if want_stats else y


# ------------------------------------------------------------ wrappers

def pconv_pad11_cat(xa, xb, w, b=None, *, want_stats=False):
    """K1: fused concat + pad11. xa (N, h, w, Ca), xb (N, h, w, Cb), w
    (2, 2, Ca+Cb, Co) with input channels ordered [xa | xb] -> offset
    (N, h+1, wp8, Co). None when the shapes are not covered (w % 8, or a
    channel count % 128, nonzero; mismatched inputs).

    want_stats (K6a, the fused producer): the output also gets the full
    offset rim mask of true width w+1, and the call returns (y, stats)
    with stats (N, 16, Co) fp32 partials of the stored value."""
    refuse_grad("pconv_pad11_cat", xa, xb, w, b)
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
        return pconv_pad11_cat_plain(xa, xb, w, b, want_stats)
    return _launch_pad11(pconv_pad11_cat, xa, w.contiguous(),
                         b.contiguous(), xb=xb, want_stats=want_stats)


def pconv_pad11(x, w, b=None):
    """K4: aligned x (N, h, w, Ci), w (2, 2, Ci, Co) -> offset (N, h+1,
    wp8, Co), wp8 = round_up(w+1, 8), columns > w exact zeros (the caller's
    rim mask zeroes the usual parity rim). None when w % 8, Ci % 128 or
    Co % 128 is nonzero."""
    refuse_grad("pconv_pad11", x, w, b)
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


def pconv_valid(x, w, b=None, *, w_out=None, pre=None, want_stats=False,
                wide=False):
    """K3: offset x (N, hp, wp8, Ci), w (2, 2, Ci, Co) -> aligned
    (N, hp-1, w_out, Co), reading only columns 0..w_out of x. None when
    wp8 % 8, w_out % 8, Ci % 128 or Co % 128 is nonzero, or w_out + 1 >
    wp8.

    pre=(sa, ta, slope) with sa, ta (N, 8, Ci) and want_stats (K6b): the
    deferred-norm contract of the module docstring; with want_stats the
    call returns (y, stats). wide: the TPU kernel's doubled-N dot structure
    (one dot per kernel row over [W[s, 0] | W[s, 1]]); the same function,
    so the port computes it as the plain form does."""
    del wide
    refuse_grad("pconv_valid", x, w, b, *(pre or ())[:2])
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
        return pconv_valid_plain(x, w, b, w_out, pre, want_stats)
    return _launch_valid(pconv_valid, x, w.contiguous(), b.contiguous(),
                         w_out, pre, want_stats)


def pconv3_valid(x, w, b=None, *, w_out=None, pre=None, want_stats=False):
    """K5: offset x (B, D, hp, wp8, Ci), w (3, 2, 2, Ci, Co) -> aligned
    (B, D, hp-1, w_out, Co), SAME in z, reading only columns 0..w_out of
    x. None where K3 would be, or when w is not kd = 3.

    pre=(sa, ta, slope) with sa, ta (B, 8, Ci) per batch element and
    want_stats (K6c): the deferred-norm contract of the module docstring;
    stats come back per (b, z) image, (B*D, 16, Co)."""
    refuse_grad("pconv3_valid", x, w, b, *(pre or ())[:2])
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
        return pconv3_valid_plain(x, w, b, w_out, pre, want_stats)
    return _launch_valid(pconv3_valid, x, w.contiguous(), b.contiguous(),
                         w_out, pre, want_stats)


pconv_pad11_cat.launches = 0
pconv_pad11_cat.fused_launches = 0
pconv_pad11.launches = 0
pconv_valid.launches = 0
pconv_valid.fused_launches = 0
pconv3_valid.launches = 0
pconv3_valid.fused_launches = 0
