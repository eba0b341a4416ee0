"""A ConvNormAct's instance-norm tail: conv bias, instance norm, affine,
leaky ReLU and the offset rim, as two hand kernels on the card.

The packed forward (:mod:`rehrseg_tpu_torch.models.segnet_packed`) ends
every ConvNormAct in this tail. Its forms, by the conv output's layout:

- ``"offset"``: an offset-packed (B, D, hp, wp, 4C) tensor, rim (and the
  columns at or past ``true_w`` of a tensor stored wider) zeroed before
  the norm and after the activation; moments over the real pixels, the
  four (dy, dx) groups averaged (:func:`..ops.pack2d.instance_norm_packed`
  with ``offset_parity``);
- ``"aligned"``: an aligned-packed (B, D, h, w, 4C) tensor, no rim;
- ``"unpacked"``: a (B, D, H, W, C) tensor, one group.

It replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it. Run eagerly, the chain is eight to twelve passes over the conv
output (about 25 bytes moved per byte of tensor). On the card it is two
kernels of ``csrc/norm_act.cu``, bound by bytes (3 per byte of tensor):
:func:`norm_stats` reads the tensor once for each image's moments (kept
centred, merged with Chan's formula) and :func:`norm_act_apply` reads and
writes it once, with the eager chain's roundings, so given the same moments
its output is the eager chain's bit for bit.

:func:`norm_act` is the entry the forward calls: CPU tensors take the
plain version (:func:`norm_act_plain`, the eager chain, built from
:func:`..ops.pack2d.instance_norm_moments` and ``instance_norm_apply``);
CUDA tensors launch both kernels (counted in ``norm_act.launches``) and
raise ValueError where the kernels do not cover them
(:func:`norm_act_covers`): the forward sends only tails of the dtypes and
widths the kernels take (:func:`norm_act_takes`) here, so nothing falls
back unseen. Inputs that require grad in grad mode raise: the kernels
have no backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from .pack2d import (instance_norm_apply, instance_norm_moments,
                     offset_rim_mask)
from .pconv import refuse_grad

FORMS = ("offset", "aligned", "unpacked")

# the C launchers by dtype: (library of ``kernels.SOURCES``, entry declared
# ``extern "C"`` in its source)
C_ENTRIES = {
    "stats_bf16": ("norm_act", "norm_stats_bf16"),
    "stats_f32": ("norm_act", "norm_stats_f32"),
    "apply_bf16": ("norm_act", "norm_act_apply_bf16"),
    "apply_f32": ("norm_act", "norm_act_apply_f32"),
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# CTAs a pass aims at: about 8 per SM of the card's 132
_CTAS = 1056
# an apply CTA's rows: about 1 MB, fewer where that leaves under _CTAS
_APPLY_BYTES = 1 << 20
_MAX_C4 = 1024


def _groups(form: str) -> int:
    if form not in FORMS:
        raise ValueError(f"norm_act: unknown form {form!r}")
    return 1 if form == "unpacked" else 4


def _leaky(y, slope):
    return y if slope is None else F.leaky_relu(y, slope)


# ------------------------------------------------------------ plain version

def _rim(y, true_w):
    _, _, hp, wp, c4 = y.shape
    return offset_rim_mask(hp, wp, c4 // 4, y.dtype, y.device,
                           true_w=true_w)


def _tail_input(y, b, form, true_w):
    """The conv output with its bias, rim zeroed (offset form)."""
    if b is not None:
        y = y + b
    return y * _rim(y, true_w) if form == "offset" else y


def _moments(t, eps, form, true_w):
    return instance_norm_moments(t, eps, packed=_groups(form) == 4,
                                 offset_parity=form == "offset",
                                 true_w=true_w)


def _apply(t, m, k, scale, bias, slope, form, true_w):
    y = _leaky(instance_norm_apply(t, m, k, scale, bias), slope)
    return y * _rim(y, true_w) if form == "offset" else y


def norm_act_plain(y, b, scale, bias, *, eps, slope, form, true_w=None):
    """The plain version, the packed forward's eager chain: ``y + b``,
    the rim mask (offset form), :func:`..ops.pack2d.instance_norm_moments`
    and :func:`..ops.pack2d.instance_norm_apply` (moments in fp32, fp64
    for fp64 input; the normalize in y's dtype), ``F.leaky_relu``, the rim
    mask."""
    t = _tail_input(y, b, form, true_w)
    return _apply(t, *_moments(t, eps, form, true_w), scale, bias, slope,
                  form, true_w)


def norm_stats_plain(y, b, *, eps, form, true_w=None):
    """The plain version's moments (m, k), each (B, C4)."""
    return _moments(_tail_input(y, b, form, true_w), eps, form, true_w)


def norm_act_apply_plain(y, b, m, k, scale, bias, *, slope, form,
                         true_w=None):
    """The plain version's apply half, from given moments."""
    return _apply(_tail_input(y, b, form, true_w), m, k, scale, bias, slope,
                  form, true_w)


# ------------------------------------------------------------ the kernels

def norm_act_takes(dtype, c: int, form: str, *params) -> bool:
    """Whether the kernels are built for a tail of this dtype and width:
    bf16 or fp32, c channels a group (C4 = 4c packed, c unpacked) in whole
    16-byte vectors (c a multiple of 8), C4 <= 1024, and ``params`` (the
    bias and the affine parameters, None where absent) of the same dtype.
    The packed forward keeps every other tail on the plain version."""
    return (dtype in _SUFFIX and c > 0 and c % 8 == 0
            and c * _groups(form) <= _MAX_C4
            and all(t is None or t.dtype == dtype for t in params))


def norm_act_covers(y, b, scale, bias, form) -> bool:
    """Whether the kernels take this tail: :func:`norm_act_takes` of a 5-D
    y, laid out for them: y contiguous and 16-byte aligned, the bias and
    the affine parameters contiguous, 16-byte aligned and on y's
    device."""
    g = _groups(form)
    if y.ndim != 5 or y.shape[-1] % g or not norm_act_takes(
            y.dtype, y.shape[-1] // g, form, b, scale, bias):
        return False
    if not y.is_contiguous() or y.numel() == 0 or y.data_ptr() % 16:
        return False
    return all(t is None or (t.is_contiguous() and t.device == y.device
                             and t.data_ptr() % 16 == 0)
               for t in (b, scale, bias))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(key, argtypes):
    lib, fn_name = C_ENTRIES[key]
    fn = getattr(kernels.load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn, fn_name


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TICKETS: dict = {}


def _tickets(stream, n: int) -> torch.Tensor:
    """The moment pass's per-image ticket counters for launches on
    ``stream``: zeros, and left zero by every launch (the last CTA of an
    image resets its own). One buffer a stream (allocated on it, the
    current stream): launches on one stream run in order, and two streams
    never share counters."""
    key = (stream.device, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=stream.device)
        _TICKETS[key] = t
    return t


def _geometry(y, form, true_w):
    bsz, d, h, w, c4 = y.shape
    offset = form == "offset"
    tw = w if true_w is None else int(true_w)
    return (bsz, d * h, h, w, c4, c4 // _groups(form), int(offset), tw)


def _launch_stats(y, b, eps, form, true_w):
    geo = _geometry(y, form, true_w)
    bsz, rows, c4 = geo[0], geo[1], geo[4]
    per_image = max(1, _CTAS // bsz)
    rps = -(-rows // per_image)
    slabs = -(-rows // rps)
    part = torch.empty((bsz, slabs, 3, c4), dtype=torch.float32,
                       device=y.device)
    m = torch.empty((bsz, c4), dtype=torch.float32, device=y.device)
    k = torch.empty_like(m)
    fn, fn_name = _entry(f"stats_{_SUFFIX[y.dtype]}",
                         [_PTR] * 6 + [_INT] * 10 + [ctypes.c_double, _PTR])
    stream = torch.cuda.current_stream(y.device)
    err = fn(y.data_ptr(), _ptr(b), part.data_ptr(),
             _tickets(stream, bsz).data_ptr(), m.data_ptr(), k.data_ptr(),
             *geo, slabs, rps, float(eps), stream.cuda_stream)
    kernels.check(err, fn_name)
    return m, k


def _launch_apply(y, b, m, k, scale, bias, slope, form, true_w):
    geo = _geometry(y, form, true_w)
    bsz, rows = geo[0], geo[1]
    row_bytes = geo[3] * geo[4] * y.element_size()
    rpc = max(1, min(round(_APPLY_BYTES / row_bytes),
                     -(-bsz * rows // _CTAS)))
    out = torch.empty_like(y)
    fn, fn_name = _entry(f"apply_{_SUFFIX[y.dtype]}",
                         [_PTR] * 7 + [_INT] * 10 + [ctypes.c_float, _PTR])
    err = fn(y.data_ptr(), _ptr(b), m.data_ptr(), k.data_ptr(), _ptr(scale),
             _ptr(bias), out.data_ptr(), *geo, rpc, int(slope is not None),
             0.0 if slope is None else float(slope),
             torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(err, fn_name)
    return out


def _check_cuda(what, y, b, scale, bias, form):
    if not y.is_cuda:
        raise ValueError(f"{what}: y must be a CUDA tensor")
    if not norm_act_covers(y, b, scale, bias, form):
        raise ValueError(f"{what}: the kernel does not take y "
                         f"{tuple(y.shape)} {y.dtype} ({form})")


def norm_stats(y, b=None, *, eps, form, true_w=None):
    """The moment kernel alone: (m, k), each (B, C4) fp32, of a covered
    CUDA tensor (the card's tests and timings)."""
    refuse_grad("norm_stats", y, b)
    _check_cuda("norm_stats", y, b, None, None, form)
    with torch.cuda.device(y.device):
        return _launch_stats(y, b, eps, form, true_w)


def norm_act_apply(y, b, m, k, scale=None, bias=None, *, slope, form,
                   true_w=None):
    """The apply kernel alone, from given fp32 (B, C4) moments m and k."""
    refuse_grad("norm_act_apply", y, b, scale, bias)
    _check_cuda("norm_act_apply", y, b, scale, bias, form)
    m = m.to(device=y.device, dtype=torch.float32).contiguous()
    k = k.to(device=y.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(y.device):
        return _launch_apply(y, b, m, k, scale, bias, slope, form, true_w)


def norm_act(y, b, scale, bias, *, eps, slope, form, true_w=None):
    """The tail of a ConvNormAct: ``leaky(instance_norm(y + b) * scale +
    bias)`` in the layout ``form`` (see the module docstring), rim zeroed
    for an offset tensor. b: the conv bias in y's channel layout (4C for
    a packed tensor) or None; scale, bias: the norm's (C,) affine or None;
    slope None: no activation. CPU tensors take the plain version, CUDA
    tensors the two kernels; a CUDA tensor they do not cover
    (:func:`norm_act_covers`) raises ValueError."""
    refuse_grad("norm_act", y, b, scale, bias)
    if y.device.type == "cpu":
        return norm_act_plain(y, b, scale, bias, eps=eps, slope=slope,
                              form=form, true_w=true_w)
    _check_cuda("norm_act", y, b, scale, bias, form)
    with torch.cuda.device(y.device):
        m, k = _launch_stats(y, b, eps, form, true_w)
        out = _launch_apply(y, b, m, k, scale, bias, slope, form, true_w)
    norm_act.launches += 1
    return out


norm_act.launches = 0
