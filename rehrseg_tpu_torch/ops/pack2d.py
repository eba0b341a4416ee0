"""Space-to-depth (2x2 in-plane) packing for the sliding-window eval path
(subset of ``rehrseg_tpu.ops.pack2d``, in PyTorch).

Exact math, not an approximation: pack 2x2 in-plane pixel blocks into
channels (C -> 4C at half resolution, channel order (dy, dx, c)). Then a
SAME (1,3,3)/(3,3,3) stride-1 conv is a VALID (1,2,2)/(3,2,2) conv on the
OFFSET-packed input (cells shifted one pixel up-left), a strided conv is the
same packed conv with an unpacked output block, a kernel == stride
transposed conv is a pointwise conv straight into packed layout, and
instance-norm moments aggregate exactly over the four (dy, dx) groups.

Tensors are channels-last (..., H, W, C) as in the JAX package; weights are
in the flax layouts (DHWIO, HWIO). :func:`conv_general` runs a flax-layout
conv through ``F.conv2d``/``F.conv3d`` on a permuted view, so a
channels-last tensor reaches cuDNN as a channels-last (NHWC) input with no
layout copy.

The deferred ("fused") instance-norm glue (the JAX module's :591-686) is
at the end: moment partials to a per-image scale/shift, the masked
statistics of a cuDNN-emitted tensor, and the one-pass apply. It serves
the K6 forms of :mod:`rehrseg_tpu_torch.ops.pconv`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad_spec(pads) -> list:
    """numpy-style ((lo, hi) per dim, first dim first) -> F.pad's spec."""
    spec = []
    for lo, hi in reversed(list(pads)):
        spec += [int(lo), int(hi)]
    return spec


def pad_np(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero padding with ``np.pad``'s argument form."""
    return F.pad(x, _pad_spec(pads))


def conv_general(x: torch.Tensor, w: torch.Tensor, strides, pads,
                 ) -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC/HWIO or NDHWC/DHWIO dimension
    numbers. pads: (lo, hi) per spatial dim; negative values crop the input
    (the JAX package's negative right padding)."""
    nsp = x.ndim - 2
    crop = [slice(None)]
    conv_pad, extra = [], []
    for i, (lo, hi) in enumerate(pads):
        n = x.shape[1 + i]
        crop.append(slice(max(0, -lo), n + hi if hi < 0 else n))
        lo, hi = max(lo, 0), max(hi, 0)
        s = min(lo, hi)
        conv_pad.append(s)
        extra.append((lo - s, hi - s))
    x = x[tuple(crop)]
    if any(e != (0, 0) for e in extra):
        x = pad_np(x, [(0, 0)] + extra + [(0, 0)])
    xc = x.permute((0, nsp + 1) + tuple(range(1, nsp + 1)))
    wc = w.permute((nsp + 1, nsp) + tuple(range(nsp)))
    conv = F.conv2d if nsp == 2 else F.conv3d
    y = conv(xc, wc, None, stride=tuple(strides), padding=tuple(conv_pad))
    return y.permute((0,) + tuple(range(2, nsp + 2)) + (1,))


# ------------------------------------------------------------ layout ops

def space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/2, W/2, 4C), channel order (dy, dx, c)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, c)
    nd = x.ndim
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return x.permute(perm).reshape(*lead, h // 2, w // 2, 4 * c)


def depth_to_space_hw(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth_hw`."""
    return depth_to_space_cell(x, 2)


def depth_to_space_cell(x: torch.Tensor, cell: int) -> torch.Tensor:
    """(..., h, w, cell^2*C) -> (..., h*cell, w*cell, C), channel order
    (ey, ex, c)."""
    *lead, h2, w2, cc = x.shape
    c = cc // (cell * cell)
    x = x.reshape(*lead, h2, w2, cell, cell, c)
    nd = x.ndim
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return x.permute(perm).reshape(*lead, cell * h2, cell * w2, c)


def offset_pack_hw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/2+1, W/2+1, 4C): packed cells shifted one
    pixel up-left (cell i covers rows 2i-1, 2i), zero-padded at the rim."""
    nd = x.ndim
    return space_to_depth_hw(
        pad_np(x, [(0, 0)] * (nd - 3) + [(1, 1), (1, 1), (0, 0)]))


def offset_to_unpacked_hw(xp: torch.Tensor) -> torch.Tensor:
    """Offset-packed (..., h+1, w+1, 4C) -> unpacked (..., 2h, 2w, C)."""
    y = depth_to_space_hw(xp)
    return y[..., 1:-1, 1:-1, :]


def aligned_to_offset_hw(xp: torch.Tensor) -> torch.Tensor:
    """Aligned-packed (..., h, w, 4C) -> offset-packed (..., h+1, w+1, 4C):
    offset group (dy', dx') is aligned group (1-dy', 1-dx') shifted by
    (1-dy', 1-dx') cells."""
    *lead, h, w, c4 = xp.shape
    c = c4 // 4
    nlead = len(lead)

    def sh(k, di, dj):
        return pad_np(xp[..., k * c:(k + 1) * c],
                      [(0, 0)] * nlead + [(di, 1 - di), (dj, 1 - dj), (0, 0)])

    return torch.cat([sh(3, 1, 1), sh(2, 1, 0), sh(1, 0, 1), sh(0, 0, 0)],
                     dim=-1)


# ------------------------------------------------------------ weight packs

def pack_conv_weights(w: torch.Tensor, in_splits=None,
                      packed_out: bool = True,
                      aligned_in_strided: bool = False) -> torch.Tensor:
    """(kd, K, K, Ci, Co), K in (3, 5) -> (kd, S, S, 4Ci, 4Co if packed_out
    else Co), S = 2 for K = 3 and 4 for K = 5. Tap map for output group
    (dy, dx): T[k] = W[k - base - dy] with k = 2s + dy'.

    in_splits: channel sizes of concatenated packed inputs (the decoder
    concat); the packed input layout is then [pack(Ca) || pack(Cb)].
    packed_out=False: the strided-conv variant (output dy=dx=0 only);
    aligned_in_strided: the tap map for an ALIGNED-parity strided input."""
    kd, kh, kw, ci, co = w.shape
    assert kh == kw and kh in (3, 5), (kh, kw)
    in_splits = list(in_splits) if in_splits is not None else [ci]
    assert sum(in_splits) == ci
    if packed_out:
        out_groups = ((0, 0), (0, 1), (1, 0), (1, 1))
    elif aligned_in_strided:
        assert kh == 3
        out_groups = ((1, 1),)
    else:
        assert kh == 3
        out_groups = ((0, 0),)
    S = 2 if kh == 3 else 4
    base = (2 * S - kh - 1) // 2

    row_blocks = []
    ci_off = 0
    for cs in in_splits:
        wblk = w[:, :, :, ci_off:ci_off + cs]
        cols = []
        for dy, dx in out_groups:
            t = pad_np(wblk, ((0, 0),
                              (base + dy, 2 * S - kh - base - dy),
                              (base + dx, 2 * S - kh - base - dx),
                              (0, 0), (0, 0)))
            t = t.reshape(kd, S, 2, S, 2, cs, co)
            t = t.permute(0, 1, 3, 2, 4, 5, 6)
            cols.append(t.reshape(kd, S, S, 4 * cs, co))
        row_blocks.append(torch.cat(cols, dim=-1))
        ci_off += cs
    return torch.cat(row_blocks, dim=3)


def _pack_cell4(w: torch.Tensor, kd_out: int) -> list:
    """Columns of the (4,4)-cell kernels: one (kd_out, 5, 5, 4Ci, Co) block
    per output group (ey, ex), ey, ex in 0..3, k = 2s - 1 + dy - ey."""
    _, kh, kw, ci, co = w.shape
    assert kh == 5 and kw == 5, (kh, kw)
    S, base = 5, 1
    cols = []
    for ey in range(4):
        for ex in range(4):
            t = pad_np(w, ((0, 0),
                           (base + ey, 2 * S - kh - base - ey),
                           (base + ex, 2 * S - kh - base - ex),
                           (0, 0), (0, 0)))
            t = t.reshape(kd_out, S, 2, S, 2, ci, co)
            t = t.permute(0, 1, 3, 2, 4, 5, 6)
            cols.append(t.reshape(kd_out, S, S, 4 * ci, co))
    return cols


def pack_conv_weights_cell4(w: torch.Tensor) -> torch.Tensor:
    """(kd, 5, 5, Ci, Co) -> (kd, 5, 5, 4Ci, 16Co): the stride-(2,2) packed
    conv from OFFSET (2,2)-packed input to ALIGNED (4,4)-cell output."""
    return torch.cat(_pack_cell4(w, w.shape[0]), dim=-1)


def pack_bias_cell4(b: torch.Tensor) -> torch.Tensor:
    return b.repeat(16)


def pack_conv_weights_cell4z2(w: torch.Tensor) -> torch.Tensor:
    """(5, 5, 5, Ci, Co) -> (6, 5, 5, 4Ci, 32Co): the cell4 kernel with a
    z-pair folded into the output too (output group (ez, ey, ex), z tap
    k_z = s6 - ez)."""
    kd, kh, kw, ci, co = w.shape
    assert kd == 5 and kh == 5 and kw == 5, (kd, kh, kw)
    cols = []
    for ez in range(2):
        wz = pad_np(w, ((ez, 1 - ez), (0, 0), (0, 0), (0, 0), (0, 0)))
        cols += _pack_cell4(wz, 6)
    return torch.cat(cols, dim=-1)


def pack_bias_cell4z2(b: torch.Tensor) -> torch.Tensor:
    return b.repeat(32)


def conv_packed_s2_cell4z2(xp: torch.Tensor, wp: torch.Tensor,
                           b) -> torch.Tensor:
    """OFFSET (2,2)-packed (B, D, H/2+1, W/2+1, 4Ci) -> z-paired ALIGNED
    (4,4)-cell (B, D/2, H/4, W/4, 32Co): one stride-(2,2,2) conv."""
    y = conv_general(xp, wp, (2, 2, 2), ((2, 3), (1, 1), (1, 1)))
    return y + b if b is not None else y


def conv_packed_s2_cell4(xp: torch.Tensor, wp: torch.Tensor,
                         b) -> torch.Tensor:
    """OFFSET (2,2)-packed -> ALIGNED (4,4)-cell (B, D, H/4, W/4, 16Co):
    one stride-(2,2) conv, padding (1,1). kd==1 folds D into the batch."""
    kd = wp.shape[0]
    hw = ((1, 1), (1, 1))
    if kd == 1:
        bsz, d = xp.shape[:2]
        y = conv_general(xp.reshape(bsz * d, *xp.shape[2:]), wp[0], (2, 2),
                         hw)
        y = y.reshape(bsz, d, *y.shape[1:])
    else:
        y = conv_general(xp, wp, (1, 2, 2), ((kd // 2, kd // 2),) + hw)
    return y + b if b is not None else y


def fused_upsample_conv1(feats: torch.Tensor, w1: torch.Tensor, b1,
                         upscale: int,
                         align_corners: bool = True) -> torch.Tensor:
    """[linear z-upsample by ``upscale``] then [SAME 3^3 packed conv,
    aligned -> offset], reordered as one 2D packed conv at LR depth and one
    composite z-matmul (exact: both are linear). feats (B, D, hp, wp, 4Ci)
    ALIGNED -> OFFSET (B, D*upscale, hp+1, wp+1, 4Co)."""
    from .bspline import trilinear_upsample_matrix
    kd = w1.shape[0]
    assert kd == 3, kd
    d = feats.shape[1]
    z = d * upscale
    wp1 = pack_conv_weights(w1)              # (3, 2, 2, 4Ci, 4Co)
    co4 = wp1.shape[-1]
    wk = wp1.permute(1, 2, 3, 0, 4).reshape(1, 2, 2, wp1.shape[3], kd * co4)
    y = conv_packed(feats, wk, None, hw_pad="pad11")
    u = np.pad(trilinear_upsample_matrix(d, upscale, align_corners),
               ((1, 1), (0, 0)))
    bz = torch.tensor(np.stack([u[k:k + z] for k in range(kd)], axis=-1),
                      dtype=feats.dtype, device=feats.device)   # (Z, D, kd)
    y = y.reshape(*y.shape[:-1], kd, co4)
    h1 = torch.einsum("bdhwkc,zdk->bzhwc", y, bz)
    if b1 is not None:
        h1 = h1 + pack_bias(b1)
    return h1


def unpack_cell4z2(out: torch.Tensor, ncl: int) -> list:
    """(B, D/2, h4, w4, 32*ncl) -> list of ncl (B, D, H, W) HR volumes;
    channel order (ez, ey, ex, c)."""
    bsz, d2, h4, w4, _ = out.shape
    planes = []
    for c in range(ncl):
        pc = out[..., c::ncl]
        pc = pc.reshape(bsz, d2, h4, w4, 2, 16)
        pc = pc.permute(0, 1, 4, 2, 3, 5)
        pc = pc.reshape(bsz, 2 * d2, h4, w4, 16)
        planes.append(depth_to_space_cell(pc, 4)[..., 0])
    return planes


def pack_conv_weights_from_unpacked(w: torch.Tensor) -> torch.Tensor:
    """(kd, 3, 3, Ci, Co) -> (kd, 4, 4, Ci, 4Co): an unpacked -> packed conv
    in one pass; W4[r] = W[r - dy]. The same weights serve aligned output
    (pad (1,1)) and offset output (pad (2,2))."""
    kd, kh, kw, ci, co = w.shape
    assert kh == 3 and kw == 3
    cols = [pad_np(w, ((0, 0), (dy, 1 - dy), (dx, 1 - dx), (0, 0), (0, 0)))
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return torch.cat(cols, dim=-1)


def conv_packing(x: torch.Tensor, w4: torch.Tensor, b, *,
                 offset_out: bool = False,
                 out_w: int | None = None) -> torch.Tensor:
    """Unpacked (B, D, H, W, Ci) -> packed (B, D, H/2[+1], W/2[+1], 4Co)
    via the (kd, 4, 4) stride-(2,2) kernel of
    :func:`pack_conv_weights_from_unpacked`. kd==1 folds D into the batch.

    out_w (offset_out only): emit the offset tensor out_w cells wide (the
    8-aligned layout the pconv kernels read); the extra columns convolve
    zero input, so they hold the bias until the caller's
    ``offset_rim_mask(true_w=W/2+1)`` zeroes them."""
    kd = w4.shape[0]
    hw = ((2, 2), (2, 2)) if offset_out else ((1, 1), (1, 1))
    if offset_out and out_w is not None:
        extra = out_w - (x.shape[3] // 2 + 1)
        assert extra >= 0, (out_w, x.shape)
        hw = (hw[0], (2, 2 + 2 * extra))
    if kd == 1:
        bsz, d = x.shape[:2]
        y = conv_general(x.reshape(bsz * d, *x.shape[2:]), w4[0], (2, 2), hw)
        y = y.reshape(bsz, d, *y.shape[1:])
    else:
        y = conv_general(x, w4, (1, 2, 2), ((kd // 2, kd // 2),) + hw)
    return y + b if b is not None else y


def pack_pointwise_weights(w: torch.Tensor) -> torch.Tensor:
    """1x1 conv weights (Ci, Co) -> block-diagonal packed (4Ci, 4Co)."""
    return torch.block_diag(w, w, w, w)


def offset_rim_mask(hp: int, wp: int, c: int, dtype, device=None,
                    true_w: int | None = None) -> torch.Tensor:
    """(hp, wp, 4c) 0/1 mask zeroing an offset-packed tensor's rim slots
    (pixel positions outside the image). true_w: the true offset width of a
    tensor stored wider (K1's 8-aligned layout): columns >= true_w zero
    entirely and the right-rim mask applies at true_w - 1."""
    tw = wp if true_w is None else true_w
    ih = torch.arange(hp, device=device).view(hp, 1, 1)
    iw = torch.arange(wp, device=device).view(1, wp, 1)
    g = torch.arange(4, device=device).view(1, 1, 4)
    dy, dx = g // 2, g % 2
    ok = (((ih > 0) | (dy == 1)) & ((ih < hp - 1) | (dy == 0))
          & ((iw > 0) | (dx == 1)) & ((iw < tw - 1) | (dx == 0))
          & (iw < tw))
    return ok.to(dtype).repeat_interleave(c, dim=-1)


def pack_transpconv_weights(wt: torch.Tensor) -> torch.Tensor:
    """Stride == kernel (kd, 2, 2) transposed-conv weights in the flax
    transpose_kernel layout (kd, 2, 2, Co, Ci), direct (unflipped) spatial
    indexing -> pointwise packed weights (kd, Ci, 4Co)."""
    kd, two_a, two_b, co, ci = wt.shape
    assert two_a == 2 and two_b == 2
    return wt.permute(0, 4, 1, 2, 3).reshape(kd, ci, 4 * co)


# ------------------------------------------------------------ packed ops

_HW_PADS = {
    "valid": ((0, 0), (0, 0)),   # offset in  -> aligned / strided out
    "pad11": ((1, 1), (1, 1)),   # aligned in -> offset out
    "pad10": ((1, 0), (1, 0)),   # aligned in -> strided (unpacked) out
}


def conv_packed(xp: torch.Tensor, wp: torch.Tensor, b, *,
                d_stride: int = 1, hw_pad: str = "valid",
                out_w: int | None = None,
                in_w: int | None = None) -> torch.Tensor:
    """Packed 2x2-cell conv. xp (B, D, h', w', 4Ci); wp (kd, S, S, 4Ci,
    Cout'). kd==1 folds D into the batch; kd==3 is a 5D conv, SAME along D.
    Bias b is in the output layout or None.

    out_w ('pad11' only): emit the offset output out_w columns wide (the
    8-aligned layout); the extra columns convolve zero input and hold the
    bias until the caller's ``offset_rim_mask(true_w=w'+1)`` zeroes them.
    The one-sided pad is a symmetric conv pad plus an explicit right pad
    (:func:`conv_general`).

    in_w ('valid' only): the TRUE width of an offset input stored wider
    (the 8-aligned layout); only those columns are read."""
    kd = wp.shape[0]
    hw = _HW_PADS[hw_pad]
    if hw_pad == "pad11" and out_w is not None:
        extra = out_w - (xp.shape[3] + 1)
        assert extra >= 0, (out_w, xp.shape)
        hw = (hw[0], (1, 1 + extra))
    if hw_pad == "valid" and wp.shape[1] == 4:
        hw = ((1, 1), (1, 1))
    if hw_pad == "valid" and in_w is not None and in_w != xp.shape[3]:
        assert in_w < xp.shape[3], (in_w, xp.shape)
        hw = (hw[0], (hw[1][0], hw[1][1] + in_w - xp.shape[3]))
    if kd == 1:
        bsz, d = xp.shape[:2]
        y = conv_general(xp.reshape(bsz * d, *xp.shape[2:]), wp[0], (1, 1),
                         hw)
        y = y.reshape(bsz, d, *y.shape[1:])
    else:
        y = conv_general(xp, wp, (d_stride, 1, 1), ((kd // 2, kd // 2),) + hw)
    return y + b if b is not None else y


def conv_packed_h(wp: torch.Tensor, hw_pad: str = "valid") -> tuple:
    """(kernel rows, (lo, hi) H padding) of :func:`conv_packed` with
    weights ``wp`` and ``hw_pad``: what a caller that splits H needs."""
    if hw_pad == "valid" and wp.shape[1] == 4:
        return 4, (1, 1)
    return wp.shape[1], _HW_PADS[hw_pad][0]


def pointwise_packed_transpconv(x: torch.Tensor, wp: torch.Tensor,
                                b) -> torch.Tensor:
    """x (B, D, h, w, Ci) unpacked; wp (kd, Ci, 4Co). kd==1: output aligned
    (B, D, h, w, 4Co); kd==2: D doubles."""
    kd = wp.shape[0]
    if kd == 1:
        y = torch.matmul(x, wp[0])
    else:
        y = torch.einsum("bdhwc,kce->bdkhwe", x, wp)
        bsz, d, k, h, w, e = y.shape
        y = y.reshape(bsz, d * k, h, w, e)
    return y + b if b is not None else y


def pack_bias(b: torch.Tensor) -> torch.Tensor:
    """(C,) -> (4C,) tiled over the four (dy, dx) groups."""
    return b.repeat(4)


def stats_dtype(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype a norm's moments are taken in: fp32, or x's own
    dtype where that is wider (fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def instance_norm_packed(xp: torch.Tensor, scale, bias,
                         epsilon: float = 1e-5,
                         offset_parity: bool = False,
                         true_w: int | None = None) -> torch.Tensor:
    """InstanceNorm over the true spatial extent of a packed tensor
    (B, D, h, w, 4C): per-channel moments are the group-averaged moments of
    the four (dy, dx) groups, taken in fp32 (fp64 for fp64 input,
    :func:`stats_dtype`); the normalize runs in
    ``xp.dtype``. offset_parity: rim already masked to zero, (h-1)*(w-1)
    real pixels per group, var = E[x^2] - E[x]^2. true_w: true offset width
    of a widened tensor (pad columns are zeros and do not count)."""
    b_, d, h, w, c4 = xp.shape
    c = c4 // 4

    def group_mean(t):
        return t.reshape(b_, 4, c).mean(1).repeat(1, 4)

    x32 = stats_dtype(xp)
    if offset_parity:
        n = d * (h - 1) * ((true_w if true_w is not None else w) - 1)
        m1 = group_mean(x32.sum((1, 2, 3)) / n)
        m2 = group_mean(x32.square().sum((1, 2, 3)) / n)
        v = m2 - m1.square()
    else:
        m1 = group_mean(x32.mean((1, 2, 3)))
        vg = (x32 - m1[:, None, None, None, :]).square().mean((1, 2, 3))
        v = group_mean(vg)
    k = torch.rsqrt(v + epsilon)
    y = (xp - m1[:, None, None, None, :].to(xp.dtype)) \
        * k[:, None, None, None, :].to(xp.dtype)
    if scale is not None:
        y = y * scale.repeat(4) + bias.repeat(4)
    return y


# ------------------------------------------- deferred (fused) instance norm
#
# Under pallas_conv="fused" an offset conv's instance norm is deferred: the
# producer emits per-image moment partials (a kernel's ``want_stats``, or
# :func:`offset_stats_xla` for a cuDNN-emitted tensor), this glue turns them
# into a per-image scale/shift, and the consuming VALID conv kernel applies
# ``leaky(x * sA + tA) * rim_mask`` to its input as it loads it (``pre=``).
# Stats layout everywhere: (N, 16, C) fp32, rows 0:8 partial sums, rows 8:16
# partial sums of squares; consumers sum each half.


def norm_scale_shift_from_stats(stats: torch.Tensor, b: int, d: int,
                                count: int, scale, bias, epsilon: float,
                                dtype) -> tuple:
    """(B*D, 16, C4) moment partials -> per-image (B*D, 8, C4) scale and
    shift in ``dtype`` such that ``x * sA + tA`` is
    :func:`instance_norm_packed` (group-averaged fp32 moments, variance as
    E[x^2] - E[x]^2). The 8 rows repeat one row."""
    c4 = stats.shape[-1]
    c = c4 // 4
    s = stats[:, 0:8].sum(1).reshape(b, d, c4).sum(1)
    q = stats[:, 8:16].sum(1).reshape(b, d, c4).sum(1)

    def group_mean(t):
        return t.reshape(b, 4, c).mean(1).repeat(1, 4)

    m1 = group_mean(s / count)
    m2 = group_mean(q / count)
    k = torch.rsqrt(m2 - m1.square() + epsilon)
    if scale is not None:
        g4 = scale.repeat(4).float()
        b4 = bias.repeat(4).float()
    else:
        g4, b4 = 1.0, 0.0
    sa = (k * g4).to(dtype)
    ta = (b4 - m1 * k * g4).to(dtype)

    def rep(t):
        return t[:, None, None, :].expand(b, d, 8, c4).reshape(b * d, 8, c4)

    return rep(sa), rep(ta)


def _stats_rows(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-image sums (N, C) and sums of squares -> (N, 16, C) partials
    (row 0 and row 8 hold them, the other rows zero)."""
    n, c = s.shape
    out = torch.zeros((n, 16, c), dtype=torch.float32, device=s.device)
    out[:, 0] = s
    out[:, 8] = q
    return out


def offset_stats_xla(y: torch.Tensor, true_w: int | None = None):
    """Masked moment partials of a cuDNN-emitted offset tensor
    y (B, D, hp, wp, C4) -> (B*D, 16, C4) fp32: the rim mask rides the
    reduction, so the raw conv output needs no mask pass."""
    bsz, d, hp, wp, c4 = y.shape
    m = offset_rim_mask(hp, wp, c4 // 4, torch.float32, y.device,
                        true_w=true_w)
    y32 = y.float() * m
    return _stats_rows(y32.sum((2, 3)).reshape(bsz * d, c4),
                       y32.square().sum((2, 3)).reshape(bsz * d, c4))


def aligned_stats_xla(y: torch.Tensor):
    """Moment partials of an aligned tensor y (B, D, h, w, C4) ->
    (B*D, 16, C4) fp32 (no rim on aligned parity)."""
    bsz, d, h, w, c4 = y.shape
    y32 = y.float()
    return _stats_rows(y32.sum((2, 3)).reshape(bsz * d, c4),
                       y32.square().sum((2, 3)).reshape(bsz * d, c4))


def leaky_scale_shift(y: torch.Tensor, sa: torch.Tensor, ta: torch.Tensor,
                      slope: float) -> torch.Tensor:
    """``leaky(y * sa + ta)`` in y.dtype, rounding after the multiply, the
    add and the leaky product, with the slope rounded to y.dtype (the JAX
    package's order). sa, ta broadcast against y."""
    z = y * sa.to(y.dtype) + ta.to(y.dtype)
    return torch.where(z >= 0, z,
                       z * torch.tensor(slope, dtype=z.dtype, device=z.device))


def apply_norm_act_packed(y: torch.Tensor, sa: torch.Tensor,
                          ta: torch.Tensor, slope: float,
                          offset_parity: bool = False,
                          true_w: int | None = None) -> torch.Tensor:
    """Materialize a deferred norm: ``leaky(y*sA + tA) [* rim_mask]`` in
    one pass, for a deferred tensor whose consumer is not a K6 kernel
    (stage outputs, heads, strided convs). y (B, D, hp, wp, C4); sa/ta
    (B*D, 8, C4) from :func:`norm_scale_shift_from_stats`."""
    bsz, d, hp, wp, c4 = y.shape
    z = leaky_scale_shift(y, sa[:, 0].reshape(bsz, d, 1, 1, c4),
                          ta[:, 0].reshape(bsz, d, 1, 1, c4), slope)
    if offset_parity:
        z = z * offset_rim_mask(hp, wp, c4 // 4, z.dtype, z.device,
                                true_w=true_w)
    return z
