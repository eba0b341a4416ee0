"""Space-to-depth packed SegModel forward for the sliding-window eval path
(``rehrseg_tpu.models.segnet_packed`` in PyTorch).

Consumes standard SegModel parameters in the flax layout (a ``{"params":
...}`` tree of tensors, :func:`rehrseg_tpu_torch.models.convert.
flax_tree_from_module` gives one for a module) and computes the
mathematically identical forward with the high-resolution low-channel
stages in packed 2x2 layout (:mod:`rehrseg_tpu_torch.ops.pack2d`): layout
changes ride inside convs, parities alternate through a stage so each
encoder stage ends ALIGNED, and offset-parity tensors carry a one-pixel rim
masked to zero around each offset conv's norm and activation.

``pallas_conv="cat"`` routes the decoder skip concat of kd=1 stages through
K1 (:func:`rehrseg_tpu_torch.ops.pconv.pconv_pad11_cat`), whose output is
stored at an 8-aligned width with the true width tracked beside it; the
next VALID conv reads only the true columns. ``pallas_conv=True`` routes
every covered stride-1 packed conv through a kernel of
:mod:`rehrseg_tpu_torch.ops.pconv`: K4 at kd=1 aligned->offset convs, K3
(kd=1) and K5 (kd=3) at offset->aligned convs, K1 at the concat; every
offset tensor is then emitted 8-aligned wide (by the kernels, or by a
widened cuDNN conv whose pad columns the rim mask zeroes).

``pallas_conv="fused"`` is "cat" plus the deferred instance norm: an
offset conv output whose next conv is a covered VALID conv comes back as a
:class:`_Deferred` (raw tensor plus per-image scale and shift, from K6a's
statistics or one masked reduction of a cuDNN output), the consuming K6b
(kd=1) or K6c (kd=3) kernel applies ``leaky(x*sa + ta) * rim_mask`` as it
loads its input, and the aligned output finalizes in one pass from that
kernel's statistics.

Training runs it with ``pallas_conv=False`` through autograd (the kernels
have no backward; their wrappers refuse inputs that require grad):
``return_skips`` hands back the unpacked encoder skips (the distillation
student), and ``remat`` checkpoints stages with
``torch.utils.checkpoint`` (False, "hires" or True).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import pconv
from ..ops.bspline import upsample_axis_linear
from ..ops.pack2d import (
    space_to_depth_hw, depth_to_space_hw, offset_to_unpacked_hw,
    pack_conv_weights, pack_conv_weights_from_unpacked,
    pack_transpconv_weights, pack_pointwise_weights, pack_bias,
    conv_general, conv_packed, conv_packing, pointwise_packed_transpconv,
    instance_norm_packed, offset_rim_mask,
    pack_conv_weights_cell4, pack_bias_cell4, conv_packed_s2_cell4,
    depth_to_space_cell,
    pack_conv_weights_cell4z2, conv_packed_s2_cell4z2, unpack_cell4z2,
    pack_bias_cell4z2, fused_upsample_conv1,
    norm_scale_shift_from_stats, offset_stats_xla, apply_norm_act_packed,
    stats_dtype, conv_packed_h,
)
from ..parallel import spatial as sp


def _to3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _instance_norm(x, scale, bias, eps):
    """Statistics in fp32 whatever the compute dtype (fp64 for fp64
    input); the normalize stays in x.dtype (the JAX package's bf16
    serving numerics)."""
    if isinstance(x, sp.HBlocks):
        return sp.instance_norm(x, scale, bias, eps)
    spatial = tuple(range(1, x.ndim - 1))
    x32 = stats_dtype(x)
    m = x32.mean(spatial, keepdim=True)
    v = x32.var(spatial, correction=0, keepdim=True)
    y = (x - m.to(x.dtype)) * torch.rsqrt(v + eps).to(x.dtype)
    if scale is not None:
        y = y * scale + bias
    return y


def _conv_std(x, w, b, strides):
    def fn(t, w_, b_):
        pad = tuple((k // 2, k // 2) for k in w_.shape[:3])
        y = conv_general(t, w_, strides, pad)
        return y + b_ if b_ is not None else y

    k = w.shape[1]
    return sp.conv(fn, x, w, b, k=k, s=strides[1], pad=(k // 2, k // 2),
                   tag="conv_std")


def _transpconv_std(x, wt, b, strides):
    """Stride == kernel transposed conv; wt in the flax transpose_kernel
    layout (*K, O, I), direct spatial indexing (= torch's (I, O, *K))."""
    def fn(t, wt_, b_):
        y = F.conv_transpose3d(t.permute(0, 4, 1, 2, 3),
                               wt_.permute(4, 3, 0, 1, 2), None,
                               stride=tuple(strides))
        y = y.permute(0, 2, 3, 4, 1)
        return y + b_ if b_ is not None else y

    return sp.local(fn, x, wt, b, scale=strides[1])


def _cat(*ts):
    return torch.cat(ts, dim=-1)


def _leaky(x, slope):
    return sp.local(F.leaky_relu, x, slope)


def _packing(x, w4, b, *, offset_out=False, out_w=None):
    """:func:`conv_packing` (a (kd, 4, 4) stride-(2, 2) conv, H padded
    (2, 2) for offset output, else (1, 1)), sharded along H for an
    HBlocks."""
    return sp.conv(lambda t, w_, b_: conv_packing(
        t, w_, b_, offset_out=offset_out, out_w=out_w), x, w4, b, k=4, s=2,
        pad=(2, 2) if offset_out else (1, 1), tag="conv_packing")


def _packed(x, wp, b, *, d_stride=1, hw_pad="valid", out_w=None,
            in_w=None):
    """:func:`conv_packed` (an (S, S) stride-1 packed conv, H padded as
    ``hw_pad`` says), sharded along H for an HBlocks."""
    k, pad = conv_packed_h(wp, hw_pad)
    return sp.conv(lambda t, w_, b_: conv_packed(
        t, w_, b_, d_stride=d_stride, hw_pad=hw_pad, out_w=out_w,
        in_w=in_w), x, wp, b, k=k, pad=pad, tag=f"conv_packed_{hw_pad}")


def _k1_cat(xs, w, b):
    """K1 on an aligned pair of (B, D, h, w, C) tensors (D folded into the
    batch), for an H block of a spatial forward."""
    xa, xb = xs
    bsz, d = xa.shape[0], xa.shape[1]
    r = pconv.pconv_pad11_cat(
        xa.reshape(bsz * d, *xa.shape[2:]).contiguous(),
        xb.reshape(bsz * d, *xb.shape[2:]).contiguous(), w, b)
    return r.reshape(bsz, d, *r.shape[1:])


def _norm_packed(y, scale, nbias, eps, **kw):
    if isinstance(y, sp.HBlocks):
        return sp.instance_norm_packed(y, scale, nbias, eps, **kw)
    return instance_norm_packed(y, scale, nbias, eps, **kw)


def _unpack(x, layout, tw=None):
    if layout == "a":
        return sp.local(depth_to_space_hw, x, scale=2)
    if layout == "o":
        if isinstance(x, sp.HBlocks):
            # an offset block's unpacked rows straddle the next block's
            # first row; no path of the forward unpacks an offset tensor
            # at a level that runs sharded, so this gathers and splits
            return sp.split(_unpack(sp.gather(x), layout, tw), x.group)
        if tw is not None and tw != x.shape[3]:
            x = x[:, :, :, :tw]      # strip K1's pad columns
        return offset_to_unpacked_hw(x)
    return x


def _true_hw(x, layout, tw=None):
    if layout == "a":
        return x.shape[2] * 2, x.shape[3] * 2
    if layout == "o":
        w = x.shape[3] if tw is None else tw
        return (x.shape[2] - 1) * 2, (w - 1) * 2
    return x.shape[2], x.shape[3]


def _packable(kernel, h, w, feats, pack_max_channels):
    return (feats <= pack_max_channels and kernel[1] == 3 and kernel[2] == 3
            and h % 2 == 0 and w % 2 == 0)


def _mask_offset(y, c, tw=None):
    """y times the offset rim mask; an H block takes its global rows of
    it (only the outermost blocks hold a rim row)."""
    hp, wp = y.shape[2], y.shape[3]
    return sp.local_rows(lambda t, r0, r1: t * offset_rim_mask(
        hp, wp, c, t.dtype, t.device, true_w=tw)[r0:r1], y)


def _round8(v):
    return -(-v // 8) * 8


class _Deferred:
    """A conv output whose instance norm is deferred (pallas_conv="fused"):
    ``y`` is the raw offset-parity tensor (rim zeroed when K6a produced it,
    bias-valued when cuDNN did; consumers mask either way), and
    ``leaky(y*sa + ta) * rim_mask`` is the finalized activation. The next
    conv of the stage applies that transform as it loads its input (K6b,
    K6c ``pre=``); :meth:`materialize` is the one-pass fallback for every
    other consumer."""

    def __init__(self, y, sa, ta, slope, true_w):
        self.y = y
        self.sa = sa
        self.ta = ta
        self.slope = slope
        self.true_w = true_w

    def materialize(self):
        return apply_norm_act_packed(self.y, self.sa, self.ta, self.slope,
                                     offset_parity=True, true_w=self.true_w)


def _fused_consumable(feats, out_tw, kd):
    """Will the next conv of this stage (same kernel size and feats) be a
    covered fused VALID consumer of a widened offset tensor? Gates the
    widened emission and the deferral (the checks mirror K3/K5 coverage)."""
    return (feats * 4) % 128 == 0 and (out_tw - 1) % 8 == 0 and kd in (1, 3)


def _defer_offset(y, stats, scale, nbias, eps, slope, true_w):
    """A :class:`_Deferred` from an offset conv output and its moment
    partials."""
    bsz, d, hp = y.shape[0], y.shape[1], y.shape[2]
    count = d * (hp - 1) * ((true_w if true_w is not None
                             else y.shape[3]) - 1)
    sa, ta = norm_scale_shift_from_stats(stats, bsz, d, count, scale,
                                         nbias, eps, y.dtype)
    return _Deferred(y, sa, ta, slope, true_w)


def _conv_norm_act(x, layout, cp, kernel, stride, feats, a, *,
                   pack_max_channels, want_out="a", in_splits=None,
                   tw=None, pallas=False):
    """One ConvNormAct. x in layout 'u'/'a'/'o'; returns (y, layout', tw').

    x may be a PAIR (xa, xb) of aligned-packed tensors standing for their
    channel concat (the decoder skip concat, in_splits giving the unpacked
    channel sizes). With pallas="cat" a covered kd=1 pair feeds K1 and the
    concat is never built; every other path concatenates here.
    tw: the TRUE offset width when layout == 'o' and x is stored wider.
    pallas=True routes every covered stride-1 packed conv through K1/K3/K4/
    K5, with offset outputs emitted 8-aligned wide. pallas="fused" is "cat"
    plus the deferred norm: an offset output whose consumer is covered
    comes back as a :class:`_Deferred` (K6a emits its statistics; a cuDNN
    output gets one masked reduction), the consuming K6b/K6c applies the
    norm as it loads, and the aligned output finalizes from its
    statistics in one pass. x may be a :class:`_Deferred`."""
    pallas_all = pallas is True
    pallas_fused = pallas == "fused"
    pallas_cat = bool(pallas)
    pair = isinstance(x, (tuple, list))
    if pair and (layout != "a" or len(x) != 2 or not pallas_cat):
        x = sp.local(_cat, *x)
        pair = False
    deferred = isinstance(x, _Deferred)
    x0 = x.y if deferred else (x[0] if pair else x)

    w = cp["conv"]["kernel"]
    b = cp["conv"].get("bias")
    scale = cp["norm"]["scale"] if a["norm_affine"] else None
    nbias = cp["norm"]["bias"] if a["norm_affine"] else None
    eps, slope = a["norm_eps"], a["nonlin_slope"]

    h, wd = _true_hw(x0, layout, tw)
    strided = stride[1] == 2 and stride[2] == 2
    otw = tw if tw is not None else (x0.shape[3] if layout == "o" else None)

    # the packed dispatch implements (1,1,1) and (d,2,2) with the D-stride
    # carried by a kd>1 conv; any other stride takes the standard path
    packed_stride_ok = (tuple(stride) == (1, 1, 1)
                        or (strided and (kernel[0] > 1 or stride[0] == 1)))
    # a strided conv emits unpacked output either way, so a packed input is
    # consumed packed whatever the channel threshold
    strided_packable = (strided and layout in ("a", "o")
                        and kernel[1] == 3 and kernel[2] == 3)
    take_packed = packed_stride_ok and (
        strided_packable or _packable(kernel, h, wd, feats,
                                      pack_max_channels))

    # only the fused offset -> aligned kernels below consume a deferred
    # input; every other path materializes it first
    if deferred and not (pallas_fused and take_packed and not strided
                         and layout == "o"):
        x = x.materialize()
        x0 = x
        deferred = False

    if take_packed:
        if strided and layout != "u":
            if pair:
                x = sp.local(_cat, *x)
                pair = False
            if layout == "a":
                wp = pack_conv_weights(w, in_splits=in_splits,
                                       packed_out=False,
                                       aligned_in_strided=True)
                y = _packed(x, wp, b, d_stride=stride[0], hw_pad="pad10")
            else:
                wp = pack_conv_weights(w, in_splits=in_splits,
                                       packed_out=False)
                y = _packed(x, wp, b, d_stride=stride[0], in_w=otw)
            y = _instance_norm(y, scale, nbias, eps)
            return _leaky(y, slope), "u", None

        if not strided:
            kd = int(kernel[0])
            out_tw = None
            out_stats = None      # kernel-emitted moment partials
            defer_out = False     # fused: return the raw offset + sa/ta
            if layout == "u":
                w4 = pack_conv_weights_from_unpacked(w)
                out = want_out
                pb = pack_bias(b) if b is not None else None
                fuse_emit = (pallas_fused and out == "o"
                             and _fused_consumable(feats, x.shape[3] // 2 + 1,
                                                   kd))
                if out == "o" and (pallas_all or fuse_emit):
                    out_tw = x.shape[3] // 2 + 1
                    y = _packing(x, w4, pb, offset_out=True,
                                 out_w=_round8(out_tw))
                    defer_out = fuse_emit
                else:
                    y = _packing(x, w4, pb, offset_out=(out == "o"))
            elif layout == "a":
                wp = pack_conv_weights(w, in_splits=in_splits)
                pb = pack_bias(b) if b is not None else None
                out = "o"
                out_tw = x0.shape[3] + 1
                fuse_emit = (pallas_fused
                             and _fused_consumable(feats, out_tw, kd))
                y = None
                if pair and kd == 1 and isinstance(x0, sp.HBlocks):
                    # K1 on each H block with its halo rows
                    if pconv.pconv_pad11_cat_covers(x[0], x[1], wp[0]):
                        y = sp.conv(_k1_cat, tuple(x), wp[0], pb, k=2,
                                    pad=(1, 1), tag="pconv_pad11_cat")
                elif pair and kd == 1:
                    bsz, d = x0.shape[0], x0.shape[1]
                    r = pconv.pconv_pad11_cat(
                        x[0].reshape(bsz * d, *x[0].shape[2:]).contiguous(),
                        x[1].reshape(bsz * d, *x[1].shape[2:]).contiguous(),
                        wp[0], pb, want_stats=fuse_emit)
                    if r is not None:
                        if fuse_emit:
                            r, out_stats = r
                            defer_out = True
                        y = r.reshape(bsz, d, *r.shape[1:])
                if y is None and pair:
                    x = sp.local(_cat, *x)
                    pair = False
                if y is None and pallas_all and kd == 1:
                    bsz, d = x.shape[0], x.shape[1]
                    r = pconv.pconv_pad11(
                        x.reshape(bsz * d, *x.shape[2:]).contiguous(),
                        wp[0], pb)
                    if r is not None:
                        y = r.reshape(bsz, d, *r.shape[1:])
                if y is None and (pallas_all or fuse_emit):
                    # kd=3 (or uncovered): the cuDNN conv emits the
                    # widened layout; its pad columns hold the bias until
                    # the rim mask (here, or in the fused consumer) zeroes
                    # them
                    y = conv_packed(x, wp, pb, hw_pad="pad11",
                                    out_w=_round8(out_tw))
                    defer_out = fuse_emit
                elif y is None:
                    y = _packed(x, wp, pb, hw_pad="pad11")
                    out_tw = None
            else:  # offset -> aligned
                wp = pack_conv_weights(w, in_splits=in_splits)
                pb = pack_bias(b) if b is not None else None
                out = "a"
                y = None
                if deferred and otw is not None and (otw - 1) % 8 == 0:
                    # fused consumer: the norm rides the kernel's loads,
                    # and the aligned output's moments come back for the
                    # one-pass finalize below
                    if kd == 1:
                        bsz, d = x0.shape[0], x0.shape[1]
                        r = pconv.pconv_valid(
                            x0.reshape(bsz * d, *x0.shape[2:]).contiguous(),
                            wp[0], pb, w_out=otw - 1,
                            pre=(x.sa, x.ta, x.slope), want_stats=True)
                        if r is not None:
                            r, out_stats = r
                            y = r.reshape(bsz, d, *r.shape[1:])
                    elif kd == 3:
                        d = x0.shape[1]
                        r = pconv.pconv3_valid(
                            x0.contiguous(), wp, pb, w_out=otw - 1,
                            pre=(x.sa[::d], x.ta[::d], x.slope),
                            want_stats=True)
                        if r is not None:
                            y, out_stats = r
                    if y is None:      # uncovered: fall back whole
                        x = x.materialize()
                        x0 = x
                        deferred = False
                if y is None and pallas_all and otw is not None \
                        and (otw - 1) % 8 == 0:
                    if kd == 1:
                        bsz, d = x.shape[0], x.shape[1]
                        r = pconv.pconv_valid(
                            x.reshape(bsz * d, *x.shape[2:]).contiguous(),
                            wp[0], pb, w_out=otw - 1)
                        if r is not None:
                            y = r.reshape(bsz, d, *r.shape[1:])
                    else:
                        y = pconv.pconv3_valid(x.contiguous(), wp, pb,
                                               w_out=otw - 1)
                if y is None:
                    # a widened offset input: the conv reads only its
                    # true columns
                    y = _packed(x, wp, pb, in_w=otw)
            if out == "o":
                if defer_out:
                    if out_stats is None:
                        out_stats = offset_stats_xla(y, true_w=out_tw)
                    return (_defer_offset(y, out_stats, scale, nbias, eps,
                                          slope, out_tw), out, out_tw)
                y = _mask_offset(y, feats, tw=out_tw)
                y = _norm_packed(y, scale, nbias, eps, offset_parity=True,
                                 true_w=out_tw)
                y = _mask_offset(_leaky(y, slope), feats, tw=out_tw)
            elif out_stats is not None:
                # fused aligned finalize: one apply pass from the kernel's
                # moments
                bsz, d, hh, ww = y.shape[:4]
                sa, ta = norm_scale_shift_from_stats(
                    out_stats, bsz, d, d * hh * ww, scale, nbias, eps,
                    y.dtype)
                y = apply_norm_act_packed(y, sa, ta, slope)
            else:
                y = _leaky(_norm_packed(y, scale, nbias, eps), slope)
            return y, out, out_tw

    # ---------------- standard path
    if pair:
        x = sp.local(_cat, *x)
    x = _unpack(x, layout, otw)
    y = _conv_std(x, w, b, stride)
    y = _instance_norm(y, scale, nbias, eps)
    return _leaky(y, slope), "u", None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _ckpt(remat, kind: str, idx: int, n: int):
    """The checkpoint wrapper of one stage (JAX's ``_ckpt``): True
    checkpoints every stage and the SR head, "hires" the full- and
    half-resolution ones (encoder stages <= 1, decoder stages >= n - 3,
    the SR head), False none."""
    if remat == "hires":
        use = (idx <= 1 if kind == "enc" else
               idx >= n - 3 if kind == "dec" else True)
    else:
        use = bool(remat)
    if not use:
        return lambda f: f
    return lambda f: functools.partial(checkpoint, f, use_reentrant=False)


def segmodel_apply_packed(arch: dict, params, x, *, num_classes: int = 2,
                          upscale: int = 4, pack_max_channels: int = 128,
                          dual: bool = False, return_skips: bool = False,
                          remat: bool = False, plane_out: bool = False,
                          sr_head_form: str = "auto",
                          pallas_conv=False):
    """Forward identical to SegModel's with packed high-res stages.

    params: flax-layout tree ``{"params": ...}`` of tensors; x (B, D, H, W,
    C) channels-last. Returns lr_logits, (lr_logits, hr_logits) when
    ``dual``, or (lr_logits, hr_logits, skips) when ``return_skips`` (the
    distillation student's interface; skips unpacked, channels-last).
    plane_out: logits as per-class planes (B, C, D, H, W), the layout K2
    consumes. pallas_conv: False (plain convs), "cat" (K1 at the decoder
    skip concat), True (every covered stride-1 packed conv through
    K1/K3/K4/K5) or "fused" ("cat" plus the deferred instance norm through
    K6a/K6b/K6c). sr_head_form: "auto" (fused upsample/conv1 + z-paired
    stride-2 conv2), "cell4" or "legacy" (explicit z-upsample). remat:
    False, "hires" or True (see :func:`_ckpt`); the same math, recomputed
    in backward. Input and params are promoted to a common dtype first,
    differentiably, so gradients reach a module's parameters through
    ``convert.flax_tree_from_module``."""
    if pallas_conv not in (False, "cat", True, "fused"):
        raise ValueError(f"unknown pallas_conv {pallas_conv!r}")
    if remat not in (False, "hires", True):
        raise ValueError(f"unknown remat {remat!r}")
    if sr_head_form not in ("auto", "cell4", "legacy"):
        raise ValueError(f"unknown sr_head_form {sr_head_form!r}")
    if (isinstance(x, sp.HBlocks) and len(x.group) > 1
            and pallas_conv in (True, "fused")):
        raise ValueError(
            f"pallas_conv={pallas_conv!r} is a port-only mode with no "
            f"spatial form: an H-sharded forward runs pallas_conv False or "
            f"'cat' (the JAX package's Segmenter runs 'cat')")
    a = dict(arch)
    n = a["n_stages"]
    feats = a["features_per_stage"]
    kernels = [_to3(k) for k in a["kernel_sizes"]]
    strides = [_to3(s) for s in a["strides"]]
    p = params["params"] if "params" in params else params
    leaf = next(_leaves(p))
    common = torch.promote_types(x.dtype, leaf.dtype)
    x = x.to(common)
    p = _map(p, lambda t: t.to(common))
    penc, pdec = p["encoder"], p["decoder"]

    # A stage's layout decisions derive from shapes; each stage function
    # reports its final one here (strings and ints only, so a recompute in
    # backward rewrites the same values and no tensor outlives the stage).
    out = {}

    # ---------------- encoder: each stage ends ALIGNED (or unpacked)
    cur, layout, cur_tw = x, "u", None
    skips = []  # (tensor, layout, true offset width or None)
    for s in range(n):
        def enc_stage(cur_in, stp, *, _s=s, _in=layout, _tw=cur_tw):
            y, lay, tw = cur_in, _in, _tw
            n_convs = a["n_conv_per_stage"][_s]
            for i in range(n_convs):
                st = strides[_s] if i == 0 else (1, 1, 1)
                want = (("o" if n_convs - i >= 2 else "a") if lay == "u"
                        else "a")
                y, lay, tw = _conv_norm_act(
                    y, lay, stp[f"conv_{i}"], kernels[_s], st, feats[_s], a,
                    pack_max_channels=pack_max_channels, want_out=want,
                    tw=tw, pallas=pallas_conv)
            if isinstance(y, _Deferred):      # a stage ends finalized
                y = y.materialize()
            out["layout"], out["tw"] = lay, tw
            return y

        cur = _ckpt(remat, "enc", s, n)(enc_stage)(cur, penc[f"stage_{s}"])
        layout, cur_tw = out["layout"], out["tw"]
        skips.append((cur, layout, cur_tw))

    # ---------------- decoder
    lres, lres_layout, lres_tw = skips[-1]
    seg_logits = None
    features, features_layout, features_tw = None, "u", None
    for s in range(n - 1):
        ridx = n - 2 - s
        stride = strides[n - 1 - s]
        out_ch = feats[ridx]
        skip, skip_layout, skip_tw = skips[ridx]

        h_t, w_t = _true_hw(skip, skip_layout, skip_tw)
        pack_here = (_packable(kernels[ridx], h_t, w_t, out_ch,
                               pack_max_channels)
                     and stride[1] == 2 and stride[2] == 2
                     and skip_layout in ("a", "u"))
        lres = _unpack(lres, lres_layout, lres_tw)

        def dec_stage(lres_in, skip_in, tp, stp, *, _s=s, _ridx=ridx,
                      _pack=pack_here, _skip_layout=skip_layout,
                      _skip_tw=skip_tw, _out_ch=out_ch, _stride=stride):
            wt, bt = tp["kernel"], tp.get("bias")
            tw = None
            if _pack:
                up = sp.local(pointwise_packed_transpconv, lres_in,
                              pack_transpconv_weights(wt),
                              pack_bias(bt) if bt is not None
                              else None)                       # ALIGNED
                skip_p = (skip_in if _skip_layout == "a" else sp.conv(
                    space_to_depth_hw, skip_in, k=2, s=2,
                    tag="space_to_depth"))
                # conv_0 receives the PAIR: K1 fuses the concat, or
                # _conv_norm_act concatenates
                y = (up, skip_p)
                lay = "a"
                skip_ch = (skip_in.shape[-1] // 4 if _skip_layout == "a"
                           else skip_in.shape[-1])
                splits = [_out_ch, skip_ch]
            else:
                up = _transpconv_std(lres_in, wt, bt, _stride)
                y = sp.local(_cat, up,
                             _unpack(skip_in, _skip_layout, _skip_tw))
                lay, splits = "u", None
            for i in range(a["n_conv_per_stage_decoder"][_s]):
                y, lay, tw = _conv_norm_act(
                    y, lay, stp[f"conv_{i}"], kernels[_ridx], (1, 1, 1),
                    _out_ch, a, pack_max_channels=pack_max_channels,
                    in_splits=splits if i == 0 else None, want_out="a",
                    tw=tw, pallas=pallas_conv)
            if isinstance(y, _Deferred):        # a stage ends finalized
                y = y.materialize()
            out["layout"], out["tw"] = lay, tw
            return y

        cur = _ckpt(remat, "dec", s, n)(dec_stage)(
            lres, skip, pdec[f"transpconv_{s}"], pdec[f"stage_{s}"])
        layout, cur_tw = out["layout"], out["tw"]

        if s == n - 2:
            wseg = pdec[f"seg_layer_{s}"]["kernel"]
            bseg = pdec[f"seg_layer_{s}"]["bias"]
            n_cls = wseg.shape[-1]
            if layout in ("a", "o"):
                # pointwise seg head in packed space; unpack only the
                # num_classes-channel logits
                wp = pack_pointwise_weights(wseg[0, 0, 0].to(cur.dtype))
                lg = sp.local(lambda t, w_, b_: torch.matmul(t, w_) + b_,
                              cur, wp, pack_bias(bseg))
                if layout == "o":
                    lg = _mask_offset(lg, n_cls, tw=cur_tw)
                lg = sp.gather(lg)          # logits on the group's first
                if plane_out:
                    # packed channel order is (cell, class)
                    seg_logits = torch.stack(
                        [_unpack(lg[..., c::n_cls], layout, cur_tw)[..., 0]
                         for c in range(n_cls)], dim=1)
                else:
                    seg_logits = _unpack(lg, layout, cur_tw)
            else:
                seg_logits = sp.gather(_conv_std(cur, wseg, bseg, (1, 1, 1)))
                if plane_out:
                    seg_logits = torch.movedim(seg_logits, -1, 1)
            features, features_layout, features_tw = cur, layout, cur_tw
        lres, lres_layout, lres_tw = cur, layout, cur_tw

    if not dual and not return_skips:
        return seg_logits

    w1, b1 = p["sr_head_conv1"]["kernel"], p["sr_head_conv1"]["bias"]
    w2, b2 = p["sr_head_conv2"]["kernel"], p["sr_head_conv2"]["bias"]
    head = functools.partial(_sr_head, layout=features_layout,
                             tw=features_tw, upscale=upscale,
                             plane_out=plane_out, sr_head_form=sr_head_form)
    hr = _ckpt(remat, "head", 0, n)(head)(features, w1=w1, b1=b1, w2=w2,
                                          b2=b2)
    if return_skips:
        return seg_logits, hr, [_unpack(sp.gather(t), l, tw)
                                for t, l, tw in skips]
    return seg_logits, hr


def _sr_head(feats_in, *, layout, tw, w1, b1, w2, b2, upscale, plane_out,
             sr_head_form):
    """The SR head; an HBlocks input runs its convs sharded along H and
    gathers the last conv's output (the head's logits) on the group's first
    device."""
    if layout == "a":
        # SR head fully packed (D-upsampling commutes with in-plane packing)
        if w1.shape[0] == 3 and sr_head_form != "legacy":
            h1 = sp.conv(lambda t, w_, b_: fused_upsample_conv1(
                t, w_, b_, upscale), feats_in, w1, b1, k=2, pad=(1, 1),
                tag="fused_upsample_conv1")
        else:
            up = sp.local(lambda t: upsample_axis_linear(
                t, upscale, axis=1, align_corners=True), feats_in)
            h1 = _packed(up, pack_conv_weights(w1), pack_bias(b1),
                         hw_pad="pad11")
        h1 = _mask_offset(sp.local(torch.relu, h1), w1.shape[-1])
        ncl = w2.shape[-1]
        if ((h1.shape[2] - 1) % 2 == 0 and (h1.shape[3] - 1) % 2 == 0
                and sr_head_form != "legacy"):
            if h1.shape[1] % 2 == 0 and sr_head_form != "cell4":
                out = sp.gather(sp.conv(
                    conv_packed_s2_cell4z2, h1, pack_conv_weights_cell4z2(w2),
                    pack_bias_cell4z2(b2), k=5, s=2, pad=(1, 1),
                    tag="conv_packed_s2_cell4z2"))
                planes = unpack_cell4z2(out, ncl)
                return torch.stack(planes, dim=1 if plane_out else -1)
            out = sp.gather(sp.conv(
                conv_packed_s2_cell4, h1, pack_conv_weights_cell4(w2),
                pack_bias_cell4(b2), k=5, s=2, pad=(1, 1),
                tag="conv_packed_s2_cell4"))
            if plane_out:
                return torch.stack(
                    [depth_to_space_cell(out[..., c::ncl], 4)[..., 0]
                     for c in range(ncl)], dim=1)
            return depth_to_space_cell(out, 4)
        out = sp.gather(_packed(h1, pack_conv_weights(w2), pack_bias(b2)))
        if plane_out:
            return torch.stack(
                [depth_to_space_hw(out[..., c::ncl])[..., 0]
                 for c in range(ncl)], dim=1)
        return depth_to_space_hw(out)
    f = _unpack(feats_in, layout, tw)
    up = sp.local(lambda t: upsample_axis_linear(t, upscale, axis=1,
                                                 align_corners=True), f)
    h1 = sp.local(torch.relu, _conv_std(up, w1, b1, (1, 1, 1)))
    hr = sp.gather(_conv_std(h1, w2, b2, (1, 1, 1)))
    return torch.movedim(hr, -1, 1) if plane_out else hr
