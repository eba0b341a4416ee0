"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; builds the port's kernels from
``rehrseg_tpu_torch/csrc`` into ``build/rehrseg_tpu_torch/``. Imports no JAX
and nothing of the JAX package. Phases, each printing one JSON line:

  env      torch / CUDA versions and the card's name and power limit;
  build    the kernels' build seconds (one nvcc per source, in parallel);
  k1, k2   each kernel against its plain PyTorch version at the serving
           path's shapes (max error against the stated tolerance), with
           kernel / plain / library times from CUDA events and the bound;
           K1 (bf16: the wgmma / TMA kernel) also at ragged bf16 shapes (an
           odd height, one and a half tiles wide, Ca != Cb, Co = 256, an
           image smaller than a tile), its columns > w exact zeros;
  k3, k4, k5  the same for the pallas_conv=True kernels (pconv_valid,
           pconv_pad11, pconv3_valid) at that forward's shapes, bf16, and
           at a small fp32 shape; the VALID kernels' inputs carry garbage
           in their pad columns; each (bf16: the wgmma / TMA kernels) also
           at ragged bf16 shapes (an odd height, one and a half tiles wide,
           Co = 384, Ci = 256, an image smaller than a tile; K5 with D = 1
           and 2, K4 with h = 1), K4's columns > w exact zeros;
  tile     one full-width DEFAULT_ARCH tile: the packed forward with K1
           against the unpacked SegModel, fp32 (TF32 off);
  tile_pallas  the same tile through pallas_conv=True (K1, K3, K5), and
           again with a 3-conv encoder stage 0 (K3, K4, K5), each with its
           kernels' launch counts asserted;
  main     the served path: Segmenter (bf16, patch (16, 320, 384)) on
           seeded (20, 455, 633) volumes, aligned grid with the HR head,
           parity grid, segment_many of two volumes; launch counts of K1
           and K2 from these calls only, seconds per volume, voxels/s;
  main_pallas  one dual aligned volume through the engine with the
           pallas_conv=True forward: launch counts of K1, K2, K3, K5
           (asserted against the tile count), seconds, voxels/s, one 8-way
           dual tile forward under True and under "cat", and label
           agreement with the "cat" Segmenter (printed, not gated);
  k6       the deferred-norm kernels of pallas_conv="fused" (K6a
           pconv_pad11_cat(want_stats=True), K6b pconv_valid(pre=,
           want_stats=), K6c pconv3_valid(pre=, want_stats=)) against their
           plain versions at that forward's shapes, bf16, and at a small
           fp32 shape: the output's max error and the moment half-sums'
           max relative error, kernel / plain / unfused times and the bound;
           each (bf16: forms of the wgmma / TMA kernels) also at ragged bf16
           shapes (odd heights, one and a half tiles wide, Ca != Cb, Co =
           256 / 384, Ci = 256, w_out = 8, D = 1 and 2, an image smaller
           than a tile), K6a's rim slots and columns > w exact zeros, and
           K6b and K6c with pre alone and with want_stats alone;
  k7       conv2x2_valid_bias on an exact odd width, the same way, with
           cuDNN's time (no path of the port calls it), and at two ragged
           odd-width bf16 shapes;
  tile_fused  one full-width 8-way dual tile through pallas_conv="fused"
           against the unpacked SegModel, fp32 (TF32 off), K6 launch counts
           asserted; then the bf16 tile forward's time under "fused",
           "cat" and True;
  main_fused  one dual aligned volume through
           Segmenter(pallas_conv="fused"): launch counts of K1-K7 and the
           K6 forms (asserted against the tile count), seconds, voxels/s,
           and label agreement with the "cat" Segmenter (LR gated at 98 %);
  kernels  every ported kernel with launches, error, times and bound.

Then the card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits nonzero and prints no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
FP32_FLOPS = 67e12             # fp32 outside the tensor cores

PATCH = (16, 320, 384)
VOLUME = (20, 455, 633)
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    ok = bool((err <= lim).all())
    max_err = float(err.max())
    if not ok:
        raise AssertionError(f"{name}: max |err| {max_err} over tolerance "
                             f"rtol={rtol} atol={atol}")
    return max_err


# ragged bf16 shapes for the wgmma / TMA kernels, beside the main path's:
# K1 (n, h, w, Ca, Cb, Co): an odd height and one and a half 16-wide tiles;
# Ca != Cb and Co = 256; an image smaller than one tile, a batch of one.
# K5 (B, D, hp, wp8, Ci, Co), w_out = wp8 - 8: D = 1, an odd height, one and
# a half tiles wide; D = 2 and Co = 384; an image smaller than one tile.
# K3 (n, hp, wp8, Ci, Co), w_out = wp8 - 8, and K4 (n, h, w, Ci, Co): an odd
# height and one and a half tiles wide; Co = 384 and a batch of one; Ci =
# 256 (the weights do not fit in shared memory: the streamed kernel) on an
# image smaller than one tile, K4's one row high.
# K7 (n, hp, wp, Ci, Co) at exact odd widths: one and a half tiles wide
# with an odd height; Co = 256 on an image smaller than one tile.
K1_RAGGED = ((2, 13, 24, 128, 128, 128), (3, 7, 24, 128, 256, 256),
             (1, 3, 8, 256, 128, 128))
K5_RAGGED = ((2, 1, 14, 32, 128, 128), (1, 2, 10, 32, 128, 384),
             (1, 3, 4, 16, 256, 128))
K3_RAGGED = ((2, 14, 32, 128, 128), (1, 10, 32, 128, 384),
             (3, 4, 16, 256, 128))
K4_RAGGED = ((2, 13, 24, 128, 128), (1, 7, 24, 128, 384),
             (3, 1, 8, 256, 128))
K7_RAGGED = ((2, 14, 25, 128, 128), (1, 6, 12, 128, 256))
# K6a as K1 (Co = 384 on the second), K6c as K5 (Ci = 256 on an odd hp), K6b
# as K3 (w_out = 8 with Co = 384; Ci = 256, the streamed kernel)
K6_RAGGED = {
    "k6a": ((2, 13, 24, 128, 128, 128), (3, 7, 24, 128, 256, 384),
            (1, 3, 8, 256, 128, 256)),
    "k6b": ((2, 14, 32, 128, 128), (1, 10, 16, 128, 384),
            (3, 9, 40, 256, 128)),
    "k6c": ((2, 1, 14, 32, 128, 128), (1, 2, 10, 32, 128, 384),
            (2, 3, 5, 16, 256, 128)),
}
PCONV_RAGGED = {"k3": K3_RAGGED, "k4": K4_RAGGED, "k5": K5_RAGGED}


def phase_k1(gen, dev):
    from rehrseg_tpu_torch.ops.pconv import (pconv_pad11_cat,
                                             pconv_pad11_cat_plain)
    import torch.nn.functional as F

    out = {}
    # the served shape: decoder stage 4 conv_0 of an 8-way TTA batch of
    # (16, 320, 384) tiles, 32 + 32 features packed to 128 + 128 lanes
    for label, (n, h, w, ca, cb, co), dtype, tol in (
            ("bf16_main", (128, 160, 192, 128, 128, 128), torch.bfloat16,
             0.04),
            ("fp32_small", (4, 16, 32, 128, 128, 128), torch.float32,
             2e-5),
            *((f"bf16_ragged_{i}", shape, torch.bfloat16, 0.04)
              for i, shape in enumerate(K1_RAGGED))):
        xa = torch.randn(n, h, w, ca, generator=gen, device=dev).to(dtype)
        xb = torch.randn(n, h, w, cb, generator=gen, device=dev).to(dtype)
        wt = (torch.randn(2, 2, ca + cb, co, generator=gen, device=dev)
              / (4 * (ca + cb)) ** 0.5).to(dtype)
        b = (0.1 * torch.randn(co, generator=gen, device=dev)).to(dtype)
        y = pconv_pad11_cat(xa, xb, wt, b)
        torch.cuda.synchronize()
        ref = pconv_pad11_cat_plain(xa.float(), xb.float(), wt.float(),
                                    b.float())
        max_err = check_close(f"K1 {label}", y, ref, tol, tol)
        del ref
        if bool((y[:, :, w + 1:] != 0).any()):
            raise AssertionError(f"K1 {label}: columns > w are not exact "
                                 f"zeros")
        rec = dict(shape=[n, h, w, ca, cb, co], dtype=str(dtype),
                   max_abs_err=max_err, tolerance=tol)
        if label == "bf16_main":
            cat = torch.cat([xa, xb], -1).permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rec["ms"] = cuda_ms(lambda: pconv_pad11_cat(xa, xb, wt, b))
            rec["plain_ms"] = cuda_ms(
                lambda: pconv_pad11_cat_plain(xa, xb, wt, b))
            # one cuDNN conv on the pre-concatenated input: excludes the
            # concat and the zero columns
            rec["library_ms"] = cuda_ms(
                lambda: F.conv2d(cat, wl, b, padding=1))
            del cat
            # each input pixel meets each of the 4 taps once; the taps
            # that land on the pad rim do no work
            flops = 2 * n * h * w * 4 * (ca + cb) * co
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes(xa, xb, wt, b, y), flops, BF16_FLOPS)
            rec["tflops"] = flops / 1e12
            rec["gbytes"] = nbytes(xa, xb, wt, b, y) / 1e9
        out[label] = rec
        del xa, xb, y
    emit({"phase": "k1", **out})
    return out["bf16_main"]


def phase_k2(gen, dev):
    from rehrseg_tpu_torch.ops.tail import (accumulate_tta_tile,
                                            accumulate_tta_tile_plain)

    out = {}
    # aligned-grid accumulators of the (20, 455, 633) volume padded to
    # (20, 456, 640), one tile at a grid start; LR and the x4 HR head
    for label, z_scale in (("lr", 1), ("hr", 4)):
        c, od, ph, pw = 2, PATCH[0] * z_scale, PATCH[1], PATCH[2]
        logits = torch.randn(c, 20 * z_scale, 456, 640, generator=gen,
                             device=dev)
        preds = torch.randn(8, c, od, ph, pw, generator=gen,
                            device=dev).to(torch.bfloat16)
        g = torch.rand(od, ph, pw, generator=gen, device=dev) + 0.1
        off = (4, 136, 256, 1)
        got = accumulate_tta_tile(logits.clone(), preds, g, off,
                                  z_scale=z_scale)
        want = accumulate_tta_tile_plain(logits.clone(), preds, g, off,
                                         z_scale)
        torch.cuda.synchronize()
        max_err = check_close(f"K2 {label}", got, want, 2e-5, 2e-5)
        acc = logits.clone()
        g16 = g.to(torch.bfloat16)
        n_bytes = (nbytes(preds, g16)
                   + 2 * c * od * ph * pw * logits.element_size())
        b_ms, b_by = bound(n_bytes, 0, BF16_FLOPS)
        out[label] = dict(
            preds_shape=list(preds.shape), z_scale=z_scale,
            max_abs_err=max_err, tolerance=2e-5,
            ms=cuda_ms(lambda: accumulate_tta_tile(acc, preds, g, off,
                                                   z_scale=z_scale)),
            plain_ms=cuda_ms(lambda: accumulate_tta_tile_plain(
                acc, preds, g, off, z_scale)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            gbytes=n_bytes / 1e9)
        del logits, preds, acc, got, want
    emit({"phase": "k2", **out})
    return out


def _pconv_case(kernel, shape, dtype, gen, dev):
    """Operands of one K3/K4/K5 check: (args, kwargs, plain version,
    library call factory, FLOP, input bytes the function must read)."""
    import torch.nn.functional as F
    from rehrseg_tpu_torch.ops import pconv

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    kd = 3 if kernel == "k5" else 1
    *lead, hp, wd, ci, co = shape
    x = randn(*lead, hp, wd, ci).to(dtype)
    w = (randn(*((3,) if kd == 3 else ()), 2, 2, ci, co)
         / (4 * kd * ci) ** 0.5).to(dtype)
    b = (0.1 * randn(co)).to(dtype)
    if kernel == "k4":
        # rim taps read the zero pad and do no work (as for K1)
        flops = 2 * lead[0] * hp * wd * 4 * ci * co

        def library():
            xl = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv2d(xl, wl, b, padding=1)
        return ((x, w, b), {}, pconv.pconv_pad11_plain, library, flops,
                nbytes(x, w, b))
    # an offset input stored 8-aligned wide: garbage in the pad columns,
    # which the function never reads (only columns 0..w_out count)
    w_out = wd - 8
    x[..., w_out + 1:, :] = 1e3
    in_bytes = nbytes(x[..., :w_out + 1, :], w, b)
    # K5's z taps outside [0, D) are zero fills: of each batch element's
    # 3D (output z, z tap) pairs, 3D - 2 do work
    planes = lead[0] * (3 * lead[1] - 2) if kd == 3 else lead[0]
    flops = 2 * planes * (hp - 1) * w_out * 4 * ci * co
    if kernel == "k3":
        def library():
            xl = x[:, :, :w_out + 1].permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv2d(xl, wl, b)
        return ((x, w, b), dict(w_out=w_out),
                lambda *a: pconv.pconv_valid_plain(*a, w_out), library, flops,
                in_bytes)

    def library():
        xl = x[:, :, :, :w_out + 1].permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        wl = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(xl, wl, b, padding=(1, 0, 0))
    return ((x, w, b), dict(w_out=w_out),
            lambda *a: pconv.pconv3_valid_plain(*a, w_out), library, flops,
            in_bytes)


# the pallas_conv=True forward's shapes for an 8-way TTA batch of
# (16, 320, 384) tiles at DEFAULT_ARCH (K3: encoder stage 0 conv_1; K4: the
# 3-conv variant's stage 0 conv_2; K5: the 64-feature decoder stage's
# conv_1), then a small fp32 shape; (lead..., h or hp, w or wp8, Ci, Co)
PCONV_SHAPES = {
    "k3": ((128, 161, 200, 128, 128), (4, 17, 40, 128, 128)),
    "k4": ((128, 160, 192, 128, 128), (4, 16, 32, 128, 128)),
    "k5": ((8, 16, 81, 104, 256, 256), (2, 3, 17, 40, 128, 256)),
}
PCONV_FNS = {"k3": "pconv_valid", "k4": "pconv_pad11",
             "k5": "pconv3_valid"}


def phase_pconv(kernel, gen, dev):
    """One of K3/K4/K5 against its plain version (fp32 on the same
    operands), bf16 at the path's shape and at ragged shapes and fp32 at a
    small one, with kernel / plain / library times and the bound at the
    path's shape."""
    from rehrseg_tpu_torch.ops import pconv

    fn = getattr(pconv, PCONV_FNS[kernel])
    out = {}
    for label, shape, dtype, tol in (
            ("bf16_main", PCONV_SHAPES[kernel][0], torch.bfloat16, 0.04),
            ("fp32_small", PCONV_SHAPES[kernel][1], torch.float32, 2e-5),
            *((f"bf16_ragged_{i}", shape, torch.bfloat16, 0.04)
              for i, shape in enumerate(PCONV_RAGGED[kernel]))):
        args, kw, plain, library, flops, in_bytes = _pconv_case(
            kernel, shape, dtype, gen, dev)
        y = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*(a.float() for a in args))
        max_err = check_close(f"{kernel} {label}", y, ref, tol, tol)
        del ref
        if kernel == "k4" and bool((y[:, :, shape[2] + 1:] != 0).any()):
            raise AssertionError(f"K4 {label}: columns > w are not exact "
                                 f"zeros")
        rec = dict(shape=list(shape), dtype=str(dtype), max_abs_err=max_err,
                   tolerance=tol)
        if label == "bf16_main":
            rec["ms"] = cuda_ms(lambda: fn(*args, **kw))
            rec["plain_ms"] = cuda_ms(lambda: plain(*args))
            rec["library_ms"] = cuda_ms(library())
            n_bytes = in_bytes + nbytes(y)
            rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops,
                                                     BF16_FLOPS)
            rec["tflops"] = flops / 1e12
            rec["gbytes"] = n_bytes / 1e9
        out[label] = rec
        del args, y
        torch.cuda.empty_cache()
    emit({"phase": kernel, **out})
    return out["bf16_main"]


# the "fused" forward's shapes for an 8-way TTA batch of (16, 320, 384)
# tiles at DEFAULT_ARCH (K6a: the last decoder stage's conv_0 at the skip
# concat; K6b: encoder stage 0 and the last decoder stage's conv_1; K6c: the
# 64-feature decoder stage's conv_1), then a small fp32 shape; K6a (n, h, w,
# Ca, Cb, Co), K6b/K6c (lead..., hp, wp8, Ci, Co) with w_out = wp8 - 8
K6_SHAPES = {
    "k6a": ((128, 160, 192, 128, 128, 128), (4, 16, 32, 128, 128, 128)),
    "k6b": ((128, 161, 200, 128, 128), (4, 17, 40, 128, 128)),
    "k6c": ((8, 16, 81, 104, 256, 256), (2, 3, 17, 40, 128, 256)),
}
# the moment half-sums' relative tolerance: the order of the atomic
# accumulation varies, and in bf16 the kernel sums the rounded output the
# plain version holds in fp32
STATS_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SLOPE = 0.01


def check_stats(name, got, want, npix, rtol, atol):
    """(N, 16, C) moment partials: their two half-sums (the contract), the
    sums of squares within rtol / atol, the sums within rtol / atol *
    sqrt(npix) (a signed sum may cancel to near zero, so its relative
    error says little). Returns the sums' max abs error and the sums of
    squares' max relative error."""
    out = {}
    for part, rows, a in (("sum", slice(0, 8), atol * npix ** 0.5),
                          ("square", slice(8, 16), atol)):
        g, w = got[:, rows].sum(1), want[:, rows].sum(1)
        err = (g - w).abs()
        if not bool((err <= a + rtol * w.abs()).all()):
            raise AssertionError(f"{name}: stats {part} max |err| "
                                 f"{float(err.max())} over tolerance")
        if part == "sum":
            out["stats_sum_max_abs_err"] = float(err.max())
            out["stats_sum_atol"] = a
        else:
            out["stats_square_max_rel_err"] = float(
                (err / w.abs().clamp_min(a)).max())
    return out


def _k6_case(kernel, shape, dtype, gen, dev, use_pre=True, want_stats=True):
    """Operands of one K6 check: (kernel call, plain call, fp32 reference,
    unfused call, FLOP, bytes the function must move, output pixels per
    image). The VALID forms read a raw offset input (nonzero rim, 1e3 in the
    pad columns) through a nonzero pre; their reference applies pre in the
    working dtype, as the kernel does, then the plain conv in fp32.
    use_pre / want_stats (the VALID forms): the form with one part alone;
    without want_stats the calls return y alone."""
    from rehrseg_tpu_torch.ops import pack2d, pconv

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    if kernel == "k6a":
        n, h, w, ca, cb, co = shape
        xa, xb = randn(n, h, w, ca).to(dtype), randn(n, h, w, cb).to(dtype)
        wt = (randn(2, 2, ca + cb, co) / (4 * (ca + cb)) ** 0.5).to(dtype)
        b = (0.1 * randn(co)).to(dtype)
        mask = pack2d.offset_rim_mask(h + 1, pconv._round8(w + 1), co // 4,
                                      dtype, dev, true_w=w + 1)

        def unfused():
            # the "cat" path: K1, the rim mask, fp32 moment sums
            y = pconv.pconv_pad11_cat(xa, xb, wt, b) * mask
            return pack2d.aligned_stats_xla(y[None])
        y_bytes = n * (h + 1) * pconv._round8(w + 1) * co * xa.element_size()
        return (lambda: pconv.pconv_pad11_cat(xa, xb, wt, b, want_stats=True),
                lambda: pconv.pconv_pad11_cat_plain(xa, xb, wt, b, True),
                lambda: pconv.pconv_pad11_cat_plain(
                    xa.float(), xb.float(), wt.float(), b.float(), True),
                unfused, 2 * n * h * w * 4 * (ca + cb) * co,
                nbytes(xa, xb, wt, b) + y_bytes + n * 16 * co * 4,
                (h + 1) * pconv._round8(w + 1))
    kd = 3 if kernel == "k6c" else 1
    *lead, hp, wd, ci, co = shape
    w_out = wd - 8
    x = randn(*lead, hp, wd, ci).to(dtype)
    x[..., w_out + 1:, :] = 1e3
    wt = (randn(*((3,) if kd == 3 else ()), 2, 2, ci, co)
          / (4 * kd * ci) ** 0.5).to(dtype)
    b = (0.1 * randn(co)).to(dtype)
    sa = (randn(lead[0], 1, ci).abs() + 0.5).expand(-1, 8, -1).to(dtype)
    ta = (0.5 * randn(lead[0], 1, ci)).expand(-1, 8, -1).to(dtype)
    pre = (sa, ta, SLOPE) if use_pre else None
    fn = pconv.pconv_valid if kd == 1 else pconv.pconv3_valid
    plain = pconv.pconv_valid_plain if kd == 1 else pconv.pconv3_valid_plain
    x5 = x[:, None] if kd == 1 else x
    wp = wt[None] if kd == 1 else wt
    bsz, d = x5.shape[:2]
    sa5 = sa[:, 0][:, None].expand(-1, d, -1).reshape(bsz * d, 1, ci)
    ta5 = ta[:, 0][:, None].expand(-1, d, -1).reshape(bsz * d, 1, ci)

    def unfused():
        # the "cat" path's passes for the same work: the norm apply with
        # the rim mask, the cuDNN conv on the true columns, fp32 moment sums
        xn = pack2d.apply_norm_act_packed(x5, sa5, ta5, SLOPE,
                                          offset_parity=True,
                                          true_w=w_out + 1)
        return pack2d.aligned_stats_xla(
            pack2d.conv_packed(xn, wp, b, in_w=w_out + 1))

    def ref():
        xt = x[..., :w_out + 1, :]
        if use_pre:
            xt = pconv.pre_plain(xt, *pre)
        return plain(xt.float(), wt.float(), b.float(), w_out,
                     want_stats=want_stats)
    # kd = 3: of each batch element's 3D (output z, z tap) pairs, 3D - 2
    # do work (the taps outside [0, D) read zeros)
    planes = lead[0] * (3 * lead[1] - 2) if kd == 3 else lead[0]
    n_img = int(np.prod(lead))
    y_bytes = n_img * (hp - 1) * w_out * co * x.element_size()
    return (lambda: fn(x, wt, b, w_out=w_out, pre=pre,
                       want_stats=want_stats),
            lambda: plain(x, wt, b, w_out, pre=pre, want_stats=want_stats),
            ref, unfused, 2 * planes * (hp - 1) * w_out * 4 * ci * co,
            nbytes(x[..., :w_out + 1, :], wt, b, sa[:, 0], ta[:, 0])
            + y_bytes + n_img * 16 * co * 4,
            (hp - 1) * w_out)


K6_FNS = {"k6a": "pconv_pad11_cat", "k6b": "pconv_valid",
          "k6c": "pconv3_valid"}


def phase_k6(gen, dev):
    """K6a/K6b/K6c against their plain versions, bf16 at the "fused"
    forward's shapes and fp32 at a small one, also at ragged bf16 shapes,
    and K6b and K6c with pre alone and want_stats alone (K6b on the
    weights-resident kernel of its main path, K6c at Ci = 256); at the
    path's shape also the kernel, plain and unfused times and the bound.
    Returns the bf16 records."""
    from rehrseg_tpu_torch.ops import pack2d, pconv

    bf16, both = torch.bfloat16, dict(use_pre=True, want_stats=True)
    out = {}
    for kernel in ("k6a", "k6b", "k6c"):
        counter = getattr(pconv, K6_FNS[kernel])
        cases = [("bf16_main", K6_SHAPES[kernel][0], bf16, 0.04, both),
                 ("fp32_small", K6_SHAPES[kernel][1], torch.float32, 2e-5,
                  both),
                 *((f"bf16_ragged_{i}", shape, bf16, 0.04, both)
                   for i, shape in enumerate(K6_RAGGED.get(kernel, ())))]
        if kernel != "k6a":
            ragged = K6_RAGGED[kernel][0 if kernel == "k6b" else 2]
            cases += [("bf16_pre_only", ragged, bf16, 0.04,
                       dict(use_pre=True, want_stats=False)),
                      ("bf16_stats_only", ragged, bf16, 0.04,
                       dict(use_pre=False, want_stats=True))]
        rec = {}
        for label, shape, dtype, tol, form in cases:
            call, plain, ref, unfused, flops, n_bytes, npix = _k6_case(
                kernel, shape, dtype, gen, dev, **form)
            before = counter.fused_launches
            got, want = call(), ref()
            torch.cuda.synchronize()
            if counter.fused_launches != before + 1:
                raise AssertionError(f"{kernel}: the wrapper did not count "
                                     f"its launch")
            y, stats = got if form["want_stats"] else (got, None)
            ry, rstats = want if form["want_stats"] else (want, None)
            max_err = check_close(f"{kernel} {label}", y, ry, tol, tol)
            stats_err = check_stats(f"{kernel} {label}", stats, rstats,
                                    npix, STATS_RTOL[dtype], tol) \
                if form["want_stats"] else {}
            if kernel == "k6a":
                # the rim slots and the columns > w: exact zeros
                mask = pack2d.offset_rim_mask(
                    y.shape[1], y.shape[2], y.shape[3] // 4, torch.bool, dev,
                    true_w=shape[2] + 1)
                if bool((y[:, ~mask] != 0).any()):
                    raise AssertionError(f"K6a {label}: a masked value is "
                                         f"not an exact zero")
            del ry, rstats, got, want
            r = dict(shape=list(shape), dtype=str(dtype), max_abs_err=max_err,
                     tolerance=tol, **stats_err, stats_rtol=STATS_RTOL[dtype])
            if label == "bf16_main":
                r["ms"] = cuda_ms(call)
                r["plain_ms"] = cuda_ms(plain)
                r["unfused_ms"] = cuda_ms(unfused)
                r["library_ms"] = None
                r["bound_ms"], r["bound_by"] = bound(n_bytes, flops,
                                                     BF16_FLOPS)
                r["tflops"] = flops / 1e12
                r["gbytes"] = n_bytes / 1e9
            rec[label] = r
            del y, stats, call, plain, ref, unfused
            torch.cuda.empty_cache()
        out[kernel] = rec
    emit({"phase": "k6", **out})
    return {k: v["bf16_main"] for k, v in out.items()}


def phase_k7(gen, dev):
    """K7 on an exact odd width against its plain version, bf16 at the
    shape of K3's site and at ragged odd widths, fp32 at a small one, with
    cuDNN's time."""
    import torch.nn.functional as F
    from rehrseg_tpu_torch.ops.conv2x2 import (conv2x2_valid_bias,
                                               conv2x2_valid_bias_plain)

    out = {}
    for label, (n, hp, wp, ci, co), dtype, tol in (
            ("bf16_main", (128, 161, 193, 128, 128), torch.bfloat16, 0.04),
            ("fp32_small", (4, 17, 33, 128, 128), torch.float32, 2e-5),
            *((f"bf16_ragged_{i}", shape, torch.bfloat16, 0.04)
              for i, shape in enumerate(K7_RAGGED))):
        x = torch.randn(n, hp, wp, ci, generator=gen, device=dev).to(dtype)
        wt = (torch.randn(2, 2, ci, co, generator=gen, device=dev)
              / (4 * ci) ** 0.5).to(dtype)
        b = (0.1 * torch.randn(co, generator=gen, device=dev)).to(dtype)
        before = conv2x2_valid_bias.launches
        y = conv2x2_valid_bias(x, wt, b)
        torch.cuda.synchronize()
        if conv2x2_valid_bias.launches != before + 1:
            raise AssertionError("k7: the wrapper did not count its launch")
        ref = conv2x2_valid_bias_plain(x.float(), wt.float(), b.float())
        rec = dict(shape=[n, hp, wp, ci, co], dtype=str(dtype),
                   max_abs_err=check_close(f"k7 {label}", y, ref, tol, tol),
                   tolerance=tol)
        del ref
        if label == "bf16_main":
            xl = x.permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rec["ms"] = cuda_ms(lambda: conv2x2_valid_bias(x, wt, b))
            rec["plain_ms"] = cuda_ms(
                lambda: conv2x2_valid_bias_plain(x, wt, b))
            rec["library_ms"] = cuda_ms(lambda: F.conv2d(xl, wl, b))
            flops = 2 * n * (hp - 1) * (wp - 1) * 4 * ci * co
            n_bytes = nbytes(x, wt, b, y)
            rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops,
                                                     BF16_FLOPS)
            rec["tflops"] = flops / 1e12
            rec["gbytes"] = n_bytes / 1e9
        out[label] = rec
        del x, y
        torch.cuda.empty_cache()
    emit({"phase": "k7", **out})
    return out["bf16_main"]


def _fused_counts():
    """The K6 forms' launch counts and the plain forms' of K1/K3/K4/K5."""
    from rehrseg_tpu_torch.ops import pconv

    return {"pconv_pad11_cat_stats": pconv.pconv_pad11_cat.fused_launches,
            "pconv_valid_fused": pconv.pconv_valid.fused_launches,
            "pconv3_valid_fused": pconv.pconv3_valid.fused_launches,
            **{n: getattr(pconv, n).launches
               for n in ("pconv_pad11_cat", "pconv_valid", "pconv_pad11",
                         "pconv3_valid")}}


def _zero_counts():
    from rehrseg_tpu_torch.ops import pconv
    from rehrseg_tpu_torch.ops.conv2x2 import conv2x2_valid_bias
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile

    for c in (pconv.pconv_pad11_cat, pconv.pconv_valid, pconv.pconv3_valid):
        c.fused_launches = 0
    for c in (pconv.pconv_pad11_cat, pconv.pconv_valid, pconv.pconv_pad11,
              pconv.pconv3_valid, conv2x2_valid_bias, accumulate_tta_tile):
        c.launches = 0


def phase_tile_fused(params, dev):
    """One full-width 8-way dual tile through pallas_conv="fused" against
    the unpacked SegModel, both fp32 with TF32 off: K6a once, K6b twice,
    K6c once, no plain K1/K3/K4/K5. Then one bf16 8-way dual tile forward
    under "fused", "cat" and True (CUDA events)."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed

    model = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(model, params)
    model = model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
        size=(8, *PATCH, 1)).astype(np.float32)).to(dev)
    with torch.no_grad():
        ref_lr, ref_hr = model(x)
        del model
        _zero_counts()
        lr, hr = segmodel_apply_packed(
            DEFAULT_ARCH, convert.tree_to_torch(params, dev), x,
            pack_max_channels=64, dual=True, upscale=4, pallas_conv="fused")
        torch.cuda.synchronize()
    got = _fused_counts()
    want = dict(pconv_pad11_cat_stats=1, pconv_valid_fused=2,
                pconv3_valid_fused=1, pconv_pad11_cat=0, pconv_valid=0,
                pconv_pad11=0, pconv3_valid=0)
    if got != want:
        raise AssertionError(f"tile_fused: launches {got}, the dispatch "
                             f"gives {want}")
    tol = 2e-3
    rec = dict(
        batch=8, lr_max_abs_err=check_close("tile_fused lr", lr, ref_lr, tol,
                                            tol),
        hr_max_abs_err=check_close("tile_fused hr", hr, ref_hr, tol, tol),
        tolerance=tol, launches=got,
        finite=bool(torch.isfinite(lr).all() and torch.isfinite(hr).all()))
    if not rec["finite"]:
        raise AssertionError("tile_fused: logits not finite")
    del x, ref_lr, ref_hr, lr, hr
    torch.cuda.empty_cache()
    pb = convert.tree_to_torch(params, dev, torch.bfloat16)
    tile = torch.randn(8, *PATCH, 1, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for key, pc in (("fused", "fused"), ("cat", "cat"), ("true", True)):
            rec[f"tile_dual_forward_ms_{key}"] = cuda_ms(
                lambda: segmodel_apply_packed(
                    DEFAULT_ARCH, pb, tile, pack_max_channels=64, dual=True,
                    upscale=4, plane_out=True, pallas_conv=pc),
                iters=3, warmup=1)
    emit({"phase": "tile_fused", **rec})
    return rec


def phase_tile(params, dev):
    """One full-width tile: packed forward with K1 against the unpacked
    SegModel, both fp32 with TF32 off."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat

    model = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(model, params)
    model = model.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 1).normal(
        size=(1, *PATCH, 1)).astype(np.float32)).to(dev)
    before = pconv_pad11_cat.launches
    with torch.no_grad():
        ref_lr, ref_hr = model(x)
        lr, hr = segmodel_apply_packed(
            DEFAULT_ARCH, convert.flax_tree_from_module(model), x,
            pack_max_channels=64, dual=True, upscale=4, pallas_conv="cat")
    torch.cuda.synchronize()
    if pconv_pad11_cat.launches != before + 1:
        raise AssertionError("packed tile forward did not launch K1")
    tol = 2e-3
    rec = dict(lr_max_abs_err=check_close("tile lr", lr, ref_lr, tol, tol),
               hr_max_abs_err=check_close("tile hr", hr, ref_hr, tol, tol),
               tolerance=tol, lr_shape=list(lr.shape),
               hr_shape=list(hr.shape),
               finite=bool(torch.isfinite(lr).all()
                           and torch.isfinite(hr).all()))
    if not rec["finite"]:
        raise AssertionError("tile logits not finite")
    emit({"phase": "tile", **rec})


def phase_tile_pallas(params, dev):
    """One full-width tile through pallas_conv=True against the unpacked
    SegModel, both fp32 with TF32 off: at DEFAULT_ARCH (K1 once, K3 twice,
    K5 once) and with a 3-conv encoder stage 0 (K4 at stage 0 conv_2 and at
    the last decoder stage's conv_1, K3 once, K5 once, K1 never: that
    stage's offset skip sends the last decoder stage down the unpacked
    concat). Returns the launch counts of both forwards."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
    from rehrseg_tpu_torch.ops import pconv

    names = ("pconv_pad11_cat", "pconv_valid", "pconv_pad11", "pconv3_valid")
    arch3 = dict(DEFAULT_ARCH, n_conv_per_stage=(3, 2, 2, 2, 2, 2))
    x = torch.from_numpy(np.random.default_rng(SEED + 1).normal(
        size=(1, *PATCH, 1)).astype(np.float32)).to(dev)
    out = {}
    for label, arch, p, want in (
            ("default_arch", DEFAULT_ARCH, params,
             dict(pconv_pad11_cat=1, pconv_valid=2, pconv_pad11=0,
                  pconv3_valid=1)),
            ("stage0_3conv", arch3, convert.random_flax_params(arch3, SEED),
             dict(pconv_pad11_cat=0, pconv_valid=1, pconv_pad11=2,
                  pconv3_valid=1))):
        model = SegModel(2, 4, arch=arch)
        convert.load_flax_params(model, p)
        model = model.to(dev).eval()
        with torch.no_grad():
            ref_lr, ref_hr = model(x)
            for n in names:
                getattr(pconv, n).launches = 0
            lr, hr = segmodel_apply_packed(
                arch, convert.flax_tree_from_module(model), x,
                pack_max_channels=64, dual=True, upscale=4, pallas_conv=True)
            torch.cuda.synchronize()
            got = {n: getattr(pconv, n).launches for n in names}
        if got != want:
            raise AssertionError(f"tile_pallas {label}: launches {got}, "
                                 f"the dispatch gives {want}")
        tol = 2e-3
        out[label] = dict(
            lr_max_abs_err=check_close(f"tile_pallas {label} lr", lr,
                                       ref_lr, tol, tol),
            hr_max_abs_err=check_close(f"tile_pallas {label} hr", hr,
                                       ref_hr, tol, tol),
            tolerance=tol, launches=got,
            finite=bool(torch.isfinite(lr).all()
                        and torch.isfinite(hr).all()))
        if not out[label]["finite"]:
            raise AssertionError(f"tile_pallas {label}: logits not finite")
        del model, ref_lr, ref_hr, lr, hr
        torch.cuda.empty_cache()
    emit({"phase": "tile_pallas", **out})
    return out


def phase_main(params, dev, gpu):
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile
    from rehrseg_tpu_torch.serve import Segmenter

    rng = np.random.default_rng(SEED)
    vols = [rng.normal(size=VOLUME).astype(np.float32) for _ in range(2)]
    kw = dict(patch_size=PATCH, compute_dtype=torch.bfloat16, device=dev)
    aligned = Segmenter.from_flax(params, DEFAULT_ARCH, tile_grid="aligned",
                                  **kw)
    parity = Segmenter.from_flax(params, DEFAULT_ARCH, tile_grid="parity",
                                 **kw)
    # warm-up (cuDNN algorithm choice, allocator), not counted
    aligned.segment(vols[0], hr=True)
    parity.segment(vols[0])
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        k1, k2 = pconv_pad11_cat.launches, accumulate_tta_tile.launches
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t,
                pconv_pad11_cat.launches - k1,
                accumulate_tta_tile.launches - k2)

    pconv_pad11_cat.launches = 0
    accumulate_tta_tile.launches = 0
    (lr_a, hr_a), t_dual, k1_dual, k2_dual = timed(
        lambda: aligned.segment(vols[0], hr=True))
    lr_p, t_par, k1_par, k2_par = timed(lambda: parity.segment(vols[0]))
    many, t_many, k1_many, k2_many = timed(
        lambda: aligned.segment_many(vols))
    launches = {"pconv_pad11_cat": pconv_pad11_cat.launches,
                "accumulate_tta_tile": accumulate_tta_tile.launches}

    d, h, w = VOLUME
    for name, arr, shape in (("aligned lr", lr_a, VOLUME),
                             ("aligned hr", hr_a, (4 * d, h, w)),
                             ("parity lr", lr_p, VOLUME),
                             ("many 0", many[0], VOLUME),
                             ("many 1", many[1], VOLUME)):
        if arr.shape != shape or arr.dtype != np.uint8 or arr.max() > 1:
            raise AssertionError(f"{name}: {arr.shape} {arr.dtype}")
    if not np.array_equal(many[0], aligned.segment(vols[0])):
        raise AssertionError("segment_many differs from segment")
    if min(k1_dual, k1_par, k1_many, k2_dual, k2_many) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    lr_vox, hr_vox = d * h * w, 4 * d * h * w
    rec = dict(
        card=gpu, volume=list(VOLUME), patch=list(PATCH), dtype="bf16",
        aligned_dual=dict(seconds=t_dual, lr_voxps=lr_vox / t_dual,
                          lr_hr_voxps=(lr_vox + hr_vox) / t_dual,
                          k1=k1_dual, k2=k2_dual),
        parity_lr=dict(seconds=t_par, voxps=lr_vox / t_par, k1=k1_par,
                       k2=k2_par),
        aligned_many2=dict(seconds=t_many, seconds_per_volume=t_many / 2,
                           voxps=2 * lr_vox / t_many, k1=k1_many,
                           k2=k2_many),
        aligned_vs_parity_lr_agree=float(np.mean(lr_a == lr_p)),
        lr_foreground=float(lr_a.mean()), launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # one tile's dual forward alone, for the breakdown of a volume's time
    tile = torch.randn(8, *PATCH, 1, device=dev, dtype=torch.bfloat16)
    fwd = aligned._fn(True, True)
    with torch.no_grad():
        rec["tile_dual_forward_ms"] = cuda_ms(lambda: fwd(tile), iters=3,
                                              warmup=1)
    emit({"phase": "main", **rec})
    return launches


def phase_main_pallas(params, dev, gpu):
    """One dual aligned volume through the engine with the pallas_conv=True
    forward (the JAX A/B harness's configuration), bf16."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops import pconv
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile
    from rehrseg_tpu_torch.serve import Segmenter

    vol = np.random.default_rng(SEED).normal(size=VOLUME).astype(np.float32)
    segs = {p: Segmenter.from_flax(params, DEFAULT_ARCH, patch_size=PATCH,
                                   compute_dtype=torch.bfloat16, device=dev,
                                   tile_grid="aligned", pallas_conv=p)
            for p in (True, "cat")}
    # VOLUME is at least PATCH on every axis: no padding before the grid
    n_tiles = len(sw.aligned_sliding_window_starts(VOLUME, PATCH, 0.5)[0])
    segs[True].segment(vol, hr=True)      # warm-up, not counted
    counters = {"pconv_pad11_cat": pconv.pconv_pad11_cat,
                "accumulate_tta_tile": accumulate_tta_tile,
                "pconv_valid": pconv.pconv_valid,
                "pconv_pad11": pconv.pconv_pad11,
                "pconv3_valid": pconv.pconv3_valid}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    lr, hr = segs[True].segment(vol, hr=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    want = {"pconv_pad11_cat": n_tiles, "accumulate_tta_tile": 2 * n_tiles,
            "pconv_valid": 2 * n_tiles, "pconv_pad11": 0,
            "pconv3_valid": n_tiles}
    if launches != want:
        raise AssertionError(f"main_pallas: launches {launches}, the "
                             f"dispatch gives {want} over {n_tiles} tiles")
    d, h, w = VOLUME
    for name, arr, shape in (("lr", lr, VOLUME), ("hr", hr, (4 * d, h, w))):
        if arr.shape != shape or arr.dtype != np.uint8 or arr.max() > 1:
            raise AssertionError(f"main_pallas {name}: {arr.shape} "
                                 f"{arr.dtype}")
    cat_lr, cat_hr = segs["cat"].segment(vol, hr=True)
    tile = torch.randn(8, *PATCH, 1, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        ms = {f"tile_dual_forward_ms_{k}": cuda_ms(
                  lambda: segs[p]._fn(True, True)(tile), iters=3, warmup=1)
              for k, p in (("true", True), ("cat", "cat"))}
    lr_vox, hr_vox = d * h * w, 4 * d * h * w
    emit({"phase": "main_pallas", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "dtype": "bf16", "tiles": n_tiles,
          "seconds": secs, "lr_voxps": lr_vox / secs,
          "lr_hr_voxps": (lr_vox + hr_vox) / secs, "launches": launches,
          **ms, "lr_agree_with_cat": float(np.mean(lr == cat_lr)),
          "hr_agree_with_cat": float(np.mean(hr == cat_hr))})
    return launches


def phase_main_fused(params, dev, gpu):
    """One dual aligned volume through Segmenter(pallas_conv="fused") at
    the bench geometry, bf16: every K6 form launches on every tile, K2
    twice, nothing else of K1-K7; LR labels agree with the "cat"
    Segmenter's on at least 98 % of voxels."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.conv2x2 import conv2x2_valid_bias
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile
    from rehrseg_tpu_torch.serve import Segmenter

    vol = np.random.default_rng(SEED).normal(size=VOLUME).astype(np.float32)
    segs = {p: Segmenter.from_flax(params, DEFAULT_ARCH, patch_size=PATCH,
                                   compute_dtype=torch.bfloat16, device=dev,
                                   tile_grid="aligned", pallas_conv=p)
            for p in ("fused", "cat")}
    n_tiles = len(sw.aligned_sliding_window_starts(VOLUME, PATCH, 0.5)[0])
    segs["fused"].segment(vol, hr=True)      # warm-up, not counted
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    lr, hr = segs["fused"].segment(vol, hr=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {**_fused_counts(),
                "accumulate_tta_tile": accumulate_tta_tile.launches,
                "conv2x2_valid_bias": conv2x2_valid_bias.launches}
    want = dict(pconv_pad11_cat_stats=n_tiles, pconv_valid_fused=2 * n_tiles,
                pconv3_valid_fused=n_tiles, pconv_pad11_cat=0, pconv_valid=0,
                pconv_pad11=0, pconv3_valid=0,
                accumulate_tta_tile=2 * n_tiles, conv2x2_valid_bias=0)
    if launches != want:
        raise AssertionError(f"main_fused: launches {launches}, the "
                             f"dispatch gives {want} over {n_tiles} tiles")
    d, h, w = VOLUME
    for name, arr, shape in (("lr", lr, VOLUME), ("hr", hr, (4 * d, h, w))):
        if arr.shape != shape or arr.dtype != np.uint8 or arr.max() > 1:
            raise AssertionError(f"main_fused {name}: {arr.shape} "
                                 f"{arr.dtype}")
    cat_lr, cat_hr = segs["cat"].segment(vol, hr=True)
    lr_agree = float(np.mean(lr == cat_lr))
    if lr_agree < 0.98:
        raise AssertionError(f"main_fused: LR labels agree with the 'cat' "
                             f"Segmenter's on {lr_agree:.4f} of voxels")
    lr_vox, hr_vox = d * h * w, 4 * d * h * w
    emit({"phase": "main_fused", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "dtype": "bf16", "tiles": n_tiles,
          "seconds": secs, "lr_voxps": lr_vox / secs,
          "lr_hr_voxps": (lr_vox + hr_vox) / secs, "launches": launches,
          "lr_agree_with_cat": lr_agree,
          "hr_agree_with_cat": float(np.mean(hr == cat_hr))})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rehrseg_tpu_torch import kernels
        from rehrseg_tpu_torch.models import convert
        from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if Path(kernels.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: the port found at {kernels.__file__} is not the "
              f"checkout beside this script ({here})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": gpu, "device_count": torch.cuda.device_count()})

    t = time.perf_counter()
    logs = kernels.build()
    # ptxas's registers and spills per kernel, for the sources built now
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, out in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": [str(kernels.library_path(n).name)
                        for n in kernels.SOURCES], "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = phase_k1(gen, dev)
    k2 = phase_k2(gen, dev)
    torch.cuda.empty_cache()
    kp = {k: phase_pconv(k, gen, dev) for k in ("k3", "k4", "k5")}

    params = convert.random_flax_params(DEFAULT_ARCH, SEED)
    phase_tile(params, dev)
    torch.cuda.empty_cache()
    tile_pallas = phase_tile_pallas(params, dev)
    launches = phase_main(params, dev, gpu)
    torch.cuda.empty_cache()
    launches_pallas = phase_main_pallas(params, dev, gpu)
    torch.cuda.empty_cache()
    k6 = phase_k6(gen, dev)
    k7 = phase_k7(gen, dev)
    phase_tile_fused(params, dev)
    torch.cuda.empty_cache()
    launches_fused = phase_main_fused(params, dev, gpu)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        dict(name="pconv_pad11_cat", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:889",
             launches=launches["pconv_pad11_cat"],
             **{k: k1[k] for k in keys}),
        dict(name="accumulate_tta_tile", route="cuda",
             source="rehrseg_tpu_torch/csrc/accumulate_tta_tile.cu",
             replaces="rehrseg_tpu/ops/pallas_tail.py:222",
             launches=launches["accumulate_tta_tile"],
             **{k: k2["lr"][k] for k in keys},
             hr={k: k2["hr"][k] for k in keys}),
        dict(name="pconv_valid", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:519",
             launches=launches_pallas["pconv_valid"],
             **{k: kp["k3"][k] for k in keys}),
        # K4's path is the 3-conv stage-0 variant (tile_pallas)
        dict(name="pconv_pad11", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:576",
             launches=tile_pallas["stage0_3conv"]["launches"]["pconv_pad11"],
             launches_in="tile_pallas stage0_3conv",
             **{k: kp["k4"][k] for k in keys}),
        dict(name="pconv3_valid", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv3_valid_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:1117",
             launches=launches_pallas["pconv3_valid"],
             **{k: kp["k5"][k] for k in keys}),
        # the K6 forms: launches on the "fused" path (main_fused)
        dict(name="pconv_pad11_cat(want_stats=True)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:641",
             launches=launches_fused["pconv_pad11_cat_stats"],
             launches_in="main_fused", unfused_ms=k6["k6a"]["unfused_ms"],
             **{k: k6["k6a"][k] for k in keys}),
        dict(name="pconv_valid(pre=, want_stats=True)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:148",
             launches=launches_fused["pconv_valid_fused"],
             launches_in="main_fused", unfused_ms=k6["k6b"]["unfused_ms"],
             **{k: k6["k6b"][k] for k in keys}),
        dict(name="pconv3_valid(pre=, want_stats=True)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv3_valid_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:930",
             launches=launches_fused["pconv3_valid_fused"],
             launches_in="main_fused", unfused_ms=k6["k6c"]["unfused_ms"],
             **{k: k6["k6c"][k] for k in keys}),
        # K7: nothing on any path calls it, in the port as in the JAX
        # package (0 launches in main, main_pallas and main_fused); bf16
        # runs K3's kernel
        dict(name="conv2x2_valid_bias", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_conv.py:126",
             launches=launches_fused["conv2x2_valid_bias"],
             launches_in="no path: called only by its own checks",
             **{k: k7[k] for k in keys}),
    ]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
