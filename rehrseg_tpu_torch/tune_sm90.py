"""Check and time the variants of the Hopper kernels (bf16 K1, K3, K4, K5,
K6a, K6c) on the card.

    python -m rehrseg_tpu_torch.tune_sm90 [--check-only] [--iters N]
                                          [--rounds R] [--kernels k6a,k6c]

Builds ``csrc/pconv_pad11_cat_sm90.cu``, ``csrc/pconv3_valid_sm90.cu``,
``csrc/pconv2d_sm90.cu`` and the probe ``csrc/l2_feed_probe.cu``, then
prints one JSON line per phase:

  build   nvcc's seconds and ptxas's registers and spills;
  sass    how many wgmma (``HGMMA``), TMA tile-load (``UTMALDG``) and TMA
          tile-store (``UTMASTG``) instructions ``cuobjdump -sass`` finds
          in each built library;
  check   each kernel against its plain version on fp32 copies (tolerance
          0.04) at ragged shapes, the default variant and, for K3, K4, K6a
          and K6c, every variant (K6c also its pre-only and stats-only
          forms; the K6 forms' moment half-sums within 2e-2), with the first
          disagreeing index where one fails (exit code 1 at the end);
  probe   the rate at which TMA boxes shaped like the kernels' input tiles
          reach shared memory, from a region that fits in L2 and from one
          that does not (``l2_feed_probe``);
  tune    at the main path's shapes (bf16), every variant of each kernel
          (K1, K5: blocks per cluster, ring stages, tile width; K3, K4:
          mode 0 weights streamed with the input, 1 weights resident in
          shared memory, 2 resident with the store overlapped by the other
          warpgroup's products, then ring stages and tile width; K6a, K6c:
          ring stages, tile width), each checked first, beside the default
          variant, the library call (cuDNN) on the same operands (K6: none
          computes it; the plain K1 / K5 kernel on the same operands
          instead) and the kernel's bound: the median and the least of R
          timings of N launches, the candidates timed in turn. K6a and
          K6c also time what their epilogue costs (the kernel with the rim
          mask alone, K6a, with the sums but no atomics, and whole) and K6c
          its pre-only and stats-only forms.

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from . import kernels
from .ops import pconv

TOL = 0.04
K1_MAIN = (128, 160, 192, 128, 128, 128)
K5_MAIN = (8, 16, 81, 104, 256, 256)
# (n, h, w, ca, cb, co): an odd height, one and a half tiles wide, Ca != Cb,
# Co = 256, an image smaller than one tile, a batch of one
K1_CHECKS = ((2, 13, 24, 128, 128, 128), (3, 7, 24, 128, 256, 256),
             (1, 3, 8, 128, 128, 128), (2, 16, 32, 256, 128, 384))
# (b, d, hp, wp8, ci, co) with w_out = wp8 - 8
K5_CHECKS = ((2, 3, 14, 32, 128, 128), (1, 1, 10, 32, 128, 256),
             (1, 2, 4, 16, 128, 384), (2, 2, 17, 40, 256, 128))
K3_MAIN = (128, 161, 200, 128, 128)
K4_MAIN = (128, 160, 192, 128, 128)
# (n, hp, wp8, ci, co) with w_out = wp8 - 8: an odd height and one and a half
# tiles wide, Co = 384 and a batch of one, Ci = 256 (the streamed kernel) on
# an image smaller than a tile, Ci = Co = 256, a single output row, and
# enough tiles that every block goes round its ring several times
K3_CHECKS = ((2, 14, 32, 128, 128), (1, 10, 32, 128, 384),
             (3, 4, 16, 256, 128), (2, 19, 40, 256, 256),
             (1, 2, 16, 128, 128), (40, 34, 72, 128, 128))
# (n, h, w, ci, co): the same, and h = 1
K4_CHECKS = ((2, 13, 24, 128, 128), (1, 7, 24, 128, 384),
             (3, 3, 8, 256, 128), (2, 16, 32, 256, 256), (2, 1, 8, 128, 128),
             (40, 33, 64, 128, 128))
# K3 / K4 (mode, stages, log2 tile width): every mode at ragged shapes
MODE_CHECKS = ((0, 3, -1), (1, 3, -1), (1, 4, 5), (2, 2, -1), (2, 5, 3),
               (2, 4, 5))
# K6a (n, h, w, ca, cb, co): K1's, and enough tiles that every block goes
# round its ring several times, w = 8 on two rows
K6A_CHECKS = (*K1_CHECKS, (40, 33, 64, 128, 128, 128),
              (2, 2, 8, 128, 128, 256))
# K6c (b, d, hp, wp8, ci, co) with w_out = wp8 - 8: D = 3, 1, 2 and 4, an
# odd hp, Ci = 256, several ring rounds a block, w_out = 8
K6C_CHECKS = ((2, 3, 14, 32, 128, 128), (1, 1, 10, 32, 128, 256),
              (1, 2, 4, 16, 128, 384), (2, 2, 17, 40, 256, 128),
              (3, 4, 33, 72, 256, 256), (2, 2, 9, 16, 128, 128))
# K6a and K6c (measure, stages, log2 tile width), measure 0: the kernel
K6_VARIANTS = ((0, 3, -1), (0, 2, -1), (0, 3, 3), (0, 3, 4), (0, 3, 5))
# measuring variants, their stats wrong by design: 1 the sums stored without
# atomics; 2 K6a's rim mask alone
K6A_ABLATION = ((1, 3, -1), (2, 3, -1))
K6C_ABLATION = ((1, 3, -1),)
STATS_RTOL = 2e-2
SLOPE = 0.01
K15_VARIANTS = ((1, 3, -1), (2, 3, -1), (1, 2, -1), (2, 2, -1),
                (1, 3, 3), (1, 3, 4), (1, 3, 5))
K34_VARIANTS = ((0, 3, -1), (1, 3, -1), (1, 4, -1), (1, 5, -1), (2, 3, -1),
                (2, 4, -1), (2, 5, -1), (2, 5, 3), (2, 5, 4), (2, 4, 5))


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, warmup=2) -> float:
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


def k1_operands(shape, gen, dev):
    n, h, w, ca, cb, co = shape

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    return (randn(n, h, w, ca).bfloat16(), randn(n, h, w, cb).bfloat16(),
            (randn(2, 2, ca + cb, co) / (4 * (ca + cb)) ** 0.5).bfloat16(),
            (0.1 * randn(co)).bfloat16())


def k5_operands(shape, gen, dev):
    b, d, hp, wp8, ci, co = shape

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    x = randn(b, d, hp, wp8, ci).bfloat16()
    x[..., wp8 - 7:, :] = 1e3     # the pad columns are never read
    return (x, (randn(3, 2, 2, ci, co) / (12 * ci) ** 0.5).bfloat16(),
            (0.1 * randn(co)).bfloat16())


def k3_operands(shape, gen, dev):
    n, hp, wp8, ci, co = shape

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    x = randn(n, hp, wp8, ci).bfloat16()
    x[..., wp8 - 7:, :] = 1e3     # the pad columns are never read
    return (x, (randn(2, 2, ci, co) / (4 * ci) ** 0.5).bfloat16(),
            (0.1 * randn(co)).bfloat16())


def k4_operands(shape, gen, dev):
    n, h, w, ci, co = shape

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    return (randn(n, h, w, ci).bfloat16(),
            (randn(2, 2, ci, co) / (4 * ci) ** 0.5).bfloat16(),
            (0.1 * randn(co)).bfloat16())


def k6c_operands(shape, gen, dev):
    """K5's operands and sa, ta (b, 8, ci) that differ per channel and per
    batch element."""
    b, ci = shape[0], shape[4]
    x, w, bias = k5_operands(shape, gen, dev)
    sa = (torch.randn(b, 1, ci, generator=gen, device=dev).abs() + 0.5)
    ta = 0.5 * torch.randn(b, 1, ci, generator=gen, device=dev)
    return (x, w, bias, sa.expand(-1, 8, -1).bfloat16(),
            ta.expand(-1, 8, -1).bfloat16())


def run_k6a(ops, variant=None):
    xa, xb, w, b = ops
    return pconv._launch_pad11(pconv.pconv_pad11_cat, xa, w, b, xb=xb,
                               want_stats=True, variant=variant)


def run_k6c(ops, variant=None, pre=True, want_stats=True):
    x, w, b, sa, ta = ops
    return pconv._launch_valid(pconv.pconv3_valid, x, w, b, x.shape[3] - 8,
                               pre=(sa, ta, SLOPE) if pre else None,
                               want_stats=want_stats, variant=variant)


def ref_k6a(ops):
    return pconv.pconv_pad11_cat_plain(*(t.float() for t in ops),
                                       want_stats=True)


def ref_k6c(ops, pre=True, want_stats=True):
    """The pre transform in bf16, as the kernel's, then the plain conv in
    fp32."""
    x, w, b, sa, ta = ops
    w_out = x.shape[3] - 8
    xt = x[..., :w_out + 1, :]
    if pre:
        xt = pconv.pre_plain(xt, sa, ta, SLOPE)
    return pconv.pconv3_valid_plain(xt.float(), w.float(), b.float(), w_out,
                                    want_stats=want_stats)


def run_k1(ops, variant=None):
    xa, xb, w, b = ops
    return pconv._launch_pad11(pconv.pconv_pad11_cat, xa, w, b, xb=xb,
                               variant=variant)


def run_k5(ops, variant=None):
    x, w, b = ops
    return pconv._launch_valid(pconv.pconv3_valid, x, w, b, x.shape[3] - 8,
                               variant=variant)


def run_k3(ops, variant=None):
    x, w, b = ops
    return pconv._launch_valid(pconv.pconv_valid, x, w, b, x.shape[2] - 8,
                               variant=variant)


def run_k4(ops, variant=None):
    x, w, b = ops
    return pconv._launch_pad11(pconv.pconv_pad11, x, w, b, variant=variant)


def ref_k1(ops):
    return pconv.pconv_pad11_cat_plain(*(t.float() for t in ops))


def ref_k5(ops):
    x, w, b = ops
    return pconv.pconv3_valid_plain(x.float(), w.float(), b.float(),
                                    x.shape[3] - 8)


def ref_k3(ops):
    x, w, b = ops
    return pconv.pconv_valid_plain(x.float(), w.float(), b.float(),
                                   x.shape[2] - 8)


def ref_k4(ops):
    return pconv.pconv_pad11_plain(*(t.float() for t in ops))


# name -> (main shape, ragged shapes, operands, run, plain version, variants)
KERNELS = {
    "k1": (K1_MAIN, K1_CHECKS, k1_operands, run_k1, ref_k1, K15_VARIANTS),
    "k5": (K5_MAIN, K5_CHECKS, k5_operands, run_k5, ref_k5, K15_VARIANTS),
    "k3": (K3_MAIN, K3_CHECKS, k3_operands, run_k3, ref_k3, K34_VARIANTS),
    "k4": (K4_MAIN, K4_CHECKS, k4_operands, run_k4, ref_k4, K34_VARIANTS),
    "k6a": (K1_MAIN, K6A_CHECKS, k1_operands, run_k6a, ref_k6a, K6_VARIANTS),
    "k6c": (K5_MAIN, K6C_CHECKS, k6c_operands, run_k6c, ref_k6c, K6_VARIANTS),
}
ABLATION = {"k6a": K6A_ABLATION, "k6c": K6C_ABLATION}


def compare(got, want, stats=True) -> dict:
    """Max abs error and, where it is over the tolerance, how many values
    disagree and the first one's index. A K6 form gives (y, stats): y is
    compared so, and the stats' two half-sums (rows 0:8 and 8:16 summed) by
    ``compare_stats`` unless ``stats`` is False (a measuring variant)."""
    if isinstance(got, tuple):
        rec = compare(got[0], want[0])
        if stats:
            npix = want[0][0].numel() // want[0].shape[-1] \
                // (want[1].shape[0] // want[0].shape[0])
            rec.update(compare_stats(got[1], want[1], npix))
            rec["ok"] = rec["ok"] and rec.pop("stats_ok")
        return rec
    err = (got.float() - want).abs()
    bad = err > TOL + TOL * want.abs()
    rec = {"max_abs_err": float(err.max()), "ok": not bool(bad.any())}
    if not rec["ok"]:
        idx = bad.nonzero()[0].tolist()
        rec.update(n_bad=int(bad.sum()), of=bad.numel(), first_bad=idx,
                   got=float(got[tuple(idx)]), want=float(want[tuple(idx)]))
    return rec


def compare_stats(got, want, npix) -> dict:
    """(N, 16, C) moment partials of images of npix pixels as their two
    half-sums: the sums of squares within STATS_RTOL (+ TOL), the sums
    within STATS_RTOL + TOL * sqrt(npix) (a signed sum may cancel)."""
    out, ok = {}, True
    for part, rows, atol in (("sum", slice(0, 8), TOL * npix ** 0.5),
                             ("square", slice(8, 16), TOL)):
        g, w = got[:, rows].sum(1), want[:, rows].sum(1)
        err = (g - w).abs()
        ok = ok and not bool((err > atol + STATS_RTOL * w.abs()).any())
        out[f"stats_{part}_max_abs_err"] = float(err.max())
    return {**out, "stats_ok": ok}


def phase_sass(names):
    """Count the machine instructions that show what the built kernels
    run on: HGMMA is wgmma, UTMALDG a TMA tile load into shared memory,
    UTMASTG a TMA tile store from it."""
    exe = shutil.which("cuobjdump") or str(
        Path(kernels.nvcc_path()).with_name("cuobjdump"))
    for name in names:
        lib = kernels.library_path(name)
        try:
            sass = subprocess.run([exe, "-sass", str(lib)], check=True,
                                  capture_output=True, text=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            emit({"phase": "sass", "library": lib.name, "error": str(e)})
            continue
        emit({"phase": "sass", "library": lib.name,
              "HGMMA": len(re.findall(r"\bHGMMA\.", sass)),
              "UTMALDG": len(re.findall(r"\bUTMALDG\.", sass)),
              "UTMASTG": len(re.findall(r"\bUTMASTG\.", sass)),
              "kinds": sorted(set(re.findall(
                  r"\b(?:HGMMA|UTMALDG|UTMASTG)[.\w]*", sass)))})


def phase_check(names, gen, dev) -> bool:
    ok = True
    for name in names:
        _, shapes, operands, run, ref, _ = KERNELS[name]
        for shape in shapes:
            ops = operands(shape, gen, dev)
            want = ref(ops)
            # K3 / K4: every mode where the weights fit in shared memory;
            # K6a / K6c: every variant, the measuring ones on y alone
            if name in ("k3", "k4"):
                modes = MODE_CHECKS if shape[-2] == 128 else ()
            elif name in ABLATION:
                modes = (*KERNELS[name][5], *ABLATION[name])
            else:
                modes = ()
            for variant in (None, *modes):
                got = run(ops, variant)
                torch.cuda.synchronize()
                rec = compare(got, want,
                              stats=variant not in ABLATION.get(name, ()))
                if name in ("k1", "k4", "k6a"):
                    y = got[0] if name == "k6a" else got
                    rec["zero_columns"] = not bool(
                        (y[:, :, shape[2] + 1:] != 0).any())
                    rec["ok"] = rec["ok"] and rec["zero_columns"]
                ok = ok and rec["ok"]
                emit({"phase": "check", "kernel": name, "shape": shape,
                      "variant": variant, **rec})
            if name == "k6c":   # the forms the "fused" forward does not use
                for form in (dict(pre=True, want_stats=False),
                             dict(pre=False, want_stats=True)):
                    got = run(ops, None, **form)
                    torch.cuda.synchronize()
                    rec = compare(got, ref(ops, **form))
                    ok = ok and rec["ok"]
                    emit({"phase": "check", "kernel": name, "shape": shape,
                          "form": form, **rec})
    return ok


def phase_probe(dev, iters=2000):
    """GB/s of 16 KB TMA boxes (128 rows x 128 bytes of a 512-byte pitch)
    into shared memory, all SMs at once."""
    kernels.build(["l2_feed_probe"])
    fn = kernels.load("l2_feed_probe").l2_feed_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    out = {}
    for label, rows in (("l2_16MB", 32 * 1024), ("hbm_1GB", 2048 * 1024)):
        buf = torch.zeros(rows, 256, dtype=torch.bfloat16, device=dev)
        blocks = ctypes.c_int(0)

        def launch():
            err = fn(buf.data_ptr(), rows, 256, iters, ctypes.byref(blocks),
                     torch.cuda.current_stream().cuda_stream)
            kernels.check(err, "l2_feed_probe")
        ms = cuda_ms(launch, 5)
        out[label] = dict(ms=ms, blocks=blocks.value,
                          gb_per_s=blocks.value * iters * 48 * 1024 / ms / 1e6)
        del buf
    emit({"phase": "probe", "box": "128 rows x 128 B, pitch 512 B", **out})


def _library_case(name, shape, ops, want):
    """(the library call on the same operands, channels-last; FLOP; the
    bytes the function must move) at a kernel's main shape. No library call
    computes a K6 form: its yardstick here is the plain K1 / K5 kernel on
    the same operands (no mask, no sums, no pre)."""
    def cl(t, fmt=torch.channels_last):
        return t.contiguous(memory_format=fmt)
    if name in ("k6a", "k6c"):
        # K1's operands are K6a's; K6c's are K5's, then sa and ta, of which
        # row 0 of each (b, 8, ci) block is read
        plain, conv_ops = ("k1", ops) if name == "k6a" else ("k5", ops[:3])
        _, flops, n_bytes = _library_case(plain, shape, conv_ops, want[0])
        n_bytes += sum(t[:, 0].numel() * 2 for t in ops[len(conv_ops):])
        run_plain = KERNELS[plain][3]
        return (lambda: run_plain(conv_ops), flops,
                n_bytes + want[1].numel() * 4)
    if name == "k1":
        n, h, w, ca, cb, co = shape
        xa, xb, wt, b = ops
        cat = torch.cat([xa, xb], -1).permute(0, 3, 1, 2)
        wl = cl(wt.permute(3, 2, 0, 1))
        return (lambda: F.conv2d(cat, wl, b, padding=1),
                2 * n * h * w * 4 * (ca + cb) * co,
                sum(t.numel() * 2 for t in ops) + want.numel() * 2)
    if name == "k4":
        n, h, w, ci, co = shape
        x, wt, b = ops
        xl, wl = x.permute(0, 3, 1, 2), cl(wt.permute(3, 2, 0, 1))
        return (lambda: F.conv2d(xl, wl, b, padding=1),
                2 * n * h * w * 4 * ci * co,
                sum(t.numel() * 2 for t in ops) + want.numel() * 2)
    x, wt, b = ops
    w_out = x.shape[-2] - 8
    n_bytes = (x[..., :w_out + 1, :].numel() + wt.numel() + b.numel()
               + want.numel()) * 2
    if name == "k3":
        n, hp, wp8, ci, co = shape
        xl = cl(x[:, :, :w_out + 1].permute(0, 3, 1, 2))
        wl = cl(wt.permute(3, 2, 0, 1))
        return (lambda: F.conv2d(xl, wl, b),
                2 * n * (hp - 1) * w_out * 4 * ci * co, n_bytes)
    bsz, d, hp, wp8, ci, co = shape
    xl = cl(x[:, :, :, :w_out + 1].permute(0, 4, 1, 2, 3),
            torch.channels_last_3d)
    wl = cl(wt.permute(4, 3, 0, 1, 2), torch.channels_last_3d)
    return (lambda: F.conv3d(xl, wl, b, padding=(1, 0, 0)),
            2 * bsz * (3 * d - 2) * (hp - 1) * w_out * 4 * ci * co, n_bytes)


def phase_tune(names, gen, dev, iters, rounds):
    peak, hbm = 989e12, 3.35e12
    for name in names:
        shape, _, operands, run, ref, variants = KERNELS[name]
        ops = operands(shape, gen, dev)
        want = ref(ops)
        library, flops, n_bytes = _library_case(name, shape, ops, want)
        checks = []
        for variant in variants:
            # a fault in a launch ends the process: say which it was
            print(f"tune {name} {variant}", file=sys.stderr, flush=True)
            got = run(ops, variant)
            torch.cuda.synchronize()
            checks.append(compare(got, want))
            del got
        # the card's clock drifts under load: time every candidate in turn,
        # several rounds, and keep each one's median and least round
        calls = {"library": library, "default": lambda: run(ops)}
        for variant in (*variants, *ABLATION.get(name, ())):
            calls[variant] = lambda v=variant: run(ops, v)
        if name == "k6c":
            calls["pre_only"] = lambda: run(ops, None, want_stats=False)
            calls["stats_only"] = lambda: run(ops, None, pre=False)
        times = {k: [] for k in calls}
        for _ in range(rounds):
            for k, call in calls.items():
                times[k].append(cuda_ms(call, iters, warmup=1))

        def stat(k):
            t = sorted(times[k])
            return {"ms": t[len(t) // 2], "min_ms": t[0]}
        first = {"k1": "cluster", "k5": "cluster", "k6a": "measure",
                 "k6c": "measure"}.get(name, "mode")
        rec = {"phase": "tune", "kernel": name, "shape": shape,
               "rounds": rounds, "iters": iters,
               "bound_ms": max(flops / peak, n_bytes / hbm) * 1e3,
               "library": stat("library"), "default": stat("default"),
               "variants": [{first: v[0], "stages": v[1], "log_tw": v[2],
                             **stat(v), **c}
                            for v, c in zip(variants, checks)]}
        if name in ABLATION:
            # the plain kernel is the "library" entry: no mask, no sums
            rec["library_is"] = "the plain K1 / K5 kernel, same operands"
            rec["ablation"] = [{first: v[0], "stages": v[1], "log_tw": v[2],
                                **stat(v)} for v in ABLATION[name]]
        if name == "k6c":
            rec["forms"] = {k: stat(k) for k in ("pre_only", "stats_only")}
        emit(rec)
        del ops, want, library
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--iters", type=int, default=5,
                    help="launches per timing")
    ap.add_argument("--rounds", type=int, default=7,
                    help="timings of each candidate, taken in turn")
    ap.add_argument("--kernels", default="k1,k5,k3,k4,k6a,k6c",
                    help="the kernels to check and tune, of k1, k3, k4, k5, "
                         "k6a, k6c")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not torch.cuda.is_available():
        print("tune_sm90: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    libs = ["pconv_pad11_cat_sm90", "pconv3_valid_sm90", "pconv2d_sm90"]
    logs = kernels.build(libs)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "card": torch.cuda.get_device_name(0),
          "cuda": torch.version.cuda,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "Used" in ln or "spill" in ln or "warn" in ln
                        or "Compiling entry" in ln]
                    for k, v in logs.items()}})
    phase_sass(libs)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = phase_check(names, gen, dev)
    if not args.check_only:
        phase_probe(dev)
        phase_tune(names, gen, dev, args.iters, args.rounds)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
