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
  tile     one full-width DEFAULT_ARCH tile: the packed forward with K1
           against the unpacked SegModel, fp32 (TF32 off);
  main     the served path: Segmenter (bf16, patch (16, 320, 384)) on
           seeded (20, 455, 633) volumes, aligned grid with the HR head,
           parity grid, segment_many of two volumes; launch counts of K1
           and K2 from these calls only, seconds per volume, voxels/s;
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
             2e-5)):
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
            flops = 2 * n * (h + 1) * (w + 1) * 4 * (ca + cb) * co
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

    params = convert.random_flax_params(DEFAULT_ARCH, SEED)
    phase_tile(params, dev)
    torch.cuda.empty_cache()
    launches = phase_main(params, dev, gpu)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        dict(name="pconv_pad11_cat", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:889",
             launches=launches["pconv_pad11_cat"],
             **{k: k1[k] for k in keys}),
        dict(name="accumulate_tta_tile", route="cuda",
             source="rehrseg_tpu_torch/csrc/accumulate_tta_tile.cu",
             replaces="rehrseg_tpu/ops/pallas_tail.py:222",
             launches=launches["accumulate_tta_tile"],
             **{k: k2["lr"][k] for k in keys},
             hr={k: k2["hr"][k] for k in keys}),
    ]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
