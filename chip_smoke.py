"""Drive the PyTorch port's serving and training paths (stages 1 and 2),
and its multi-device paths as far as one card can, on one NVIDIA GPU and
check them.

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
  cli      the serving CLI at full width: a seeded volume written as NIfTI,
           the seeded weights saved with ``train.checkpoint`` (step 1 and
           the tag "best"), a JSON config; ``python -m
           rehrseg_tpu_torch.serve IN --ckpt --config --out --hr --step
           best`` as a subprocess on the same checkout and build; the LR and
           HR masks read back (shapes, spacings, labels in {0, 1}) and held
           against the in-process ``load_segmenter_from_checkpoint(..)
           .segment(hr=True)`` (agreement gated at 99.9 %), K1's launches
           in that call asserted against the parity grid's tile count; the
           subprocess's wall seconds beside what a process takes to start
           and reach the card, and the in-process seconds of the first
           volume, of a warm one and of a warm ``segment_file``;
  evaluate fold evaluation at full width: two seeded subjects (image and
           a thresholded smooth field as label) as NIfTI, ``pipeline
           .evaluate`` with fp32 weights, ``eval_hr`` and ``save_path``: each
           saved prediction's dice against its label equals the printed
           one, the returned value is their mean, saved shapes and
           spacings, K1 launches = tiles per subject (its fp32 kernel:
           3xTF32 on wgmma), no other kernel launched;
           seconds a subject, peak device memory and one fp32 8-way dual
           tile forward (CUDA events); then K1's fp32 kernel against its
           plain version (TF32 off, 2e-5) at that path's shape, with
           kernel / plain / library times and the bound at the 3xTF32 rate
           (three TF32 products at 495 TFLOP/s) beside the one at fp32's
           FMA rate;
  fp32_forms  every other fp32 form once at the shape its bf16 row uses
           (K4 and K6a on K1's 3xTF32 kernel, K3, K6b and K7 on
           ``csrc/pconv2d_sm90.cu``'s, K5 and K6c on
           ``csrc/pconv3_valid_sm90.cu``'s): against its plain version
           (2e-5; the K6 forms' moment half-sums 1e-4, K6a's on mostly
           positive inputs, as K6b's and K6c's pre makes theirs), kernel /
           plain / library times, the bound at the 3xTF32 rate and the
           kernel's share of it, the bound at fp32's FMA rate beside it;
           the fp32 tile checks (tile_pallas, tile_fused) launch K3, K5,
           K6a, K6b and K6c on their path;
  streamed the served dual parity path through Segmenter(streaming=1) (two
           z-slabs of 6 tiles at the bench geometry, "cat", bf16) beside
           the whole-volume Segmenter in the same process: seconds a
           volume and peak device memory of each engine, LR and HR labels
           equal outside near-ties (normalized logit margin below 1e-3,
           their share printed), K1 launches = the tile count (12);
  sr       FLAVR SR volume inference at the bench volume's geometry seen
           as SR input: a merged 2-channel (x, y, z) = (633, 455, 20)
           volume through UNet3D (NF 512..64, 4 -> 4 slices) seeded
           through the flax bridge: the plain head in fp32 (TF32 off) and
           in bf16, the UASR head in fp32; seconds a volume after a
           warm-up, windows a second, peak memory, the bound from the
           convs' in-range operations; the resident path against the host
           loop (fp32), bf16 against fp32, output shapes; a small fp32
           UNet3D forward on the card against the same module on the CPU;
  cli_sr   ``python -m rehrseg_tpu_torch.serve IN --mode sr --ckpt
           --config --out`` as a subprocess on a merged NIfTI, and again
           with ``--sr-uncertainty`` on a UASR checkpoint (8 slices):
           wall seconds split into process start, NIfTI I/O and volume;
           output shapes, z spacing 1.0 mm, seg in {0, 1}; the image and
           map against an in-process SRVolumizer under the CLI's TF32
           setting, seg agreement gated at 99.9 %;
  train_step  the stage-2 train step at full width (DEFAULT_ARCH, B = 2 x
           (16, 256, 320), slice separation 4, uncertainty on, bf16,
           packed, sr_head_form "auto"): the remat mode select_remat_mode
           picks on the card with each probe's peak memory, ms per step
           over a chain of 8 steps with one sync at the end, peak memory,
           the share of the bound (3x the forward's conv operations over
           989 TFLOP/s; remat's recompute listed apart); the same with
           distillation (the full-width UNet3D teacher, the Distiller) and
           the teacher's ms; one fp32 step (TF32 off) of the packed forward
           against the unpacked SegModel (losses and the whole gradient
           within 2e-3; each leaf against the unpacked fp64 step within
           2e-3 or twice the unpacked fp32 step's own error, the deep
           stages' gradients being ill-conditioned) and bf16 against fp32
           (5e-2);
  train_loop  pipeline.stage2_segsr at full width on a seeded checkerboard
           phantom: two training subjects through
           SegSRDataset.from_volumes, one NIfTI validation subject of one
           enlarged patch, the device augmentation, distillation, bf16, 6
           steps with a validation every 3, then a resume to step 8: steps
           a second, each validation's dice and seconds, the checkpoint
           files, K1's fp32 launches in the validations (asserted: one per
           validation tile; no other kernel runs);
  sr_train_step  the stage-1 SR train steps at configs/brain.yaml's
           geometry (batch 32, bf16 over fp32 master weights,
           onecycle_adam(5e-4, 260000)): WDSR (16 blocks, 32 channels, LR
           96 x 96), FLAVR UNet3D(2, 4, 4) plain and with the UASR head (LR
           (4, 96, 96)): ms per step over a chain of 8 steps after 2
           warm-ups with one sync, peak memory, the share of the bound (3x
           the forward's conv operations over 989 TFLOP/s), the hours
           260,000 steps take at that rate (derived); parameters finite;
           the fp32 step (TF32 off) against the fp64 step (loss 1e-4
           relative, whole gradient 2e-3 by norm) and bf16 against fp32
           (5e-2);
  stage1   pipeline.stage1b_flavr and stage1c_uncertainty through
           ``dataset=``: two merged NIfTI subjects (4 mm slices of a smooth
           1 mm phantom, the PSNR reference), their pseudo-HR arrays made
           with the port's postprocess_sr_volume, device_lr_sim and
           device_augment_sr; the device sampler's batches bit-equal to the
           host BatchLoader's, 6 steps of 1b (a save every 2), 4 of 1c, a
           rerun that trains and writes nothing, then the warm 6-step loop
           through the sampler and the host loader in turns: seconds a
           stage, steps a second with and without the saves, inference
           seconds a subject, the logged PSNR, the SR NIfTIs' shapes
           (finite); no hand kernel launches;
  mesh     Segmenter(mesh=) on the served LR parity path at bench
           geometry: a mesh naming cuda:0 twice (each forward's 8-way
           mirror batch in two blocks of 4) against the single-device
           Segmenter; bf16: K1 launched tiles x data extent times (24),
           labels equal on >= 99 % (batches of 4 and 8 round differently
           in bf16), seconds a volume of each (one card runs every block:
           no scaling number); fp32 (TF32 off): labels equal outside
           near-ties; make_mesh() over the visible card bit-equal to no
           mesh;
  dp       (i) two ranks spawned over gloo on cuda:0 (``chip_smoke.py
           --dp-rank``; NCCL refuses two ranks on one card): a UASR stage-1
           step at configs/brain.yaml's width (global batch 32, 16 a rank,
           label channels on) and a stage-2 packed step (B = 2 x (16, 256,
           320), one a rank), fp32, TF32 off: weights bit-equal across
           ranks, the all-reduced gradients within 2e-3 of the 1-process
           step on the global batch, the metrics written once; (ii) a
           one-rank NCCL group running the stage-2 step through the same
           code;
  fold_all ``pipeline.stage2_segsr_all_folds`` with 2 folds over cuda:0
           named twice on the train_loop phantom (``dataset=``), 3 steps
           with one save and one validation: both checkpoints at step 3,
           distinct finite fold losses, fp32 K1 launches per fold's
           validation tile; fold k's state after one fold-parallel step
           bit-equal to one plain step of fold k (cuDNN deterministic);
  native   the native host library (csrc/rehrseg_host.cpp through
           ``rehrseg_tpu_torch.native``): built or not (the compiler's
           text), each entry point against its numpy / zlib form, and the
           bench volume's .nii.gz read three times through native.gunzip
           and three times through gzip.decompress, seconds of each;
  spatial  Segmenter(mesh=make_mesh(devices=[cuda:0] * 2, spatial=2)) at
           bench geometry (each tile's H in two blocks, parallel.spatial)
           against the single-device Segmenter, the parity LR and dual
           passes, bf16 "cat" (labels equal on >= 99 %) and fp32 (labels
           equal outside near-ties): K1 launched tiles x 2 times, the
           largest normalized-logit difference, seconds a volume, each
           conv's rows per block; then a (data 2, spatial 2) mesh of
           cuda:0 named four times on the bf16 LR pass (K1 tiles x 4);
  spatial_train  the stage-2 step at full width on a spatial group of
           cuda:0 named twice against the unsharded step (fp32, TF32 off:
           losses 1e-6, every gradient leaf 2e-3; bf16 against fp32 5e-2),
           ms a bf16 step both ways and the peak, then 3 steps of
           ``stage2_segsr`` with ``extra.mesh_spatial: 2`` and one
           validation; neither phase gives a scaling number;
  kernels  every ported kernel with launches, error, times and bound.

Then the card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits nonzero and prints no result line.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
# fp32 products by 3xTF32: three dense TF32 tensor-core products each
TF32X3_FLOPS = 495e12 / 3

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


# K1's shape on the served path: decoder stage 4 conv_0 of an 8-way TTA
# batch of PATCH tiles, 32 + 32 features packed to 128 + 128 lanes
K1_MAIN = (128, 160, 192, 128, 128, 128)


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
    for label, (n, h, w, ca, cb, co), dtype, tol in (
            ("bf16_main", K1_MAIN, torch.bfloat16, 0.04),
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


def _k6_case(kernel, shape, dtype, gen, dev, use_pre=True, want_stats=True,
             positive=False):
    """Operands of one K6 check: (kernel call, plain call, fp32 reference,
    unfused call, FLOP, bytes the function must move, output pixels per
    image). The VALID forms read a raw offset input (nonzero rim, 1e3 in the
    pad columns) through a nonzero pre; their reference applies pre in the
    working dtype, as the kernel does, then the plain conv in fp32.
    use_pre / want_stats (the VALID forms): the form with one part alone;
    without want_stats the calls return y alone. positive (K6a): inputs
    mostly positive, a leaky output as a real forward's K6a reads, where a
    bias of the output would add up in its sums."""
    import torch.nn.functional as F
    from rehrseg_tpu_torch.ops import pack2d, pconv

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    if kernel == "k6a":
        n, h, w, ca, cb, co = shape
        xa, xb = randn(n, h, w, ca).to(dtype), randn(n, h, w, cb).to(dtype)
        if positive:
            xa, xb = F.leaky_relu(xa, SLOPE), F.leaky_relu(xb, SLOPE)
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


def json_with_dots(obj) -> str:
    """JSON whose exponent floats carry a dot ("1.0e-05", not "1e-05"):
    YAML 1.1, which the JAX package reads configs with, takes the latter
    for a string. String literals are matched first and kept as they are."""
    def dot(m):
        return m[0] if m[1] is None else f"{m[1]}.0{m[2]}"
    return re.sub(r'"(?:[^"\\]|\\.)*"|(?<![\d.])(-?\d+)(e[-+]?\d+)', dot,
                  json.dumps(obj))


SPACING = (0.9, 0.8, 4.0)      # (x, y, z) mm, as NIfTI stores it


def _subprocess_env(here: Path) -> dict:
    """A subprocess's environment: this checkout and its built kernels."""
    from rehrseg_tpu_torch import kernels

    return dict(os.environ, PYTHONPATH=str(here),
                REHRSEG_TORCH_BUILD_DIR=str(kernels.BUILD_DIR))


def phase_cli(params, dev, gpu, work: Path, here: Path):
    """The served CLI: checkpoint + JSON config + NIfTI in, LR and HR NIfTI
    out, run as ``python -m rehrseg_tpu_torch.serve`` in a subprocess on
    this checkout and its built kernels, then held against the in-process
    Segmenter on the same checkpoint. Returns (K1's launches in the
    in-process call, the seconds a process takes to start and reach the
    card)."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.serve import load_segmenter_from_checkpoint
    from rehrseg_tpu_torch.train import checkpoint as ckpt

    vol = np.random.default_rng(SEED + 3).normal(size=VOLUME).astype(
        np.float32)
    in_path, out, hr_out = (work / "case_0000.nii.gz", work / "seg.nii.gz",
                            work / "hr_seg.nii.gz")
    nifti.write_image_itk(nifti.ItkLikeImage(vol, SPACING), str(in_path))
    model = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(model, params)
    ckpt_dir = work / "ckpt"
    ckpt.save_checkpoint(str(ckpt_dir), model, step=1)
    ckpt.save_checkpoint(str(ckpt_dir), model, step=1, tag="best")
    del model
    arch = {k: [list(x) if isinstance(x, tuple) else x for x in v]
            if isinstance(v, tuple) else v for k, v in DEFAULT_ARCH.items()}
    cfg = work / "cfg.json"
    cfg.write_text(json_with_dots({
        "slice_thickness": 4.0, "target_thickness": 1.0,
        "arch_override": arch, "patch_size_zyx": list(PATCH)}))

    env = _subprocess_env(here)
    # what any process pays before its first volume: interpreter, imports,
    # the card's context
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    "import torch, rehrseg_tpu_torch.serve; "
                    "torch.zeros(1, device='cuda').sum().item()"],
                   cwd=here, env=env, check=True, capture_output=True,
                   timeout=300)
    t_start = time.perf_counter() - t
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rehrseg_tpu_torch.serve", str(in_path),
         "--ckpt", str(ckpt_dir), "--config", str(cfg), "--out", str(out),
         "--hr", str(hr_out), "--step", "best"],
        cwd=here, env=env, capture_output=True, text=True, timeout=900)
    t_cli = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli: the serve CLI exited {proc.returncode}:"
                             f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    d, h, w = VOLUME
    lr, hr = nifti.read_image_itk(str(out)), nifti.read_image_itk(str(hr_out))
    for name, img, shape, spacing in (
            ("lr", lr, VOLUME, SPACING),
            ("hr", hr, (4 * d, h, w), SPACING[:2] + (SPACING[2] / 4,))):
        if (img.array.shape != shape or img.array.dtype != np.uint8
                or img.array.max() > 1
                or not np.allclose(img.spacing, spacing)):
            raise AssertionError(f"cli {name}: {img.array.shape} "
                                 f"{img.array.dtype} spacing {img.spacing}")

    seg = load_segmenter_from_checkpoint(str(ckpt_dir), DEFAULT_ARCH, PATCH,
                                         step="best", device=dev)
    t = time.perf_counter()
    seg.segment(vol, hr=True)      # warm-up, not counted
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    _zero_counts()
    t = time.perf_counter()
    lr_in, hr_in = seg.segment(vol, hr=True)
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t
    launches = pconv_pad11_cat.launches
    n_tiles = len(sw.sliding_window_starts(VOLUME, PATCH))
    if launches != n_tiles:
        raise AssertionError(f"cli: K1 launched {launches} times over "
                             f"{n_tiles} parity tiles")
    t = time.perf_counter()
    seg.segment_file(str(in_path), str(work / "seg2.nii.gz"),
                     hr_out_path=str(work / "hr_seg2.nii.gz"))
    t_file = time.perf_counter() - t
    agree = {"lr": float(np.mean(lr.array == lr_in)),
             "hr": float(np.mean(hr.array == hr_in))}
    if min(agree.values()) < 0.999:
        raise AssertionError(f"cli: the CLI's masks agree with the "
                             f"in-process Segmenter's on {agree}")
    emit({"phase": "cli", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "dtype": "bf16", "grid": "parity",
          "tiles": n_tiles, "cli_wall_seconds": t_cli,
          "process_start_seconds": t_start,
          "in_process_first_volume_seconds": t_first,
          "in_process_seconds_per_volume": t_in,
          "in_process_segment_file_seconds": t_file, "k1_launches": launches,
          "agree_with_in_process": agree, "lr_foreground": float(
              lr.array.mean()), "cli_stdout": proc.stdout.strip()})
    return launches, t_start


def _decided(logits, weights, margin=1e-3):
    """Host mask of the voxels whose normalized top-two logit margin is at
    least ``margin`` (computed on the card)."""
    top2 = (logits / weights).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1] >= margin).cpu().numpy()


def phase_streamed(params, dev, gpu):
    """The served dual parity path with z-slab streaming
    (Segmenter(streaming=1): at z = 20 the 16-deep patch has two z-starts,
    so two slabs) beside the whole-volume Segmenter, bf16, "cat". Returns
    K1's launches in the streamed call."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.serve import Segmenter

    vol = np.random.default_rng(SEED + 5).normal(size=VOLUME).astype(
        np.float32)
    kw = dict(patch_size=PATCH, compute_dtype=torch.bfloat16, device=dev)
    segs = {"streamed": Segmenter.from_flax(params, DEFAULT_ARCH,
                                            streaming=1, **kw),
            "whole": Segmenter.from_flax(params, DEFAULT_ARCH, **kw)}
    n_tiles = len(sw.sliding_window_starts(VOLUME, PATCH))
    n_slabs = len(list(sw._slabs(VOLUME, PATCH, 0.5, 1)))
    rec, out = {}, {}
    for name, seg in segs.items():
        seg.segment(vol, hr=True)       # warm-up, not counted
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t = time.perf_counter()
        out[name] = seg.segment(vol, hr=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rec[name] = dict(seconds=time.perf_counter() - t,
                         k1=pconv_pad11_cat.launches,
                         peak_mem_gb=peak / 1e9,
                         peak_above_start_gb=(peak - base) / 1e9)
    launches = rec["streamed"]["k1"]
    if launches != n_tiles or rec["whole"]["k1"] != n_tiles:
        raise AssertionError(f"streamed: K1 launched {launches} (streamed) /"
                             f" {rec['whole']['k1']} (whole) times over "
                             f"{n_tiles} tiles")
    # the whole-volume logits and gaussian weight sums: the margin reference
    vol_p, _ = segs["whole"]._prep(vol)
    args = (vol_p, PATCH, 4, 0.5, True, True)
    llr, lhr = sw._dual_logits(segs["whole"]._fn(True), *args, 2,
                               torch.bfloat16, dev)

    def ones(b):
        o = torch.ones(*b.shape[:-1], 1, device=dev)
        return o, o.repeat_interleave(4, 1)

    wlr, whr = sw._dual_logits(ones, *args, 1, torch.bfloat16, dev)
    d, h, w = VOLUME
    agree = {}
    for i, (name, logits, weights, shape) in enumerate((
            ("lr", llr, wlr, VOLUME), ("hr", lhr, whr, (4 * d, h, w)))):
        got, want = out["streamed"][i], out["whole"][i]
        if got.shape != shape or got.dtype != np.uint8 or got.max() > 1:
            raise AssertionError(f"streamed {name}: {got.shape} {got.dtype}")
        decided = _decided(logits, weights)
        if not np.array_equal(got[decided], want[decided]):
            raise AssertionError(f"streamed {name}: labels differ from the "
                                 f"whole-volume engine's outside near-ties")
        agree[name] = dict(equal=float(np.mean(got == want)),
                           near_tie_share=float(1.0 - decided.mean()))
    del llr, lhr, wlr, whr, segs
    torch.cuda.empty_cache()
    # the streamed engine's host argmax over its fp32 LR and HR buffers
    rng = np.random.default_rng(SEED)
    bufs = [rng.standard_normal((n * d, h, w, 2), dtype=np.float32)
            for n in (1, 4)]
    t = time.perf_counter()
    for b in bufs:
        np.argmax(b, -1).astype(np.uint8)
    rec["host_argmax_seconds"] = time.perf_counter() - t
    emit({"phase": "streamed", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "dtype": "bf16", "grid": "parity",
          "hr": True, "streaming": 1, "slabs": n_slabs, "tiles": n_tiles,
          **rec, "labels": agree, "k1_launches_streamed": launches})
    return launches


SR_VOLUME = (633, 455, 20)      # (x, y, z): the bench volume as SR input
SR_BATCH = 8


def _sr_input(seed, shape):
    """A merged (x, y, z, 2) volume: a smooth field in [0, 1] and its
    thresholded label."""
    field = _smooth_field(np.random.default_rng(seed), shape,
                          (12.0, 12.0, 2.0))
    field = (field - field.min()) / (field.max() - field.min())
    return np.stack([field, (field > 0.55).astype(np.float64)],
                    -1).astype(np.float32)


def _tap_pairs(n, m, k, s, p, transposed):
    """(output, tap) pairs of one dim whose input index is in range."""
    o = np.arange(n if transposed else m)[:, None] * s - p \
        + np.arange(k)[None]
    return int(((o >= 0) & (o < (m if transposed else n))).sum())


def conv_macs(model_factory, x_shape, by_module: bool = False):
    """Multiply-adds of every conv of one forward on an input of
    ``x_shape``, counting only taps that land in range (no padding taps),
    from the layer shapes on meta tensors; per module name when
    ``by_module``."""
    from torch import nn

    with torch.device("meta"):
        model = model_factory()
    total = {}

    from rehrseg_tpu_torch.models.layers import WNConv

    def geometry(mod):
        """(kernel, stride, padding, in, out, groups) of a conv module;
        WDSR's weight-normed conv is stride 1, SAME."""
        if isinstance(mod, WNConv):
            co, ci, kh, kw = mod.weight_v.shape
            return (kh, kw), (1, 1), (mod.padding,) * 2, ci, co, 1
        return (mod.kernel_size, mod.stride, mod.padding, mod.in_channels,
                mod.out_channels, mod.groups)

    def hook(name):
        def count(mod, inputs, output):
            xin = inputs[0]
            nsp = xin.ndim - 2
            tr = isinstance(mod, nn.ConvTranspose3d)
            k, st, pad, ci, co, groups = geometry(mod)
            pairs = 1
            for i in range(nsp):
                pairs *= _tap_pairs(xin.shape[2 + i], output.shape[2 + i],
                                    k[i], st[i], pad[i], tr)
            total[name] = total.get(name, 0) + (
                xin.shape[0] * pairs * ci * co // groups)
        return count

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            WNConv)):
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.empty(x_shape, device="meta"))
    return total if by_module else sum(total.values())


def phase_sr(dev, gpu):
    """FLAVR volume inference at full width: the plain head in fp32 (TF32
    off) and bf16, the UASR head in fp32. Returns the phase's record."""
    import copy

    from rehrseg_tpu_torch.infer.sr_infer import infer_flavr_volume
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.flavr import UNet3D

    x, y, z = SR_VOLUME
    vol = _sr_input(SEED + 6, SR_VOLUME)
    hp, wp = -(-x // 16) * 16, -(-y // 16) * 16
    n_win = z - 1
    n_computed = -(-n_win // SR_BATCH) * SR_BATCH
    models = {}
    for unc in (False, True):
        m = UNet3D(use_uncertainty=unc)
        convert.load_flax_flavr_params(
            m, convert.random_flavr_params(SEED + unc, use_uncertainty=unc),
            unc)
        models[unc] = m.to(dev).eval()
    models["bf16"] = copy.deepcopy(models[False]).to(torch.bfloat16)
    rec = dict(card=gpu, volume_xyz=list(SR_VOLUME), channels=2,
               batch=SR_BATCH, windows=n_win, windows_computed=n_computed,
               padded_hw=[hp, wp])
    outs = {}
    for label, key, out_index, peak_flops in (
            ("plain_fp32", False, 0, FP32_FLOPS),
            ("plain_bf16", "bf16", 0, BF16_FLOPS),
            ("uasr_fp32", True, 1, FP32_FLOPS)):
        run = lambda: infer_flavr_volume(  # noqa: E731
            models[key], vol, 4.0, out_index=out_index, batch=SR_BATCH,
            device=dev)
        run()                                   # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        outs[label] = run()
        secs = time.perf_counter() - t
        macs = conv_macs(lambda: UNet3D(use_uncertainty=key is True),
                         (1, 4, hp, wp, 2))
        dsize = 2 if key == "bf16" else 4
        n_bytes = (x * y * z * 2 * 4                       # the volume in
                   + outs[label].size * dsize              # the fetch
                   + sum(p.numel() for p in models[key].parameters())
                   * dsize)
        b_ms, b_by = bound(n_bytes, 2 * macs * n_computed, peak_flops)
        rec[label] = dict(seconds=secs, windows_per_second=n_win / secs,
                          peak_mem_gb=torch.cuda.max_memory_allocated()
                          / 1e9, tflop_per_window=2 * macs / 1e12,
                          tflop=2 * macs * n_computed / 1e12,
                          bound_ms=b_ms, bound_by=b_by,
                          bound_share=b_ms / (secs * 1e3),
                          out_shape=list(outs[label].shape))
    want = (x, y, 4 * (z - 1))
    for label, c in (("plain_fp32", 2), ("plain_bf16", 2), ("uasr_fp32", 1)):
        o = outs[label]
        if o.shape != want + (c,) or o.dtype != np.float32 \
                or not np.isfinite(o).all():
            raise AssertionError(f"sr {label}: {o.shape} {o.dtype}")
    unc_map = outs["uasr_fp32"]
    if not (unc_map.min() > 0 and unc_map.max() < 1):
        raise AssertionError("sr: the uncertainty map is not in (0, 1)")
    # the resident path against the host loop (fp32)
    host = infer_flavr_volume(models[False], vol, 4.0, batch=SR_BATCH,
                              resident=False, device=dev)
    tol_host = 1e-5
    rec["resident_vs_host_max_abs_err"] = check_close(
        "sr resident vs host loop", torch.from_numpy(outs["plain_fp32"]),
        torch.from_numpy(host), tol_host, tol_host)
    rec["resident_vs_host_tolerance"] = tol_host
    # bf16 against fp32: per channel, relative to fp32's value range
    ref, got = outs["plain_fp32"], outs["plain_bf16"]
    tol_bf16 = 0.05
    rec["bf16_vs_fp32"] = {}
    for c, name in enumerate(("image", "seg")):
        span = float(ref[..., c].max() - ref[..., c].min())
        err = np.abs(got[..., c] - ref[..., c])
        rec["bf16_vs_fp32"][name] = dict(
            max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
            range=span)
        if err.max() > tol_bf16 * span:
            raise AssertionError(f"sr bf16 {name}: max |err| {err.max()} "
                                 f"over {tol_bf16} of the range {span}")
    rec["bf16_vs_fp32_tolerance"] = f"{tol_bf16} of the fp32 range"
    # a small fp32 forward on the card against the same module on the CPU
    xin = torch.from_numpy(np.random.default_rng(SEED + 7).normal(
        size=(2, 4, 64, 48, 2)).astype(np.float32))
    cpu = copy.deepcopy(models[True]).cpu()
    tol = 1e-4
    with torch.no_grad():
        got_o, got_u = models[True](xin.to(dev))
        want_o, want_u = cpu(xin)
    rec["card_vs_cpu_max_abs_err"] = max(
        check_close("sr card vs cpu out", got_o.cpu(), want_o, tol, tol),
        check_close("sr card vs cpu unc", got_u.cpu(), want_u, tol, tol))
    rec["card_vs_cpu_tolerance"] = tol
    del models, outs, host, cpu
    torch.cuda.empty_cache()
    emit({"phase": "sr", **rec})
    return rec


def phase_cli_sr(dev, gpu, work: Path, here: Path, t_start: float):
    """``python -m rehrseg_tpu_torch.serve --mode sr`` as a subprocess on
    merged NIfTI volumes (the plain head at the full depth, the UASR map
    with --sr-uncertainty at 8 slices), held against an in-process
    SRVolumizer on the same checkpoint under the CLI's TF32 setting (the
    PyTorch default, which the CLI leaves as it is)."""
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.io.volume import parse_image
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.serve import load_sr_from_checkpoint
    from rehrseg_tpu_torch.train import checkpoint as ckpt

    cfg = work / "sr_cfg.json"
    cfg.write_text(json_with_dots({"slice_thickness": 4.0,
                                   "target_thickness": 1.0,
                                   "num_slices": 4}))
    env = _subprocess_env(here)
    rec = dict(card=gpu, process_start_seconds=t_start)
    for label, unc, shape in (("plain", False, SR_VOLUME),
                              ("uasr", True, SR_VOLUME[:2] + (8,))):
        model = UNet3D(use_uncertainty=unc)
        convert.load_flax_flavr_params(
            model, convert.random_flavr_params(SEED + 10 + unc,
                                               use_uncertainty=unc), unc)
        ckpt_dir = work / f"sr_ckpt_{label}"
        ckpt.save_checkpoint(str(ckpt_dir), model, step=1)
        del model
        in_path = work / f"merged_{label}.nii.gz"
        affine = np.diag([*SPACING, 1.0])
        nifti.save(nifti.NiftiImage(data=_sr_input(SEED + 8 + unc, shape),
                                    affine=affine), str(in_path))
        out_base = work / f"sr_{label}"
        flags = ["--sr-uncertainty"] if unc else []
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rehrseg_tpu_torch.serve", str(in_path),
             "--mode", "sr", *flags, "--ckpt", str(ckpt_dir), "--config",
             str(cfg), "--out", str(out_base) + ".nii.gz"],
            cwd=here, env=env, capture_output=True, text=True, timeout=900)
        t_cli = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(
                f"cli_sr {label}: the serve CLI exited {proc.returncode}:"
                f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        x, y, z = shape
        suffixes = ("_uncertainty",) if unc else ("_img", "_seg")
        files = {sfx: nifti.read_image_itk(f"{out_base}{sfx}.nii.gz")
                 for sfx in suffixes}
        for sfx, img in files.items():
            if (img.array.shape != (4 * (z - 1), y, x)
                    or not np.allclose(img.spacing, SPACING[:2] + (1.0,))):
                raise AssertionError(f"cli_sr {label}{sfx}: "
                                     f"{img.array.shape} {img.spacing}")
        if not unc and (files["_seg"].array.dtype != np.uint8
                        or not set(np.unique(files["_seg"].array))
                        <= {0, 1}):
            raise AssertionError("cli_sr: seg is not a {0, 1} uint8 mask")
        # in process, with the CLI's TF32 setting
        torch.backends.cudnn.allow_tf32 = True
        try:
            sr = load_sr_from_checkpoint(str(ckpt_dir), uncertainty=unc,
                                         step=1, device=dev)
            t = time.perf_counter()
            sr.sr_volume(str(in_path), unc)   # warm-up: the first volume
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t
            t = time.perf_counter()
            parse_image(str(in_path), 4.0, 1.0)
            t_read = time.perf_counter() - t
            t = time.perf_counter()
            out = sr.sr_volume(str(in_path), unc)
            t_volume = time.perf_counter() - t
            t = time.perf_counter()
            sr.sr_file(str(in_path), str(work / f"sr2_{label}"),
                       uncertainty=unc)
            t_file = time.perf_counter() - t
        finally:
            torch.backends.cudnn.allow_tf32 = False
        # sr_file = read + volume + (the reference read and the gzip
        # writes); the CLI adds the process start and the checkpoint
        r = dict(shape_xyz=list(shape), cli_wall_seconds=t_cli,
                 in_process_first_volume_seconds=t_first,
                 in_process_sr_file_seconds=t_file,
                 read_seconds=t_read, volume_seconds=t_volume - t_read,
                 write_seconds=t_file - t_volume,
                 cli_rest_seconds=t_cli - t_start - t_file,
                 cli_stdout=proc.stdout.strip())
        tol = 1e-3
        want = out[..., 0].transpose(2, 1, 0)
        scale = float(np.abs(want).max())
        key = "_uncertainty" if unc else "_img"
        r["max_abs_err"] = check_close(
            f"cli_sr {label}", torch.from_numpy(files[key].array),
            torch.from_numpy(want), 0.0, tol * scale)
        r["tolerance"] = f"{tol} of the in-process max |value| {scale}"
        if not unc:
            seg_in = (out[..., 1] > 0).astype(np.uint8).transpose(2, 1, 0)
            r["seg_agree"] = float(np.mean(files["_seg"].array == seg_in))
            r["seg_foreground"] = float(files["_seg"].array.mean())
            if r["seg_agree"] < 0.999:
                raise AssertionError(f"cli_sr: seg agrees with the "
                                     f"in-process SRVolumizer on "
                                     f"{r['seg_agree']}")
        rec[label] = r
        del sr, out
        torch.cuda.empty_cache()
    emit({"phase": "cli_sr", **rec})
    return rec


def _smooth_field(rng, shape, sigma):
    """A seeded normal field low-passed by a gaussian of ``sigma`` voxels
    per axis (in the Fourier domain)."""
    f = np.fft.rfftn(rng.normal(size=shape))
    q = np.meshgrid(*(np.fft.fftfreq(n) for n in shape[:-1]),
                    np.fft.rfftfreq(shape[-1]), indexing="ij")
    f *= np.exp(-2 * np.pi ** 2 * sum((s * qi) ** 2
                                      for s, qi in zip(sigma, q)))
    return np.fft.irfftn(f, s=shape, axes=tuple(range(len(shape))))


def _k1_fp32_main(gen, dev):
    """K1's fp32 kernel (3xTF32 on wgmma) at the shape fold evaluation
    gives it (the bf16 main shape), against its plain version (TF32 off),
    with kernel / plain / library times and the bound at the 3xTF32 rate,
    the one at fp32's FMA rate beside it."""
    from rehrseg_tpu_torch.ops.pconv import (pconv_pad11_cat,
                                             pconv_pad11_cat_plain)
    import torch.nn.functional as F

    n, h, w, ca, cb, co = K1_MAIN
    xa = torch.randn(n, h, w, ca, generator=gen, device=dev)
    xb = torch.randn(n, h, w, cb, generator=gen, device=dev)
    wt = torch.randn(2, 2, ca + cb, co, generator=gen, device=dev) \
        / (4 * (ca + cb)) ** 0.5
    b = 0.1 * torch.randn(co, generator=gen, device=dev)
    y = pconv_pad11_cat(xa, xb, wt, b)
    torch.cuda.synchronize()
    tol = 2e-5
    max_err = check_close("K1 fp32_main", y, pconv_pad11_cat_plain(
        xa, xb, wt, b), tol, tol)
    rec = dict(shape=[n, h, w, ca, cb, co], dtype=str(torch.float32),
               max_abs_err=max_err, tolerance=tol)
    rec["ms"] = cuda_ms(lambda: pconv_pad11_cat(xa, xb, wt, b), iters=5)
    rec["plain_ms"] = cuda_ms(lambda: pconv_pad11_cat_plain(xa, xb, wt, b),
                              iters=5)
    cat = torch.cat([xa, xb], -1).permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    rec["library_ms"] = cuda_ms(lambda: F.conv2d(cat, wl, b, padding=1),
                                iters=5)
    flops = 2 * n * h * w * 4 * (ca + cb) * co
    n_bytes = nbytes(xa, xb, wt, b, y)
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops, TF32X3_FLOPS)
    rec["bound_at"] = "3xTF32: three TF32 products at 495 TFLOP/s"
    rec["fma_bound_ms"] = bound(n_bytes, flops, FP32_FLOPS)[0]
    rec["tflops"] = flops / 1e12
    rec["gbytes"] = n_bytes / 1e9
    return rec


# the fp32 forms other than K1 -> (kernel source, its bf16 row's shape);
# each is bound at the 3xTF32 rate
FP32_FORMS = {
    "k3": ("csrc/pconv2d_sm90.cu", PCONV_SHAPES["k3"][0]),
    "k5": ("csrc/pconv3_valid_sm90.cu", PCONV_SHAPES["k5"][0]),
    "k6b": ("csrc/pconv2d_sm90.cu", K6_SHAPES["k6b"][0]),
    "k6c": ("csrc/pconv3_valid_sm90.cu", K6_SHAPES["k6c"][0]),
    "k7": ("csrc/pconv2d_sm90.cu", (128, 161, 193, 128, 128)),
    "k4": ("csrc/pconv_pad11_cat_sm90.cu", PCONV_SHAPES["k4"][0]),
    "k6a": ("csrc/pconv_pad11_cat_sm90.cu", K6_SHAPES["k6a"][0]),
}


def phase_fp32_forms(gen, dev):
    """Every fp32 form other than K1, once, at the shape its bf16 row
    uses, against its plain version (2e-5; the K6 forms' moment half-sums
    within 1e-4), with kernel / plain / library times (cuDNN fp32, TF32
    off; none for a K6 form), the bound at the 3xTF32 rate and the kernel's
    share of it, and the bound at fp32's FMA rate. Returns the records."""
    import torch.nn.functional as F
    from rehrseg_tpu_torch.ops import pconv
    from rehrseg_tpu_torch.ops.conv2x2 import (conv2x2_valid_bias,
                                               conv2x2_valid_bias_plain)

    tol, f32 = 2e-5, torch.float32
    out = {}
    for kernel, (source, shape) in FP32_FORMS.items():
        rec = dict(source=source, shape=list(shape), dtype=str(f32),
                   tolerance=tol, library_ms=None)
        if kernel in ("k3", "k4", "k5"):
            args, kw, plain, library, flops, in_bytes = _pconv_case(
                kernel, shape, f32, gen, dev)
            fn = getattr(pconv, PCONV_FNS[kernel])
            call = lambda: fn(*args, **kw)              # noqa: E731
            run_plain = lambda: plain(*args)            # noqa: E731
            y = call()
            torch.cuda.synchronize()
            rec["max_abs_err"] = check_close(f"fp32 {kernel}", y,
                                             run_plain(), tol, tol)
            rec["library_ms"] = cuda_ms(library(), iters=3, warmup=1)
            n_bytes = in_bytes + nbytes(y)
        elif kernel == "k7":
            n, hp, wp, ci, co = shape
            x = torch.randn(n, hp, wp, ci, generator=gen, device=dev)
            wt = torch.randn(2, 2, ci, co, generator=gen, device=dev) \
                / (4 * ci) ** 0.5
            b = 0.1 * torch.randn(co, generator=gen, device=dev)
            call = lambda: conv2x2_valid_bias(x, wt, b)    # noqa: E731
            run_plain = lambda: conv2x2_valid_bias_plain(  # noqa: E731
                x, wt, b)
            y = call()
            torch.cuda.synchronize()
            rec["max_abs_err"] = check_close("fp32 k7", y, run_plain(), tol,
                                             tol)
            xl = x.permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rec["library_ms"] = cuda_ms(lambda: F.conv2d(xl, wl, b),
                                        iters=3, warmup=1)
            flops = 2 * n * (hp - 1) * (wp - 1) * 4 * ci * co
            n_bytes = nbytes(x, wt, b, y)
        else:
            call, run_plain, ref, _, flops, n_bytes, npix = _k6_case(
                kernel, shape, f32, gen, dev, positive=kernel == "k6a")
            y, stats = call()
            torch.cuda.synchronize()
            ry, rstats = ref()
            rec["max_abs_err"] = check_close(f"fp32 {kernel}", y, ry, tol,
                                             tol)
            rec.update(check_stats(f"fp32 {kernel}", stats, rstats, npix,
                                   STATS_RTOL[f32], tol))
            del ry, rstats, stats
        rec["ms"] = cuda_ms(call, iters=3, warmup=1)
        rec["plain_ms"] = cuda_ms(run_plain, iters=3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops,
                                                 TF32X3_FLOPS)
        rec["bound_at"] = "3xTF32: three TF32 products at 495 TFLOP/s"
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["fma_bound_ms"] = bound(n_bytes, flops, FP32_FLOPS)[0]
        rec["tflops"] = flops / 1e12
        rec["gbytes"] = n_bytes / 1e9
        out[kernel] = rec
        del y, call, run_plain
        torch.cuda.empty_cache()
    emit({"phase": "fp32_forms", **out})
    return out


def phase_evaluate(params, dev, gpu, work: Path, gen):
    """Fold evaluation of two seeded subjects through pipeline.evaluate
    with fp32 weights on the card (the bf16-uploaded volume meets them in
    fp32: K1's fp32 kernel), eval_hr and save_path. Returns (K1 launches,
    the fp32 K1 record)."""
    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.losses import calculate_dice
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat

    img_dir, lab_dir, save = work / "imagesTr", work / "labelsTr", work / "ev"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(SEED + 4)
    subjects = ["sub_a", "sub_b"]
    labels = {}
    for s in subjects:
        field = _smooth_field(rng, VOLUME, (2.0, 12.0, 12.0))
        field /= field.std()
        labels[s] = (field > 0.3).astype(np.uint8)
        image = (field + 0.5 * rng.normal(size=VOLUME)).astype(np.float32)
        nifti.write_image_itk(nifti.ItkLikeImage(image, SPACING),
                              str(img_dir / f"{s}_0000.nii.gz"))
        nifti.write_image_itk(nifti.ItkLikeImage(labels[s], SPACING),
                              str(lab_dir / f"{s}.nii.gz"))
    model = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(model, params)
    kw = dict(patch_size=PATCH, val_img_path=str(img_dir),
              val_label_path=str(lab_dir), slice_separation=4,
              eval_hr=True, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.evaluate(model, split=subjects[:1], **kw)   # warm-up
    if next(model.parameters()).dtype != torch.float32:
        raise AssertionError("evaluate: the weights are not fp32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        mean = pipeline.evaluate(model, split=subjects, save_path=str(save),
                                 **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = pconv_pad11_cat.launches
    others = {k: v for k, v in _fused_counts().items()
              if k != "pconv_pad11_cat"}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # one fp32 8-way dual tile forward on a bf16 tile, as evaluate runs it
    tile = torch.randn(8, *PATCH, 1, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: pipeline.seg_model_fns(model)[1](tile),
                         iters=3, warmup=1)
    del model, tile
    n_tiles = len(sw.sliding_window_starts(VOLUME, PATCH))
    if launches != n_tiles * len(subjects):
        raise AssertionError(f"evaluate: K1 launched {launches} times, "
                             f"{n_tiles} tiles x {len(subjects)} subjects")
    if any(others.values()):
        raise AssertionError(f"evaluate: other kernels ran: {others}")
    dice = {}
    for line in printed.getvalue().splitlines():
        if line.startswith("Subject "):
            name, value = line[len("Subject "):].split(": ")
            dice[name] = float(value)
    if list(dice) != subjects:
        raise AssertionError(f"evaluate printed {printed.getvalue()!r}")
    d, h, w = VOLUME
    for s in subjects:
        for kind, shape, spacing in (
                ("lr", VOLUME, SPACING),
                ("hr", (4 * d, h, w), SPACING[:2] + (SPACING[2] / 4,))):
            img = nifti.read_image_itk(
                str(save / "val" / f"{s}_pred_{kind}.nii.gz"))
            if (img.array.shape != shape or img.array.max() > 1
                    or not np.allclose(img.spacing, spacing)):
                raise AssertionError(f"evaluate {s} {kind}: "
                                     f"{img.array.shape} {img.spacing}")
            if kind == "lr" and calculate_dice(img.array,
                                               labels[s]) != dice[s]:
                raise AssertionError(f"evaluate {s}: the saved mask's dice "
                                     f"is not the printed {dice[s]}")
    if mean != sum(dice.values()) / len(dice):
        raise AssertionError(f"evaluate returned {mean}, not the mean of "
                             f"{dice}")
    torch.cuda.empty_cache()
    k1 = _k1_fp32_main(gen, dev)
    emit({"phase": "evaluate", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "dtype": "fp32 weights, bf16 upload",
          "grid": "parity", "eval_hr": True, "subjects": len(subjects),
          "seconds": secs, "seconds_per_subject": secs / len(subjects),
          "dice": dice, "mean_dice": mean, "k1_launches": launches,
          "other_launches": others,
          "peak_mem_gb": peak, "tile_dual_forward_ms_fp32": fwd_ms,
          "k1_fp32": k1,
          "printed": printed.getvalue().strip().splitlines()})
    return launches, k1


# stage-2 training at bench.py:159-186's geometry: B = 2 LR patches of
# (16, 256, 320), slice separation 4, uncertainty on, bf16, packed
TRAIN_PATCH = (16, 256, 320)
TRAIN_BATCH = 2
TRAIN_CHAIN = 8


def _train_batch(dev, seed, sep=4):
    """A seeded stage-2 batch on the card: a normal image, its thresholded
    labels (the HR labels the LR ones repeated along z), weights in
    (0.01, 1]."""
    from rehrseg_tpu_torch.train.seg_trainer import SegBatch

    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn(TRAIN_BATCH, *TRAIN_PATCH, 1, generator=g, device=dev)
    label_lr = (img > 0.5).float()
    unc = 0.01 + 0.99 * torch.rand(img.shape, generator=g, device=dev)
    return SegBatch(img, label_lr, label_lr.repeat_interleave(sep, dim=1),
                    unc)


def _recompute_macs(per_module, n, remat):
    """Forward MACs that remat runs again in backward: the checkpointed
    stage functions of segnet_packed._ckpt (a decoder stage holds its
    transposed conv; the seg layer lies outside every stage)."""
    def checkpointed(name):
        parts = name.split(".")
        if name.startswith("decoder.seg_layers"):
            return False
        if remat is True:
            return True
        if name.startswith("encoder.stages."):
            return int(parts[2]) <= 1
        if name.startswith(("decoder.stages.", "decoder.transpconvs.")):
            return int(parts[2]) >= n - 3
        return name.startswith("sr_head")

    if not remat:
        return 0
    return sum(v for k, v in per_module.items() if checkpointed(k))


def _time_chain(step, state, batch):
    """ms per step over TRAIN_CHAIN chained steps with one sync at the end
    (after two warm-up steps), the peak memory in GB and the last step's
    losses."""
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_CHAIN):
        state, m = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    losses = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"train_step: losses {losses}")
    return (start.elapsed_time(end) / TRAIN_CHAIN,
            torch.cuda.max_memory_allocated() / 1e9, losses)


def _rel(a, b, floor=0.0):
    return float((a - b).norm() / max(float(b.norm()), floor, 1e-30))


def _one_step(params, batch, dev, dtype=torch.float32, **kw):
    """Losses and gradients (fp64, on the host) of one step of a fresh
    full-width SegModel whose weights and batch are ``dtype``."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import (SegBatch,
                                                     make_seg_train_step)
    from rehrseg_tpu_torch.train.state import TrainState

    seg = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(seg, params)
    seg.to(dev, dtype)
    state = TrainState(seg, optim.nesterov_sgd(seg),
                       optim.poly_epoch_schedule(1e-2, 100, 1))
    step = make_seg_train_step(seg, enable_uncertainty=True,
                               enable_distillation=False, **kw)
    _, m = step(state, SegBatch(*(t.to(dtype) for t in batch)))
    out = ({k: float(v) for k, v in m.items()},
           {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().double().cpu() for k, p in seg.named_parameters()})
    del seg, state
    torch.cuda.empty_cache()
    return out


def phase_train_step(params, dev, gpu):
    """The stage-2 train step at full width: the remat mode the port's
    select_remat_mode picks on the card with each probe's peak, ms per
    step over a chain of steps, peak memory and the share of the bf16
    dense peak, without and with distillation (the full-width UNet3D
    teacher and the Distiller); then one fp32 step (TF32 off) of the
    packed forward against the unpacked SegModel, and bf16 against fp32.
    Returns the phase's record."""
    import copy

    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.distiller import Distiller
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import (
        REMAT_NAMES, flavr_teacher_features, make_seg_train_step,
        select_remat_mode)
    from rehrseg_tpu_torch.train.state import TrainState

    n = DEFAULT_ARCH["n_stages"]
    batch = _train_batch(dev, SEED + 20)
    per_module = conv_macs(lambda: SegModel(2, 4, arch=DEFAULT_ARCH),
                           (TRAIN_BATCH, *TRAIN_PATCH, 1), by_module=True)
    fwd_macs = sum(per_module.values())
    rec = dict(card=gpu, batch=TRAIN_BATCH, patch=list(TRAIN_PATCH),
               slice_separation=4, precision="bf16", uncertainty=True,
               packed=True, sr_head_form="auto", chain=TRAIN_CHAIN,
               forward_tflop=2 * fwd_macs / 1e12)

    for distill in (False, True):
        seg = SegModel(2, 4, arch=DEFAULT_ARCH)
        convert.load_flax_params(seg, params)
        seg.to(dev)
        train_params, teacher = seg, None
        if distill:
            teacher = UNet3D(2, 4, 4)
            convert.load_flax_flavr_params(
                teacher, convert.random_flavr_params(SEED + 8), False)
            teacher.to(dev)
            dist = Distiller(DEFAULT_ARCH["features_per_stage"][1], 64)
            convert.load_flax_distiller_params(
                dist, convert.random_distiller_params(
                    SEED + 9, student_dim=DEFAULT_ARCH["features_per_stage"]
                    [1]))
            train_params = {"seg": seg, "distiller": dist.to(dev)}
        state = TrainState(train_params, optim.nesterov_sgd(train_params),
                           optim.poly_epoch_schedule(1e-2, 100, 1))

        def build(mode):
            return make_seg_train_step(
                seg, enable_uncertainty=True, enable_distillation=distill,
                flavr_model=teacher, remat=mode, precision="bf16")

        probes = {}
        mode, why = select_remat_mode(build, state, batch, probes=probes)
        ms, peak, losses = _time_chain(build(mode), state, batch)
        recompute = _recompute_macs(per_module, n, mode)
        # forward + backward = 3x the forward's MACs, remat's recompute
        # listed apart; the teacher's convs are not counted
        b_ms = 3 * 2 * fwd_macs / BF16_FLOPS * 1e3
        r = dict(remat=REMAT_NAMES[mode], remat_reason=why,
                 probe_peak_gb={k: (None if v is None else v / 1e9)
                                for k, v in probes.items()},
                 ms_per_step=ms, peak_mem_gb=peak, losses=losses,
                 train_tflop=3 * 2 * fwd_macs / 1e12,
                 recompute_tflop=2 * recompute / 1e12,
                 bound_ms=b_ms, bound_share=b_ms / ms,
                 bound_share_with_recompute=(b_ms + 2 * recompute
                                             / BF16_FLOPS * 1e3) / ms)
        if distill:
            t16 = copy.deepcopy(teacher).to(torch.bfloat16)
            with torch.no_grad():
                r["teacher_ms"] = cuda_ms(lambda: flavr_teacher_features(
                    t16, batch.img, batch.label_lr,
                    compute_dtype=torch.bfloat16), iters=3, warmup=1)
            r["teacher_share"] = r["teacher_ms"] / ms
            del t16
        rec["distilled" if distill else "plain"] = r
        del seg, state, train_params, teacher
        torch.cuda.empty_cache()

    # correctness: fp32 (TF32 off) packed against unpacked, bf16 against
    # fp32, one step of fresh models from the same weights. The deep
    # stages' gradients are ill-conditioned (an instance norm over few
    # voxels amplifies fp32 rounding): there the unpacked fp32 step itself
    # lies up to about 1e-2 from the fp64 step, so each leaf is held to the
    # fp64 unpacked step, within 2e-3 or twice the unpacked fp32 step's own
    # error where that is larger; losses and the whole gradient within
    # 2e-3 of the unpacked fp32 step.
    tol, tol_bf16 = 2e-3, 5e-2
    l_p, g_p = _one_step(params, batch, dev, remat="hires")
    l_u, g_u = _one_step(params, batch, dev, packed=False)
    l_r, g_r = _one_step(params, batch, dev, torch.float64, packed=False)
    l_b, g_b = _one_step(params, batch, dev, remat="hires",
                         precision="bf16")

    def flat(g):
        return torch.cat([v.ravel() for v in g.values()])

    # a leaf whose true gradient is zero (a conv bias ahead of an instance
    # norm) holds rounding noise: its error is taken against at least 1e-3
    # of the whole gradient's norm
    floor = 1e-3 * float(flat(g_r).norm())
    leaves = {k: (_rel(g_p[k], g_r[k], floor), _rel(g_u[k], g_r[k], floor))
              for k in g_r}
    over = {k: v for k, v in leaves.items() if v[0] > max(tol, 2 * v[1])}
    worst = max(leaves, key=lambda k: leaves[k][0] / max(tol,
                                                         2 * leaves[k][1]))
    loss_err = max(abs(l_p[k] - l_u[k]) / abs(l_u[k]) for k in l_u)
    grad_err = _rel(flat(g_p), flat(g_u))
    if loss_err > tol or grad_err > tol or over:
        raise AssertionError(f"train_step packed vs unpacked: loss "
                             f"{loss_err}, gradient {grad_err}, leaves "
                             f"over (packed, unpacked fp32 vs fp64): {over}")
    bf16_loss_err = max(abs(l_b[k] - l_p[k]) / abs(l_p[k]) for k in l_p)
    bf16_grad_err = _rel(flat(g_b), flat(g_p))
    if bf16_loss_err > tol_bf16 or bf16_grad_err > tol_bf16:
        raise AssertionError(f"train_step bf16 vs fp32: loss "
                             f"{bf16_loss_err}, grads {bf16_grad_err}")
    rec.update(packed_vs_unpacked=dict(
        loss_rel_err=loss_err, grad_rel_norm=grad_err, tolerance=tol,
        leaf_vs_fp64_max=max(v[0] for v in leaves.values()),
        unpacked_fp32_leaf_vs_fp64_max=max(v[1] for v in leaves.values()),
        worst_leaf=dict(name=worst, packed_vs_fp64=leaves[worst][0],
                        unpacked_fp32_vs_fp64=leaves[worst][1]),
        leaf_rule="packed fp32 vs unpacked fp64 <= max(2e-3, 2x unpacked "
                  "fp32 vs unpacked fp64)",
        losses=l_p, losses_fp64=l_r),
        bf16_vs_fp32=dict(loss_rel_err=bf16_loss_err,
                          grad_rel_norm=bf16_grad_err,
                          tolerance=tol_bf16))
    emit({"phase": "train_step", **rec})
    return rec


def _phantom(rng, shape):
    """A checkerboard phantom (x, y, z): 32-voxel squares in-plane, 8-slice
    blocks in z, with noise; its label marks the bright squares inside a
    ball."""
    x, y, z = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    board = ((x // 32 + y // 32 + z // 8) % 2).astype(np.float32)
    ball = ((x - shape[0] / 2) ** 2 / (shape[0] / 2.5) ** 2
            + (y - shape[1] / 2) ** 2 / (shape[1] / 2.5) ** 2
            + (z - shape[2] / 2) ** 2 / (shape[2] / 2.5) ** 2) < 1
    img = board + 0.3 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), (board * ball).astype(np.float32)


def _loop_tree(root: Path):
    """The stage-2 loop's inputs under ``root`` (the train_loop phase's): a
    NIfTI validation subject of one enlarged patch (a checkerboard
    phantom), nnUNet splits, two seeded training volumes through
    SegSRDataset.from_volumes with the device augmentation, and a config
    factory over DEFAULT_ARCH at TRAIN_PATCH, batch 2, a validation every
    3 steps. Returns (patch zyx, validation zyx, config(epochs, **extra),
    dataset)."""
    import json

    from rehrseg_tpu_torch.config import Config
    from rehrseg_tpu_torch.data.datasets import SegSRDataset
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH

    patch_zyx = list(TRAIN_PATCH)
    patch_ori = [patch_zyx[2] + 64, patch_zyx[1] + 64, patch_zyx[0]]
    val_zyx = tuple(patch_ori[::-1])         # one enlarged patch: one tile
    rng = np.random.default_rng(SEED + 30)
    for d in ("imagesTr", "labelsTr"):
        (root / d).mkdir(parents=True)
    img, lab = _phantom(rng, val_zyx[::-1])
    nifti.write_image_itk(nifti.ItkLikeImage(img.transpose(2, 1, 0),
                                             SPACING),
                          str(root / "imagesTr" / "v0_0000.nii.gz"))
    nifti.write_image_itk(nifti.ItkLikeImage(
        lab.transpose(2, 1, 0).astype(np.uint8), SPACING),
        str(root / "labelsTr" / "v0.nii.gz"))
    seg_path = root / "nnUNet_results" / "DS" / "trainer"
    seg_path.mkdir(parents=True)
    (root / "nnUNet_preprocessed" / "DS").mkdir(parents=True)
    (root / "nnUNet_preprocessed" / "DS" / "splits_final.json").write_text(
        json.dumps([{"train": ["t0", "t1"], "val": ["v0"]}]))
    hr_shape = (patch_ori[0] + 16, patch_ori[1] + 16, 4 * patch_zyx[0] + 8)
    vols = []
    for _ in range(2):
        im, lb = _phantom(rng, hr_shape)
        vols.append((im, lb, rng.uniform(0, 255, size=hr_shape).astype(
            np.float32)))
    ds = SegSRDataset.from_volumes(vols, 4.0, 1.0, patch_ori,
                                   patch_zyx[::-1], random_flip=True,
                                   uncertainty=True, device_augment=True)
    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in DEFAULT_ARCH.items()}

    def config(epochs, **extra):
        return Config(data_path=str(root / "imagesTr"),
                      tmp_path=str(root / "tmp"),
                      checkpoint_path=str(root / "ckpt"),
                      seg_path=str(seg_path), fold=0, epochs=epochs,
                      batch_size_segsr=2, save_iters_segsr=3,
                      extra={"arch_override": arch,
                             "patch_size_zyx": patch_zyx, **extra})

    return patch_zyx, val_zyx, config, ds


def phase_train_loop(dev, gpu, work: Path):
    """pipeline.stage2_segsr at full width on a seeded phantom: two
    training subjects through SegSRDataset.from_volumes, one NIfTI
    validation subject of one enlarged patch, the device augmentation,
    distillation, bf16, remat chosen on the card, 6 steps with a
    validation every 3; then a resume to step 8. Returns the K1 launches
    in the validations."""
    import json

    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.train import checkpoint as ckpt

    root = work / "train_loop"
    patch_zyx, val_zyx, config, ds = _loop_tree(root)

    evals = []
    evaluate = pipeline.evaluate

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*a, **k)
        evals.append(dict(dice=out, seconds=time.perf_counter() - t0))
        return out

    pipeline.evaluate = timed_evaluate
    printed = io.StringIO()
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            _, state, best = pipeline.stage2_segsr(config(6), dataset=ds,
                                                   device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = pconv_pad11_cat.launches
        counts = _fused_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            _, state2, _ = pipeline.stage2_segsr(config(8), dataset=ds,
                                                 device=dev)
        torch.cuda.synchronize()
        secs_resume = time.perf_counter() - t
    finally:
        pipeline.evaluate = evaluate
    seg_dir = root / "ckpt" / "segsr"
    files = sorted(str(p.relative_to(seg_dir))
                   for p in seg_dir.rglob("*") if p.is_file())
    log = [json.loads(line) for line in
           (seg_dir / "metrics.jsonl").read_text().splitlines()]
    n_tiles = len(sw.sliding_window_starts(val_zyx, val_zyx))
    lines = printed.getvalue().strip().splitlines()
    if state.step != 6 or state2.step != 8 or len(evals) != 2:
        raise AssertionError(f"train_loop: steps {state.step}, "
                             f"{state2.step}, {len(evals)} validations")
    if launches != len(evals) * n_tiles:
        raise AssertionError(f"train_loop: K1 launched {launches} times, "
                             f"{len(evals)} validations x {n_tiles} tiles")
    if any(v for k, v in counts.items() if k != "pconv_pad11_cat"):
        raise AssertionError(f"train_loop: other kernels ran: {counts}")
    if ckpt.latest_step(str(seg_dir)) != 8 or "best/state.pt" not in files:
        raise AssertionError(f"train_loop: checkpoints {files}")
    dice = [e["dice"] for e in evals]
    losses = [r["loss"] for r in log if "loss" in r]
    if not all(0.0 <= d <= 1.0 for d in dice) or not all(
            np.isfinite(v) for v in losses) or best != max(dice):
        raise AssertionError(f"train_loop: dice {dice}, losses {losses}")
    rec = dict(card=gpu, steps=6, resumed_to=8, batch=2,
               patch=patch_zyx, val_volume_zyx=list(val_zyx),
               val_tiles=n_tiles, seconds=secs,
               steps_per_second=6 / secs, resume_seconds=secs_resume,
               validations=evals, best_dice=best, logged_losses=losses,
               k1_fp32_launches=launches, checkpoint_files=files,
               remat=[ln for ln in lines if ln.startswith("remat")],
               printed=lines[-12:])
    emit({"phase": "train_loop", **rec})
    return launches


# stage 1 at configs/brain.yaml's geometry: patch_size 96, num_slices 4,
# slice separation 4, batch_size_sr 32; 260,000 steps (n_patches 8,320,000
# / 32)
SR_BATCH = 32
SR_PATCH = 96
SR_STEPS = 260_000
STAGE1_HR = (128, 128, 112)     # the stage1 phantom's (x, y, z) at 1 mm


def _sr_models():
    """(name, factory, LR batch shape, HR batch shape, uncertainty,
    num_slices) of the three stage-1 trainings: WDSR (16 blocks, 32
    channels, scale 4) on 96 x 96 in-plane patches, FLAVR UNet3D(2, 4, 4)
    plain and with the UASR head on (4, 96, 96) windows."""
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.models.wdsr import WDSR

    b, p = SR_BATCH, SR_PATCH
    return (
        ("wdsr", lambda: WDSR(2, 16, 32, 4.0), (b, p, p, 2),
         (b, 4 * p, p, 2), False, 1),
        ("flavr", lambda: UNet3D(2, 4, 4), (b, 4, p, p, 2),
         (b, 16, p, p, 2), False, 4),
        ("uasr", lambda: UNet3D(2, 4, 4, use_uncertainty=True),
         (b, 4, p, p, 2), (b, 16, p, p, 2), True, 4))


def _sr_params(name):
    from rehrseg_tpu_torch.models import convert

    if name == "wdsr":
        return convert.random_wdsr_params(SEED + 40)
    return convert.random_flavr_params(SEED + 41,
                                       use_uncertainty=name == "uasr")


def _sr_state(name, factory, params, dev, dtype=torch.float32):
    """A fresh model of ``name`` from ``params`` on the card in ``dtype``,
    with the stage-1 onecycle_adam(5e-4, 260000) state."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.state import TrainState

    model = factory()
    if name == "wdsr":
        convert.load_flax_wdsr_params(model, params)
    else:
        convert.load_flax_flavr_params(model, params, name == "uasr")
    model.to(dev, dtype)
    return model, TrainState(model, *optim.onecycle_adam(model, 5e-4,
                                                         SR_STEPS))


def _sr_batch(lr_shape, hr_shape, dev, seed):
    """A seeded SR batch on the card: images in [0, 1], labels in {0,
    1}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lr = torch.rand(lr_shape, generator=g, device=dev)
    hr = torch.rand(hr_shape, generator=g, device=dev)
    lr[..., 1] = (lr[..., 1] > 0.5).float()
    hr[..., 1] = (hr[..., 1] > 0.5).float()
    return lr, hr


def phase_sr_train_step(dev, gpu):
    """The stage-1 SR train steps at full width (configs/brain.yaml): WDSR,
    FLAVR plain and FLAVR UASR at batch 32, bf16 over fp32 master weights,
    onecycle_adam(5e-4, 260000): ms per step over a chain of 8 steps after
    2 warm-ups with one sync at the end (CUDA events), peak memory, the
    share of the bound (3x the forward's conv operations over 989 TFLOP/s)
    and the hours 260,000 steps take at that rate; parameters finite after
    the chain. Checks, from one state and batch: the fp32 step (TF32 off)
    against the fp64 step (loss 1e-4 relative, whole gradient 2e-3 by
    norm), the bf16 step against the fp32 step (loss and gradient 5e-2).
    Returns the phase's record."""
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step

    rec = dict(card=gpu, batch=SR_BATCH, precision="bf16",
               optimizer="onecycle_adam(5e-4, 260000)", chain=TRAIN_CHAIN,
               steps_for_hours=SR_STEPS)
    for i, (name, factory, lr_shape, hr_shape, unc, ns) in enumerate(
            _sr_models()):
        params = _sr_params(name)
        lr, hr = _sr_batch(lr_shape, hr_shape, dev, SEED + 50 + i)
        fwd_flop = 2 * conv_macs(factory, lr_shape)
        b_ms = 3 * fwd_flop / BF16_FLOPS * 1e3

        def step_of(model, precision):
            return make_sr_train_step(model, enable_uncertainty=unc,
                                      slice_separation=4, num_slices=ns,
                                      precision=precision)

        model, state = _sr_state(name, factory, params, dev)
        step = step_of(model, "bf16")
        for _ in range(2):
            state, m = step(state, lr, hr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAIN_CHAIN):
            state, m = step(state, lr, hr)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TRAIN_CHAIN
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = float(m["loss"])
        if not np.isfinite(loss) or not all(
                torch.isfinite(p).all() for p in model.parameters()):
            raise AssertionError(f"sr_train_step {name}: loss {loss}, or "
                                 f"parameters not finite after the chain")
        del model, state, step
        torch.cuda.empty_cache()

        def one_step(dtype, precision):
            """Loss and flat gradient (fp64, on the card) of one step of a
            fresh model from ``params``."""
            model, state = _sr_state(name, factory, params, dev, dtype)
            _, m = step_of(model, precision)(state, lr.to(dtype),
                                             hr.to(dtype))
            g = torch.cat([p.grad.double().ravel()
                           for p in model.parameters()])
            out = float(m["loss"]), g
            del model, state
            torch.cuda.empty_cache()
            return out

        l64, g64 = one_step(torch.float64, None)
        l32, g32 = one_step(torch.float32, None)
        l16, g16 = one_step(torch.float32, "bf16")
        err32 = (abs(l32 - l64) / abs(l64), _rel(g32, g64))
        err16 = (abs(l16 - l32) / abs(l32), _rel(g16, g32))
        if err32[0] > 1e-4 or err32[1] > 2e-3:
            raise AssertionError(f"sr_train_step {name}: fp32 vs fp64 "
                                 f"loss {err32[0]}, gradient {err32[1]}")
        if err16[0] > 5e-2 or err16[1] > 5e-2:
            raise AssertionError(f"sr_train_step {name}: bf16 vs fp32 "
                                 f"loss {err16[0]}, gradient {err16[1]}")
        del g64, g32, g16
        torch.cuda.empty_cache()
        rec[name] = dict(
            lr_batch=list(lr_shape), hr_batch=list(hr_shape),
            forward_tflop=fwd_flop / 1e12, train_tflop=3 * fwd_flop / 1e12,
            ms_per_step=ms, peak_mem_gb=peak, bound_ms=b_ms,
            bound_share=b_ms / ms,
            hours_for_260000_steps_derived=ms * SR_STEPS / 3.6e6,
            loss=loss,
            fp32_vs_fp64=dict(loss_rel_err=err32[0],
                              grad_rel_norm=err32[1],
                              tolerance=dict(loss=1e-4, grad=2e-3)),
            bf16_vs_fp32=dict(loss_rel_err=err16[0],
                              grad_rel_norm=err16[1], tolerance=5e-2))
        del lr, hr
        torch.cuda.empty_cache()
    emit({"phase": "sr_train_step", **rec})
    return rec


def _all_counts():
    """Every hand kernel's launch count: the pconv forms, K7 and K2."""
    from rehrseg_tpu_torch.ops.conv2x2 import conv2x2_valid_bias
    from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile

    return {**_fused_counts(),
            "conv2x2_valid_bias": conv2x2_valid_bias.launches,
            "accumulate_tta_tile": accumulate_tta_tile.launches}


def _mtimes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns
            for p in root.rglob("*") if p.is_file()}


def _hr_phantom(rng, shape):
    """A smooth HR (x, y, z) image in [0, 1] and its label (a ball of the
    brighter half)."""
    field = _smooth_field(rng, shape, (10.0, 10.0, 8.0))
    field = (field - field.min()) / (field.max() - field.min())
    x, y, z = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    ball = sum(((a - n / 2) / (n / 2.6)) ** 2
               for a, n in ((x, shape[0]), (y, shape[1]), (z, shape[2]))) < 1
    return field.astype(np.float32), ((field > 0.5) & ball).astype(
        np.float32)


def phase_stage1(dev, gpu, work: Path):
    """Stages 1b and 1c on the card through ``dataset=``: two merged
    2-channel NIfTI subjects (LR 4 mm slices of a smooth HR phantom, whose
    1 mm volume is the PSNR reference), their pseudo-HR arrays (the cubic
    zoom and the port's postprocess_sr_volume) as
    SRPatchDataset.from_volumes; configs/brain.yaml's geometry (patch 96,
    4 slices, batch 32), bf16, device_lr_sim and device_augment_sr, so the
    loop runs DeviceSRPatchSampler, simulate_lr_batch and
    augment_sr_hr_batch. First the sampler's batches against the host
    BatchLoader's, bit for bit; then stage1b_flavr (6 steps, a save every
    2), stage1c_uncertainty (4 steps, warm-started from 1b) and a rerun of
    both that must train and write nothing; the same 6 steps through the
    host loader. Seconds a stage, the loop's steps a second (saves
    included) with each loader, inference seconds a subject, the PSNR the
    pipeline logged, the SR NIfTIs' shapes (finite). No hand kernel runs.
    Returns the phase's record."""
    import json

    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.config import Config
    from rehrseg_tpu_torch.data.datasets import (BatchLoader,
                                                 PrefetchLoader,
                                                 SRPatchDataset)
    from rehrseg_tpu_torch.data.device_sampler import DeviceSRPatchSampler
    from rehrseg_tpu_torch.infer.sr_infer import (interpolate_pseudo_sr,
                                                  postprocess_sr_volume)
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.io.volume import parse_image
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step
    from rehrseg_tpu_torch.train.state import TrainState

    root = work / "stage1"
    for d in ("imagesTr", "labelsTr", "hr"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(SEED + 60)
    for s in ("s0", "s1"):
        img, lab = _hr_phantom(rng, STAGE1_HR)
        nifti.write_image_itk(
            nifti.ItkLikeImage(img.transpose(2, 1, 0), (1.0, 1.0, 1.0)),
            str(root / "hr" / f"{s}_0000.nii.gz"))
        for d, a in (("imagesTr", img), ("labelsTr", lab)):
            name = f"{s}_0000.nii.gz" if d == "imagesTr" else f"{s}.nii.gz"
            nifti.write_image_itk(nifti.ItkLikeImage(
                a[:, :, 1::4].transpose(2, 1, 0), (1.0, 1.0, 4.0)),
                str(root / d / name))
    cfg = Config(data_path=str(root / "imagesTr"),
                 tmp_path=str(root / "tmp"),
                 checkpoint_path=str(root / "ckpt"), batch_size_sr=SR_BATCH,
                 patch_size=SR_PATCH, n_patches=6 * SR_BATCH, save_iters_sr=2,
                 uncertainty_steps=4,
                 extra={"device_lr_sim": True, "device_augment_sr": True,
                        "hr_reference_path": str(root / "hr")})
    pipeline.preprocess(cfg)
    merged = pipeline.pipeline_paths(cfg)["merge_data"]
    vols = []
    for s in sorted(os.listdir(merged)):
        image, _, _, fwhm, *_ = parse_image(os.path.join(merged, s),
                                            cfg.slice_thickness,
                                            cfg.target_thickness)
        img, lab = interpolate_pseudo_sr(image[..., 0], image[..., 1],
                                         cfg.slice_separation)
        fx, fy = postprocess_sr_volume(img, fwhm, cfg.blur_kernel)
        vols.append((img[..., None], (lab[..., None] > 0.5).astype(np.uint8),
                     fx, fy))
    patch = [cfg.num_slices * 4, cfg.patch_size, cfg.patch_size]

    def dataset():
        return SRPatchDataset.from_volumes(vols, cfg.slice_thickness,
                                           cfg.target_thickness, patch,
                                           cfg.random_flip,
                                           device_lr_sim=True)

    host, dev_sampler = (BatchLoader(dataset(), SR_BATCH, seed=5),
                         DeviceSRPatchSampler(dataset(), SR_BATCH, seed=5,
                                              device=dev))
    for _ in range(3):
        (lh, hh), (ld, hd) = host.next(), dev_sampler.next()
        if not (torch.equal(ld.cpu(), torch.from_numpy(lh))
                and torch.equal(hd.cpu(), torch.from_numpy(hh))):
            raise AssertionError("stage1: the device sampler's batch "
                                 "differs from the host loader's")
    sampler_mb = dev_sampler.device_bytes / 1e6
    dev_sampler.close()

    loops, infers = [], []
    train_loop, flavr_inference = (pipeline._train_sr_loop,
                                   pipeline._flavr_inference)

    saves = []
    save = TrainState.save

    def timed_save(self, *a, **k):
        t0 = time.perf_counter()
        out = save(self, *a, **k)
        saves.append(time.perf_counter() - t0)
        return out

    def timed_loop(state, loader, *a, **k):
        torch.cuda.synchronize()
        t0, s0, n0 = time.perf_counter(), int(state.step), len(saves)
        out = train_loop(state, loader, *a, **k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        save_s = sum(saves[n0:])
        loops.append(dict(loader=type(loader).__name__,
                          steps=int(out.step) - s0, seconds=secs,
                          saves=len(saves) - n0, save_seconds=save_s,
                          steps_per_second=(int(out.step) - s0) / secs,
                          steps_per_second_without_saves=(
                              (int(out.step) - s0) / (secs - save_s))))
        return out

    def timed_inference(*a, **k):
        t0 = time.perf_counter()
        out = flavr_inference(*a, **k)
        infers.append(time.perf_counter() - t0)
        return out

    pipeline._train_sr_loop = timed_loop
    pipeline._flavr_inference = timed_inference
    TrainState.save = timed_save
    printed = io.StringIO()
    _zero_counts()
    secs = {}
    try:
        with contextlib.redirect_stdout(printed):
            for key, fn in (("stage1b", pipeline.stage1b_flavr),
                            ("stage1c", pipeline.stage1c_uncertainty)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, st = fn(cfg, dataset=dataset(), device=dev)
                torch.cuda.synchronize()
                secs[key] = time.perf_counter() - t0
                secs[key + "_steps"] = int(st.step)
            counts = _all_counts()
            files = _mtimes(root)
            n_loops, n_printed = len(loops), len(printed.getvalue())
            t0 = time.perf_counter()
            _, r1 = pipeline.stage1b_flavr(cfg, dataset=dataset(),
                                           device=dev)
            _, r2 = pipeline.stage1c_uncertainty(cfg, dataset=dataset(),
                                                 device=dev)
            secs["rerun"] = time.perf_counter() - t0
            rerun_files = _mtimes(root)
            rerun_printed = printed.getvalue()[n_printed:]
            # warm, the same 6-step loop (a save every 2) from stage 1b's
            # seeded weights through each loader in turns: sampler, host
            # loader (one background thread), host loader, sampler
            for i, kind in enumerate(("sampler", "host", "host",
                                      "sampler")):
                model = pipeline._make_flavr(cfg, False).to(dev)
                st = TrainState(model, *optim.onecycle_adam(model,
                                                            cfg.lr_sr, 6))
                loader = (DeviceSRPatchSampler(dataset(), SR_BATCH,
                                               device=dev)
                          if kind == "sampler" else
                          PrefetchLoader(BatchLoader(dataset(), SR_BATCH)))
                pipeline._train_sr_loop(
                    st, loader, make_sr_train_step(
                        model, enable_uncertainty=False,
                        slice_separation=4, num_slices=4,
                        precision="bf16"),
                    6, cfg.save_iters_sr, str(root / f"loop{i}"),
                    device=dev, lr_sim_sep=4.0, hr_aug=True)
                del model, st, loader
                torch.cuda.empty_cache()
    finally:
        pipeline._train_sr_loop = train_loop
        pipeline._flavr_inference = flavr_inference
        TrainState.save = save
    lines = printed.getvalue().splitlines()
    if (secs["stage1b_steps"], secs["stage1c_steps"]) != (6, 4) or (
            int(r1.step), int(r2.step)) != (6, 4):
        raise AssertionError(f"stage1: steps {secs}, rerun {r1.step}, "
                             f"{r2.step}")
    if len(loops) != n_loops + 4 or rerun_files != files or \
            "TRAINING" in rerun_printed:
        raise AssertionError(f"stage1: the rerun trained or wrote: loops "
                             f"{loops}, printed {rerun_printed}")
    if any(counts.values()):
        raise AssertionError(f"stage1: a hand kernel ran: {counts}")
    out_dir = root / "tmp" / "flavr_output"
    shapes = {}
    for f in sorted(os.listdir(out_dir)):
        a = nifti.read_image_itk(str(out_dir / f)).array
        if not np.isfinite(a).all():
            raise AssertionError(f"stage1: {f} is not finite")
        shapes[f] = list(a.shape)
    if len(shapes) != 6:
        raise AssertionError(f"stage1: SR outputs {sorted(shapes)}")
    log = [json.loads(ln) for ln in (root / "ckpt" / "flavr" /
                                      "metrics.jsonl").read_text()
           .splitlines()]
    psnr = {r["subject"]: r["psnr"] for r in log if "psnr" in r}
    losses = [r["loss"] for r in log if "loss" in r]
    if len(psnr) != 2 or not all(np.isfinite(v) for v in psnr.values()) \
            or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"stage1: psnr {psnr}, losses {losses}")
    warm = loops[n_loops:]
    loop_rates = {
        kind: dict(
            steps_per_second=[lp["steps_per_second"] for lp in warm
                              if lp["loader"] == name],
            steps_per_second_without_saves=[
                lp["steps_per_second_without_saves"] for lp in warm
                if lp["loader"] == name])
        for kind, name in (("sampler", "DeviceSRPatchSampler"),
                           ("host_loader", "PrefetchLoader"))}
    rec = dict(card=gpu, batch=SR_BATCH, patch_hr=patch,
               volume_lr_xyz=[*STAGE1_HR[:2], STAGE1_HR[2] // 4],
               subjects=2,
               sampler_bit_equal_batches=3, sampler_device_mb=sampler_mb,
               stage_seconds={k: v for k, v in secs.items()
                              if not k.endswith("_steps")},
               stage_loops=loops[:n_loops],
               warm_loop_order="sampler, host, host, sampler",
               warm_loops=loop_rates,
               inference_seconds_per_subject=dict(
                   stage1b=infers[0] / 2, stage1c=infers[1] / 2),
               psnr_db=psnr, logged_losses=losses, sr_nifti_shapes=shapes,
               printed=lines[-8:])
    emit({"phase": "stage1", **rec})
    return rec


# ------------------------------------------------------------ more than one
# card: one card does every half of these phases, so none of their times is
# a scaling number

def phase_mesh(params, dev, gpu):
    """Segmenter(mesh=) on the served LR parity path at bench geometry: a
    mesh naming cuda:0 twice (each forward's 8-way mirror batch split in
    two blocks of 4, each block's forward on its device) against the
    single-device Segmenter. bf16 ("cat", served): K1 launched tiles x
    data extent times, seconds a volume of each, labels equal on >= 99 %
    (cuDNN's bf16 convs round a batch of 4 and one of 8 differently: up to
    0.026 in a normalized logit); the largest normalized-logit difference
    and the labels outside near-ties printed.
    fp32 (TF32 off, fp32 K1): labels equal outside near-ties (normalized
    logit margin below 1e-3), which shows the meshed pass sums in the
    unmeshed order. make_mesh() over the visible card (data = 1):
    bit-equal to no mesh. Returns K1's bf16 launches in the meshed call."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.parallel.mesh import make_mesh
    from rehrseg_tpu_torch.serve import Segmenter

    vol = np.random.default_rng(SEED + 50).normal(size=VOLUME).astype(
        np.float32)
    card = torch.device("cuda", 0)
    twice = make_mesh(devices=[card, card])
    visible = make_mesh()
    n_tiles = len(sw.sliding_window_starts(VOLUME, PATCH))
    extent = twice.shape["data"]
    rec = {}

    def normalized(seg, mesh):
        vol_p, _ = seg._prep(vol)
        logits, weights = sw._run_sliding_window(
            seg._fn(False), vol_p, PATCH, 1, 0.5, True, True, 2,
            torch.bfloat16, device=dev, tta_mesh=mesh)
        return logits / weights[..., None]

    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        kw = dict(patch_size=PATCH, compute_dtype=dtype)
        segs = {"single": Segmenter.from_flax(params, DEFAULT_ARCH,
                                              device=dev, **kw),
                "mesh_2x_cuda0": Segmenter.from_flax(
                    params, DEFAULT_ARCH, mesh=twice, **kw)}
        if name == "bf16":
            segs["mesh_visible"] = Segmenter.from_flax(
                params, DEFAULT_ARCH, mesh=visible, **kw)
        out, r = {}, {}
        for key, seg in segs.items():
            seg.segment(vol)                 # warm-up, not counted
            torch.cuda.synchronize()
            _zero_counts()
            t = time.perf_counter()
            out[key] = seg.segment(vol)
            torch.cuda.synchronize()
            r[key] = dict(seconds_per_volume=time.perf_counter() - t,
                          k1=pconv_pad11_cat.launches,
                          replicas=len(seg._replicas))
        if r["mesh_2x_cuda0"]["k1"] != n_tiles * extent \
                or r["single"]["k1"] != n_tiles:
            raise AssertionError(f"mesh {name}: K1 launched {r} over "
                                 f"{n_tiles} tiles (data extent {extent})")
        want = normalized(segs["single"], None)
        got = normalized(segs["mesh_2x_cuda0"], twice)
        top2 = want.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1] >= 1e-3).cpu().numpy()
        lm, ls = out["mesh_2x_cuda0"], out["single"]
        if lm.shape != VOLUME or lm.dtype != np.uint8:
            raise AssertionError(f"mesh: labels {lm.shape} {lm.dtype}")
        r["labels"] = dict(
            equal=float(np.mean(lm == ls)),
            near_tie_share=float(1.0 - decided.mean()),
            differ_outside_near_ties=int(np.sum(lm[decided]
                                                != ls[decided])),
            max_normalized_logit_diff=float((got - want).abs().max()))
        del got, want, top2, segs
        torch.cuda.empty_cache()
        if name == "bf16":
            if visible.shape["data"] != torch.cuda.device_count():
                raise AssertionError(f"mesh: make_mesh() {visible}")
            if not np.array_equal(out["mesh_visible"], ls):
                raise AssertionError("mesh: make_mesh() labels differ from "
                                     "no mesh")
            launches = r["mesh_2x_cuda0"]["k1"]
        rec[name] = r
    if rec["bf16"]["labels"]["equal"] < 0.99 \
            or rec["fp32"]["labels"]["differ_outside_near_ties"]:
        raise AssertionError(f"mesh: labels against the single-device "
                             f"Segmenter's: {rec}")
    emit({"phase": "mesh", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "grid": "parity", "hr": False,
          "tiles": n_tiles, "data_extent": extent, **rec,
          "k1_launches_meshed": launches,
          "note": "both blocks run on the one card: not a scaling number"})
    return launches


def phase_native(gpu, work: Path):
    """The native host library (csrc/rehrseg_host.cpp through
    ``rehrseg_tpu_torch.native``): whether it built (the compiler's text
    when not), each entry point against its numpy / zlib form on seeded
    arrays, and the bench volume's .nii.gz read three times through
    ``native.gunzip`` and three times through ``gzip.decompress``, the
    seconds of each read and of each inflate alone."""
    import gzip

    from rehrseg_tpu_torch import native
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.ops.blur import parse_kernel
    from rehrseg_tpu_torch.ops.bspline import as_fraction, resize_matrix

    ok = native.available()
    rng = np.random.default_rng(SEED + 40)
    x = rng.normal(size=(6, 64, 40)).astype(np.float32)
    payload = rng.integers(0, 255, size=1 << 20, dtype=np.uint8).tobytes()
    kern = parse_kernel(None, "rf-pulse-slr", 3.873)
    mat = resize_matrix(64, as_fraction(4.0), 3)
    cases = {
        "gunzip": (lambda: native.gunzip(gzip.compress(payload)), 0.0),
        "gzip_compress": (lambda: gzip.decompress(
            native.gzip_compress(payload)), 0.0),
        "spline_filter_axis": (lambda: native.spline_filter_axis(x, 1),
                               2e-4),
        "blur_axis": (lambda: native.blur_axis(x, kern, 1), 1e-5),
        "resize_axis_matrix": (lambda: native.resize_axis_matrix(x, mat, 1),
                               1e-4),
        "zscore_inplace": (lambda: native.zscore_inplace(x.copy()), 1e-5),
    }
    got = {k: fn() for k, (fn, _) in cases.items()}
    lib, tried = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True          # the numpy / zlib path
    try:
        want = {k: fn() for k, (fn, _) in cases.items()}
    finally:
        native._LIB, native._TRIED = lib, tried
    errs = {}
    for k, (_, tol) in cases.items():
        if tol == 0.0:
            errs[k] = 0.0 if got[k] == want[k] == payload else None
        else:
            errs[k] = float(np.abs(got[k] - want[k]).max())
        if errs[k] is None or errs[k] > tol:
            raise AssertionError(f"native {k}: {errs[k]} over {tol}")
    vol = np.random.default_rng(SEED + 41).normal(size=VOLUME).astype(
        np.float32)
    path = work / "native_bench.nii.gz"
    t = time.perf_counter()
    nifti.write_image_itk(nifti.ItkLikeImage(vol, SPACING), str(path))
    write_s = time.perf_counter() - t
    raw = path.read_bytes()
    reads = {}
    for name, inflate in (("native", native.gunzip),
                          ("gzip_module", gzip.decompress)):
        real = native.gunzip
        native.gunzip = inflate
        try:
            secs, inflate_s = [], []
            for _ in range(3):
                t = time.perf_counter()
                arr = nifti.read_image_itk(str(path)).array
                secs.append(time.perf_counter() - t)
                t = time.perf_counter()
                inflate(raw)
                inflate_s.append(time.perf_counter() - t)
        finally:
            native.gunzip = real
        if not np.array_equal(arr, vol):
            raise AssertionError(f"native: the {name} read differs")
        reads[name] = dict(read_seconds=secs, inflate_seconds=inflate_s)
    emit({"phase": "native", "card": gpu, "available": ok,
          "build_error": native.build_error(),
          "library": str(native.library_path().name) if ok else None,
          "max_err_vs_numpy": errs, "volume": list(VOLUME),
          "gz_bytes": len(raw), "nii_bytes": vol.nbytes + 352,
          "write_seconds": write_s, "reads": reads,
          "note": "host-side: the CPUs of the card's machine"})


def phase_spatial(params, dev, gpu):
    """Segmenter(mesh=make_mesh(devices=[cuda:0, cuda:0], spatial=2)) at
    bench geometry against the single-device Segmenter, each tile's H in
    two blocks (parallel.spatial): the parity LR pass and the dual pass,
    bf16 ("cat") and fp32 (TF32 off). Gates: bf16 labels equal on >= 99 %;
    fp32 labels equal outside near-ties (normalized logit margin below
    1e-3), LR and HR; K1 launched tiles x 2 times a pass. Printed: the
    largest normalized-logit difference, seconds a volume of each, and the
    rows each block held at each conv of one forward. Then a (data 2,
    spatial 2) mesh of cuda:0 named four times on the bf16 LR pass, with
    the same label gate and K1 tiles x 4. Both blocks run on the one card:
    no scaling number. Returns K1's launches in the bf16 spatial LR
    pass."""
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.parallel import spatial as sp
    from rehrseg_tpu_torch.parallel.mesh import make_mesh
    from rehrseg_tpu_torch.serve import Segmenter

    vol = np.random.default_rng(SEED + 60).normal(size=VOLUME).astype(
        np.float32)
    card = torch.device("cuda", 0)
    mesh = make_mesh(devices=[card, card], spatial=2)
    n_tiles = len(sw.sliding_window_starts(VOLUME, PATCH))
    d, h, w = VOLUME
    rec, launches = {}, None

    def ones(b):
        o = torch.ones(*b.shape[:-1], 1, device=dev)
        return o, o.repeat_interleave(4, 1)

    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        kw = dict(patch_size=PATCH, compute_dtype=dtype)
        segs = {"single": Segmenter.from_flax(params, DEFAULT_ARCH,
                                              device=dev, **kw),
                "spatial2": Segmenter.from_flax(params, DEFAULT_ARCH,
                                                mesh=mesh, **kw)}
        out, r = {}, {}
        for key, seg in segs.items():
            if name == "bf16":
                seg.segment(vol)             # warm-up, not counted
            for hr in (False, True):
                torch.cuda.synchronize()
                _zero_counts()
                sp.reset_record()
                t = time.perf_counter()
                out[key, hr] = seg.segment(vol, hr=hr)
                torch.cuda.synchronize()
                r[f"{key}_{'dual' if hr else 'lr'}"] = dict(
                    seconds_per_volume=time.perf_counter() - t,
                    k1=pconv_pad11_cat.launches)
                if key == "spatial2" and not hr:
                    per = len(sp.RECORD) // n_tiles
                    r["block_rows"] = sp.RECORD[:per]
        for key in ("lr", "dual"):
            if r[f"spatial2_{key}"]["k1"] != n_tiles * 2 \
                    or r[f"single_{key}"]["k1"] != n_tiles:
                raise AssertionError(f"spatial {name} {key}: K1 launched "
                                     f"{r} over {n_tiles} tiles")
        if not all(len(rows) == 2 for _, rows in r["block_rows"]):
            raise AssertionError(f"spatial: a level ran gathered at the "
                                 f"bench tile: {r['block_rows']}")
        # the margin reference: the dual pass's normalized logits (its LR
        # head is the LR pass's forward)
        vol_p, _ = segs["single"]._prep(vol)
        dargs = (vol_p, PATCH, 4, 0.5, True, True)
        wlr, whr = sw._dual_logits(ones, *dargs, 1, torch.bfloat16, dev)
        refs = {}
        for key, mesh_ in (("single", None), ("spatial2", mesh)):
            llr, lhr = sw._dual_logits(segs[key]._fn(True), *dargs, 2,
                                       torch.bfloat16, dev, tta_mesh=mesh_)
            refs[key, "lr"] = refs[key, "dual_lr"] = (llr, wlr)
            refs[key, "dual_hr"] = (lhr, whr)
        labels = {}
        for key, shape, got, want in (
                ("lr", VOLUME, out["spatial2", False],
                 out["single", False]),
                ("dual_lr", VOLUME, out["spatial2", True][0],
                 out["single", True][0]),
                ("dual_hr", (4 * d, h, w), out["spatial2", True][1],
                 out["single", True][1])):
            if got.shape != shape or got.dtype != np.uint8 or got.max() > 1:
                raise AssertionError(f"spatial {name} {key}: {got.shape} "
                                     f"{got.dtype}")
            lg, wt = refs["single", key]
            decided = _decided(lg, wt)
            diff = float((refs["spatial2", key][0] / wt - lg / wt).abs()
                         .max())
            labels[key] = dict(
                equal=float(np.mean(got == want)),
                near_tie_share=float(1.0 - decided.mean()),
                differ_outside_near_ties=int(np.sum(got[decided]
                                                    != want[decided])),
                max_normalized_logit_diff=diff)
        r["labels"] = labels
        del refs, segs, wlr, whr
        torch.cuda.empty_cache()
        if name == "bf16":
            launches = r["spatial2_lr"]["k1"]
            bad = {k: v["equal"] for k, v in labels.items()
                   if v["equal"] < 0.99}
        else:
            bad = {k: v["differ_outside_near_ties"]
                   for k, v in labels.items() if v["differ_outside_near_ties"]}
        if bad:
            raise AssertionError(f"spatial {name}: labels against the "
                                 f"single-device Segmenter's: {labels}")
        rec[name] = r
    # a (data 2, spatial 2) mesh: two mirror blocks of 4, each H-split
    mesh4 = make_mesh(devices=[card] * 4, spatial=2)
    kw = dict(patch_size=PATCH, compute_dtype=torch.bfloat16)
    seg = Segmenter.from_flax(params, DEFAULT_ARCH, mesh=mesh4, **kw)
    single = Segmenter.from_flax(params, DEFAULT_ARCH, device=dev, **kw)
    want = single.segment(vol)
    seg.segment(vol)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    got = seg.segment(vol)
    torch.cuda.synchronize()
    r4 = dict(seconds_per_volume=time.perf_counter() - t,
              k1=pconv_pad11_cat.launches,
              equal=float(np.mean(got == want)))
    if r4["k1"] != n_tiles * 4 or r4["equal"] < 0.99:
        raise AssertionError(f"spatial data 2 x spatial 2: {r4}")
    rec["data2_spatial2_bf16_lr"] = r4
    del seg, single
    torch.cuda.empty_cache()
    emit({"phase": "spatial", "card": gpu, "volume": list(VOLUME),
          "patch": list(PATCH), "grid": "parity", "spatial": 2,
          "tiles": n_tiles, **rec, "k1_launches_spatial": launches,
          "note": "every block runs on the one card: no scaling number"})
    return launches


def phase_spatial_train(params, dev, gpu, work: Path):
    """The stage-2 step at full width (DEFAULT_ARCH, B = 2 x (16, 256,
    320), uncertainty, remat "hires") on a spatial group of cuda:0 named
    twice against the unsharded step: fp32 (TF32 off) losses within 1e-6
    relative; every gradient leaf under the train_step phase's gate, held
    to the unpacked fp64 step within 2e-3 or twice the unsharded fp32
    step's own error where that is larger (the deep stages' gradients are
    ill-conditioned: another summation order moves them by up to about
    5e-3); the sharded bf16 step against the sharded fp32 one within 5e-2;
    ms a bf16
    step both ways over a chain and the peak memory (both blocks on the
    one card: the peak is not a per-card number). Then 3 steps of
    pipeline.stage2_segsr with extra.mesh_spatial 2 (spatial_devices= the
    card twice) on the train_loop phantom with one validation."""
    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.parallel import multihost as mh
    from rehrseg_tpu_torch.parallel import spatial as sp
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import make_seg_train_step
    from rehrseg_tpu_torch.train.state import TrainState

    card = torch.device("cuda", 0)
    pair = [card, card]
    batch = _train_batch(dev, SEED + 70)
    tol, tol_bf16 = 2e-3, 5e-2
    l_u, g_u = _one_step(params, batch, dev, remat="hires")
    sp.reset_record()
    l_s, g_s = _one_step(params, batch, dev, remat="hires",
                         spatial_devices=pair)
    n_convs = len(sp.RECORD)
    sharded = sum(len(r) == 2 for _, r in sp.RECORD)
    l_b, g_b = _one_step(params, batch, dev, remat="hires",
                         precision="bf16", spatial_devices=pair)
    _, g_r = _one_step(params, batch, dev, torch.float64, packed=False)

    def flat(g):
        return torch.cat([v.ravel() for v in g.values()])

    floor = 1e-3 * float(flat(g_r).norm())
    # (sharded vs fp64, unsharded vs fp64, sharded vs unsharded) a leaf
    leaves = {k: (_rel(g_s[k], g_r[k], floor), _rel(g_u[k], g_r[k], floor),
                  _rel(g_s[k], g_u[k], floor)) for k in g_r}
    over = {k: v for k, v in leaves.items() if v[0] > max(tol, 2 * v[1])}
    worst = max(leaves, key=lambda k: leaves[k][2])
    loss_err = max(abs(l_s[k] - l_u[k]) / abs(l_u[k]) for k in l_u)
    bf16_loss_err = max(abs(l_b[k] - l_s[k]) / abs(l_s[k]) for k in l_s)
    bf16_grad_err = _rel(flat(g_b), flat(g_s))
    if loss_err > 1e-6 or over or bf16_loss_err > tol_bf16 \
            or bf16_grad_err > tol_bf16 or sharded == 0:
        raise AssertionError(f"spatial_train: loss {loss_err}, leaves over "
                             f"(sharded, unsharded vs fp64): {over}, bf16 "
                             f"{bf16_loss_err} / {bf16_grad_err}, "
                             f"{sharded} of {n_convs} convs sharded")
    timing = {}
    for key, group in (("single", None), ("spatial2", pair)):
        seg = SegModel(2, 4, arch=DEFAULT_ARCH)
        convert.load_flax_params(seg, params)
        seg.to(dev)
        state = TrainState(seg, optim.nesterov_sgd(seg),
                           optim.poly_epoch_schedule(1e-2, 100, 1))
        step = make_seg_train_step(seg, enable_uncertainty=True,
                                   enable_distillation=False, remat="hires",
                                   precision="bf16", spatial_devices=group)
        b = batch if group is None else mh.place_global(batch, group)
        ms, peak, losses = _time_chain(step, state, b)
        timing[key] = dict(ms_per_step=ms, peak_mem_gb=peak, losses=losses)
        del seg, state, step
        torch.cuda.empty_cache()
    # three steps of the loop, one validation at step 3
    root = work / "spatial_loop"
    _, _, config, ds = _loop_tree(root)
    printed = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sp.reset_record()
    with contextlib.redirect_stdout(printed):
        _, state, best = pipeline.stage2_segsr(
            config(3, mesh_spatial=2), dataset=ds, device=dev,
            spatial_devices=pair)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    lines = printed.getvalue().strip().splitlines()
    evals = [ln for ln in lines if ln.startswith("Eval result")]
    if state.step != 3 or len(evals) != 1 or not 0.0 <= best <= 1.0 \
            or not any(len(r) == 2 for _, r in sp.RECORD):
        raise AssertionError(f"spatial_train loop: step {state.step}, "
                             f"{evals}, best {best}")
    emit({"phase": "spatial_train", "card": gpu, "batch": TRAIN_BATCH,
          "patch": list(TRAIN_PATCH), "spatial": 2, "remat": "hires",
          "fp32_vs_unsharded": dict(
              loss_rel_err=loss_err, tolerance=tol,
              whole_grad_rel_norm=_rel(flat(g_s), flat(g_u)),
              worst_leaf=dict(name=worst, vs_unsharded=leaves[worst][2],
                              vs_fp64=leaves[worst][0],
                              unsharded_vs_fp64=leaves[worst][1]),
              leaf_vs_fp64_max=max(v[0] for v in leaves.values()),
              leaf_rule="sharded fp32 vs unpacked fp64 <= max(2e-3, 2x "
                        "unsharded fp32 vs unpacked fp64)",
              losses=l_s, losses_unsharded=l_u),
          "bf16_vs_fp32": dict(loss_rel_err=bf16_loss_err,
                               grad_rel_norm=bf16_grad_err,
                               tolerance=tol_bf16),
          "convs_sharded": sharded, "convs": n_convs,
          "bf16_chain": timing, "loop": dict(
              steps=3, seconds=loop_s, validation=evals, best_dice=best,
              remat=[ln for ln in lines if ln.startswith("remat")]),
          "note": "both blocks run on the one card: neither a scaling "
                  "number nor a per-card memory"})


DP_SR_BATCH = 32      # the UASR step's global batch (configs/brain.yaml)


def _digest(module) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _host_grads(module):
    return {k: p.grad.detach().double().cpu()
            for k, p in module.named_parameters() if p.grad is not None}


def _grad_err(got, want):
    """(whole-gradient relative norm error, worst leaf's, with a leaf's
    norm taken at least as 1e-3 of the whole gradient's)."""
    keys = sorted(want)
    if sorted(got) != keys:
        raise AssertionError(f"gradient keys differ: {sorted(got)[:3]}")
    num = sum(float((got[k] - want[k]).norm() ** 2) for k in keys) ** 0.5
    den = sum(float(want[k].norm() ** 2) for k in keys) ** 0.5
    floor = 1e-3 * den
    leaf = max(_rel(got[k], want[k], floor) for k in keys)
    return num / max(den, 1e-30), leaf


def _dp_models(dev):
    """The dp phase's two models and their global batches, seeded alike in
    every process: the stage-1 UASR UNet3D at configs/brain.yaml's width
    (batch 32 of (4, 96, 96), labels on) and the full-width SegModel
    (B = 2 of TRAIN_PATCH), both fp32, each with its train step."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import make_seg_train_step
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step
    from rehrseg_tpu_torch.train.state import TrainState

    name, factory, lr_shape, hr_shape, _, ns = _sr_models()[2]
    uasr, sr_state = _sr_state(name, factory, _sr_params(name), dev)
    sr_step = make_sr_train_step(uasr, enable_uncertainty=True,
                                 slice_separation=4, num_slices=ns)
    sr_batch = _sr_batch((DP_SR_BATCH, *lr_shape[1:]),
                         (DP_SR_BATCH, *hr_shape[1:]), dev, SEED + 60)
    seg = SegModel(2, 4, arch=DEFAULT_ARCH)
    convert.load_flax_params(seg, convert.random_flax_params(DEFAULT_ARCH,
                                                             SEED + 61))
    seg.to(dev)
    seg_state = TrainState(seg, optim.nesterov_sgd(seg),
                           optim.poly_epoch_schedule(1e-2, 100, 1))
    seg_step = make_seg_train_step(seg, enable_uncertainty=True,
                                   enable_distillation=False, remat=True)
    return dict(uasr=(uasr, sr_state, sr_step, sr_batch),
                seg=(seg, seg_state, seg_step, _train_batch(dev, SEED + 62)))


def _dp_step(kind, entry, rows=slice(None)):
    """One step of ``kind`` on ``rows`` of its global batch; (seconds,
    loss)."""
    from rehrseg_tpu_torch.train.seg_trainer import SegBatch

    _, state, step, batch = entry
    part = [t[rows] for t in batch]
    torch.cuda.synchronize()
    t = time.perf_counter()
    if kind == "seg":
        _, m = step(state, SegBatch(*part))
    else:
        _, m = step(state, *part)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    return time.perf_counter() - t, loss


def dp_rank_main(argv) -> int:
    """One rank of the dp phase: ``chip_smoke.py --dp-rank RANK WORLD PORT
    OUT``. A gloo group over 127.0.0.1:PORT on cuda:0 (NCCL refuses two
    ranks on one card); each model's step on this rank's rows of the
    global batch; rank 0 saves the all-reduced gradients, every rank its
    weights' digest and a metrics line (written by the primary only)."""
    from rehrseg_tpu_torch.parallel import distributed
    from rehrseg_tpu_torch.parallel import multihost as mh
    from rehrseg_tpu_torch.utils.metrics import MetricsLogger

    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], \
        Path(argv[3])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if not distributed.init_distributed(f"127.0.0.1:{port}", world, rank,
                                        backend="gloo", timeout_s=600.0):
        raise RuntimeError("dp rank: no process group formed")
    res = {}
    for kind, entry in _dp_models(dev).items():
        n = entry[3][0].shape[0] // world
        secs, loss = _dp_step(kind, entry, slice(rank * n, (rank + 1) * n))
        res[kind] = dict(seconds=secs, loss=loss, rows=n,
                         digest=_digest(entry[0]))
        if rank == 0:
            torch.save(_host_grads(entry[0]), out / f"{kind}_grads.pt")
        MetricsLogger(str(out)).log(1, kind=kind, rank=rank, loss=loss)
    mh.barrier("dp-done")
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def phase_dp(dev, gpu, work: Path):
    """Data parallelism on the one card. (i) Two ranks spawned over gloo on
    cuda:0 (the port only): a UASR stage-1 step (global batch 32, 16 a
    rank, label channels on, so the dice couples the ranks) and a stage-2
    packed step (B = 2 x TRAIN_PATCH, one a rank), fp32, TF32 off: weights
    bit-equal across ranks, the all-reduced gradients within 2e-3
    (relative, whole gradient) of the 1-process step on the global batch
    on the same card, the logged loss the global batch's, one metrics
    line a step. (ii) A one-rank NCCL group runs the same stage-2 step on
    the global batch through the same code: the NCCL path initializes and
    reduces on the card. No scaling number: both ranks share the card."""
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    root = work / "dp"
    root.mkdir()
    # the 1-process references on the global batch
    ref = {}
    for kind, entry in _dp_models(dev).items():
        secs, loss = _dp_step(kind, entry)
        ref[kind] = dict(seconds=secs, loss=loss,
                         grads=_host_grads(entry[0]))
    torch.cuda.empty_cache()
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(root / f"rank{r}.log", "w") for r in range(2)]
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(r),
         "2", port, str(root)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t
    if any(p.returncode for p in procs):
        tails = [(root / f"rank{r}.log").read_text()[-3000:]
                 for r in range(2)]
        raise AssertionError(f"dp: a rank failed: {tails}")
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(2)]
    rec = {}
    for kind in ("uasr", "seg"):
        a, b = ranks[0][kind], ranks[1][kind]
        if a["digest"] != b["digest"]:
            raise AssertionError(f"dp {kind}: weights differ across ranks")
        err, leaf = _grad_err(torch.load(root / f"{kind}_grads.pt"),
                              ref[kind]["grads"])
        loss_err = abs(a["loss"] - ref[kind]["loss"]) / abs(ref[kind]["loss"])
        if err > 2e-3 or loss_err > 2e-3 or a["loss"] != b["loss"]:
            raise AssertionError(f"dp {kind}: gradient {err}, loss {a['loss']}"
                                 f" / {b['loss']} vs {ref[kind]['loss']}")
        rec[kind] = dict(rows_per_rank=a["rows"],
                         rank_step_seconds=[a["seconds"], b["seconds"]],
                         one_process_step_seconds=ref[kind]["seconds"],
                         loss=a["loss"], one_process_loss=ref[kind]["loss"],
                         grad_rel_err=err, worst_leaf_rel_err=leaf)
    lines = (root / "metrics.jsonl").read_text().splitlines()
    if len(lines) != 2 or any(json.loads(ln)["rank"] != 0 for ln in lines):
        raise AssertionError(f"dp: metrics lines {lines}")
    # (ii) a one-rank NCCL group through the same code
    entry = _dp_models(dev)["seg"]
    t0 = time.perf_counter()
    # init_distributed forms no group for one process: form it here
    torch.cuda.set_device(dev.index or 0)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        init_s = time.perf_counter() - t0
        backend = torch.distributed.get_backend()
        secs, loss = _dp_step("seg", entry)
        err, leaf = _grad_err(_host_grads(entry[0]), ref["seg"]["grads"])
    finally:
        torch.distributed.destroy_process_group()
    if backend != "nccl" or err > 2e-3:
        raise AssertionError(f"dp nccl: backend {backend}, gradient {err}")
    rec["nccl_one_rank"] = dict(init_seconds=init_s, step_seconds=secs,
                                loss=loss, grad_rel_err=err,
                                worst_leaf_rel_err=leaf)
    del entry
    torch.cuda.empty_cache()
    emit({"phase": "dp", "card": gpu, "ranks": 2, "backend": "gloo",
          "spawn_to_exit_seconds": wall, **rec,
          "note": "two ranks on one card over gloo; NCCL across two cards "
                  "and any scaling are not measured here"})
    return rec


def phase_fold_all(dev, gpu, work: Path):
    """``pipeline.stage2_segsr_all_folds`` with 2 folds over
    devices=[cuda:0, cuda:0] on the train_loop phase's phantom subjects
    (``dataset=``), bf16, distillation, 3 steps with one save and one
    validation at the end: both folds' checkpoints at step 3, finite and
    distinct fold losses, fp32 K1 launched once per validation tile of
    each fold and no other kernel; then fold k's state after one
    fold-parallel step of the full-width SegModel (fp32, cuDNN
    deterministic) equal bit for bit to one plain step of fold k on the
    same batch. Returns the fp32 K1 launches."""
    import copy

    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.config import Config
    from rehrseg_tpu_torch.data.datasets import SegSRDataset
    from rehrseg_tpu_torch.infer import sliding_window as sw
    from rehrseg_tpu_torch.io import nifti
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
    from rehrseg_tpu_torch.parallel import fold_parallel as fp
    from rehrseg_tpu_torch.train import checkpoint as ckpt

    root = work / "fold_all"
    patch_zyx = list(TRAIN_PATCH)
    patch_ori = [patch_zyx[2] + 64, patch_zyx[1] + 64, patch_zyx[0]]
    val_zyx = tuple(patch_ori[::-1])
    rng = np.random.default_rng(SEED + 70)
    for d in ("imagesTr", "labelsTr"):
        (root / d).mkdir(parents=True)
    img, lab = _phantom(rng, val_zyx[::-1])
    nifti.write_image_itk(nifti.ItkLikeImage(img.transpose(2, 1, 0),
                                             SPACING),
                          str(root / "imagesTr" / "v0_0000.nii.gz"))
    nifti.write_image_itk(nifti.ItkLikeImage(
        lab.transpose(2, 1, 0).astype(np.uint8), SPACING),
        str(root / "labelsTr" / "v0.nii.gz"))
    seg_path = root / "nnUNet_results" / "DS" / "trainer"
    seg_path.mkdir(parents=True)
    (root / "nnUNet_preprocessed" / "DS").mkdir(parents=True)
    (root / "nnUNet_preprocessed" / "DS" / "splits_final.json").write_text(
        json.dumps([{"train": ["t0", "t1"], "val": ["v0"]},
                    {"train": ["t1", "t0"], "val": ["v0"]}]))
    hr_shape = (patch_ori[0] + 16, patch_ori[1] + 16, 4 * patch_zyx[0] + 8)
    vols = []
    for _ in range(2):
        im, lb = _phantom(rng, hr_shape)
        vols.append((im, lb, rng.uniform(0, 255, size=hr_shape).astype(
            np.float32)))
    ds = SegSRDataset.from_volumes(vols, 4.0, 1.0, patch_ori,
                                   patch_zyx[::-1], random_flip=True,
                                   uncertainty=True, device_augment=True)
    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in DEFAULT_ARCH.items()}
    cfg = Config(data_path=str(root / "imagesTr"),
                 tmp_path=str(root / "tmp"),
                 checkpoint_path=str(root / "ckpt"), seg_path=str(seg_path),
                 fold="all", epochs=3, batch_size_segsr=2,
                 save_iters_segsr=3,
                 extra={"arch_override": arch, "patch_size_zyx": patch_zyx})
    card = torch.device("cuda", 0)
    printed = io.StringIO()
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        segs, states, best = pipeline.stage2_segsr_all_folds(
            cfg, dataset=ds, devices=[card, card])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = pconv_pad11_cat.launches
    counts = _fused_counts()
    n_tiles = len(sw.sliding_window_starts(val_zyx, val_zyx))
    log = [json.loads(line) for line in
           (root / "ckpt" / "segsr_folds" / "metrics.jsonl").read_text()
           .splitlines()]
    losses = [r[f"loss_fold{k}"] for r in log for k in range(2)
              if f"loss_fold{k}" in r]
    steps = [ckpt.latest_step(str(root / "ckpt" / f"segsr_fold{k}"))
             for k in range(2)]
    if steps != [3, 3] or [s.step for s in states] != [3, 3]:
        raise AssertionError(f"fold_all: checkpoints at {steps}")
    if len(losses) != 2 or not all(np.isfinite(losses)) \
            or losses[0] == losses[1]:
        raise AssertionError(f"fold_all: fold losses {losses}")
    if launches != 2 * n_tiles:
        raise AssertionError(f"fold_all: fp32 K1 launched {launches} times "
                             f"for 2 folds x {n_tiles} tiles")
    if any(v for k, v in counts.items() if k != "pconv_pad11_cat"):
        raise AssertionError(f"fold_all: other kernels ran: {counts}")
    del segs, states
    torch.cuda.empty_cache()

    # one fold-parallel step against one plain step per fold
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import SegModel
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import make_seg_train_step
    from rehrseg_tpu_torch.train.state import TrainState

    def fold(k):
        seg = SegModel(2, 4, arch=DEFAULT_ARCH)
        convert.load_flax_params(seg, convert.random_flax_params(
            DEFAULT_ARCH, SEED + 71 + k))
        seg.to(card)
        state = TrainState(seg, optim.nesterov_sgd(seg),
                           optim.poly_epoch_schedule(1e-2, 100, 1))
        return seg, state, make_seg_train_step(
            seg, enable_uncertainty=True, enable_distillation=False,
            remat=True)

    batches = [(_train_batch(card, SEED + 73 + k),) for k in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        folds = [fold(k) for k in range(2)]
        plain = [(copy.deepcopy(f[0]),) for f in folds]
        mesh = fp.make_fold_mesh(2, devices=[card, card])
        step = fp.make_fold_parallel_step([f[2] for f in folds], mesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step([f[1] for f in folds], batches)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        equal = []
        for k, (seg,) in enumerate(plain):
            state = TrainState(seg, optim.nesterov_sgd(seg),
                               optim.poly_epoch_schedule(1e-2, 100, 1))
            make_seg_train_step(seg, enable_uncertainty=True,
                                enable_distillation=False,
                                remat=True)(state, *batches[k])
            want = seg.state_dict()
            equal.append(all(torch.equal(v, want[n]) for n, v in
                             folds[k][0].state_dict().items()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not all(equal):
        raise AssertionError(f"fold_all: fold-parallel step differs from "
                             f"the plain step: {equal}")
    del folds, plain
    torch.cuda.empty_cache()
    emit({"phase": "fold_all", "card": gpu, "folds": 2,
          "devices": ["cuda:0", "cuda:0"], "steps": 3, "batch": 2,
          "patch": patch_zyx, "seconds": secs, "fold_losses": losses,
          "best_dice": best, "checkpoint_steps": steps,
          "k1_fp32_launches": launches, "val_tiles_per_fold": n_tiles,
          "fold_step_fp32_seconds": step_s,
          "fold_step_equals_plain_step": equal,
          "printed": printed.getvalue().strip().splitlines()[-6:],
          "note": "both folds on one card: not a scaling number"})
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
    # (and any wgmma serialization ptxas reports)
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "Used" in ln or "spill" in ln or "Performance" in ln]
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
    tile_fused = phase_tile_fused(params, dev)
    torch.cuda.empty_cache()
    launches_fused = phase_main_fused(params, dev, gpu)
    torch.cuda.empty_cache()
    launches_streamed = phase_streamed(params, dev, gpu)
    phase_sr(dev, gpu)
    (here / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=here / "build") as work:
        launches_cli, t_start = phase_cli(params, dev, gpu, Path(work), here)
        torch.cuda.empty_cache()
        phase_cli_sr(dev, gpu, Path(work), here, t_start)
        launches_eval, k1_fp32 = phase_evaluate(params, dev, gpu, Path(work),
                                                gen)
        torch.cuda.empty_cache()
        fp32 = phase_fp32_forms(gen, dev)
        torch.cuda.empty_cache()
        phase_train_step(params, dev, gpu)
        torch.cuda.empty_cache()
        launches_train = phase_train_loop(dev, gpu, Path(work))
        torch.cuda.empty_cache()
        phase_sr_train_step(dev, gpu)
        torch.cuda.empty_cache()
        phase_stage1(dev, gpu, Path(work))
        torch.cuda.empty_cache()
        launches_mesh = phase_mesh(params, dev, gpu)
        phase_dp(dev, gpu, Path(work))
        launches_folds = phase_fold_all(dev, gpu, Path(work))
        phase_native(gpu, Path(work))
        torch.cuda.empty_cache()
        launches_spatial = phase_spatial(params, dev, gpu)
        torch.cuda.empty_cache()
        phase_spatial_train(params, dev, gpu, Path(work))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the fp32 VALID forms' launches on their path: the fp32 full-width
    # tiles through pallas_conv=True (both arches)
    tiles_fp32 = [tile_pallas[a]["launches"]
                  for a in ("default_arch", "stage0_3conv")]
    emit({"kernels": [
        dict(name="pconv_pad11_cat", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:889",
             launches=launches["pconv_pad11_cat"],
             launches_cli=launches_cli, launches_streamed=launches_streamed,
             launches_mesh=launches_mesh,
             launches_spatial=launches_spatial,
             **{k: k1[k] for k in keys}),
        # fp32 K1: fold evaluation's path (trainer weights are fp32); its
        # bound at the 3xTF32 rate
        dict(name="pconv_pad11_cat (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:889",
             launches=launches_eval, launches_in="evaluate",
             launches_train=launches_train, launches_fold_all=launches_folds,
             **{k: k1_fp32[k] for k in keys}),
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
        # the fp32 VALID forms and the fp32 K6 forms (an exact high
        # product), each with its own record, bound at the 3xTF32 rate;
        # launches on the fp32 full-width tiles
        dict(name="pconv_valid (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:519",
             launches=sum(c.get("pconv_valid", 0) for c in tiles_fp32),
             launches_in="tile_pallas (both arches)",
             **{k: fp32["k3"][k] for k in keys}),
        dict(name="pconv3_valid (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv3_valid_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:1117",
             launches=sum(c.get("pconv3_valid", 0) for c in tiles_fp32),
             launches_in="tile_pallas (both arches)",
             **{k: fp32["k5"][k] for k in keys}),
        dict(name="pconv_pad11_cat(want_stats=True) (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv_pad11_cat_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:641",
             launches=tile_fused["launches"]["pconv_pad11_cat_stats"],
             launches_in="tile_fused",
             **{k: fp32["k6a"][k] for k in keys}),
        dict(name="pconv_valid(pre=, want_stats=True) (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv2d_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:148",
             launches=tile_fused["launches"]["pconv_valid_fused"],
             launches_in="tile_fused",
             **{k: fp32["k6b"][k] for k in keys}),
        dict(name="pconv3_valid(pre=, want_stats=True) (fp32)", route="cuda",
             source="rehrseg_tpu_torch/csrc/pconv3_valid_sm90.cu",
             replaces="rehrseg_tpu/ops/pallas_pconv.py:930",
             launches=tile_fused["launches"]["pconv3_valid_fused"],
             launches_in="tile_fused",
             **{k: fp32["k6c"][k] for k in keys}),
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
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    sys.exit(main())
