"""The port's stage-1 data path against the JAX package's on the same
inputs, on the CPU: the SLR pulse design (1e-12), the slice-profile
kernels, the separable blurs and the n-d B-spline resize; the
normalizations; ``SRPatchDataset`` samples bit-equal at one seed across
channels 1 and 2, WDSR and FLAVR patches, the host transforms,
``device_lr_sim`` and ``.h5`` sources (and ``from_volumes`` equal to the
constructor); ``simulate_lr_batch``'s resize (1e-5) and its dropout at
given draws; ``DeviceSRPatchSampler``'s decision rows equal to JAX's, its
batches equal to the host loader's, its ``shard=`` slices."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.data import datasets as jds
from rehrseg_tpu.data import device_sampler as jsampler
from rehrseg_tpu.data import device_sr_sim as jsim
from rehrseg_tpu.data import normalize as jnorm
from rehrseg_tpu.io import volume as jvolume
from rehrseg_tpu.ops import blur as jblur
from rehrseg_tpu.ops import bspline as jbspline
from rehrseg_tpu.ops import slr as jslr
from rehrseg_tpu_torch.data import device_sr_sim as tsim
from rehrseg_tpu_torch.data import normalize as tnorm
from rehrseg_tpu_torch.data.datasets import BatchLoader, SRPatchDataset
from rehrseg_tpu_torch.data.device_sampler import DeviceSRPatchSampler
from rehrseg_tpu_torch.ops import blur as tblur
from rehrseg_tpu_torch.ops import bspline as tbspline
from rehrseg_tpu_torch.ops import slr as tslr
from tests.test_data import _make_subject_nifti

torch.set_num_threads(2)


def test_slr_matches_jax():
    for n in (64, 65):
        np.testing.assert_allclose(tslr.dzls(n, 4.0, 0.01, 0.01),
                                   jslr.dzls(n, 4.0, 0.01, 0.01),
                                   rtol=1e-12, atol=1e-12)
    rf_t, rf_j = tslr.dzrf_ex(64), jslr.dzrf_ex(64)
    np.testing.assert_allclose(rf_t, rf_j, rtol=1e-12, atol=1e-12)
    (xt, pt), (xj, pj) = tslr.slice_profile(64), jslr.slice_profile(64)
    np.testing.assert_allclose(xt, xj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt, pj, rtol=1e-12, atol=1e-12)
    assert tslr.measure_fwhm(xt, pt) == pytest.approx(
        jslr.measure_fwhm(xj, pj), rel=1e-12)
    assert tslr.dinf(0.01, 0.02) == jslr.dinf(0.01, 0.02)


@pytest.mark.parametrize("kind", ["rf-pulse-slr", "gaussian"])
def test_kernels_and_blurs_match_jax(kind):
    for fwhm in (3.87, 2.2):
        np.testing.assert_allclose(tblur.select_kernel(9, kind, fwhm),
                                   jblur.select_kernel(9, kind, fwhm),
                                   rtol=1e-12, atol=1e-12)
        k_t = tblur.parse_kernel(None, kind, fwhm)
        np.testing.assert_array_equal(k_t, jblur.parse_kernel(None, kind,
                                                              fwhm))
    assert tblur.calc_extended_patch_size(k_t, [16, 16, 1]) == \
        jblur.calc_extended_patch_size(k_t, [16, 16, 1])
    with pytest.raises(ValueError, match="Unknown"):
        tblur.select_kernel(5, "box", 2.0)
    x = np.random.default_rng(0).normal(size=(3, 1, 11, 7)).astype(
        np.float32)
    for k in (k_t, k_t[:-1]):                # odd and even lengths
        for axis in (2, 3, -1):
            want = np.asarray(jblur.blur_axis(jnp.asarray(x), k, axis))
            np.testing.assert_allclose(
                tblur.blur_axis(torch.from_numpy(x), k, axis).numpy(), want,
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tblur.blur_axis_np(x, k, axis),
                                       jblur.blur_axis_np(x, k, axis),
                                       rtol=1e-6, atol=1e-7)


def test_resize_nd_and_normalizations_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 9)).astype(np.float32)
    for dxyz, order in (((4.0, 1.0), 3), ((2.5, 0.5), 3), ((4.0,), 0)):
        np.testing.assert_allclose(tbspline.resize_nd_np(x, dxyz, order),
                                   jbspline.resize_nd_np(x, dxyz, order),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tbspline.resize_nd(torch.from_numpy(x), dxyz, order).numpy(),
            np.asarray(jbspline.resize_nd_jax(jnp.asarray(x), dxyz, order)),
            rtol=1e-5, atol=1e-5)
    v = rng.normal(size=(6, 7, 5)) * 3 + 1
    for f in ("zscore_normalization", "zeroone_normalization",
              "percentile_normalization"):
        np.testing.assert_array_equal(getattr(tnorm, f)(v),
                                      getattr(jnorm, f)(v))
    np.testing.assert_array_equal(
        tnorm.percentile_normalization(v, 2, 98, False),
        jnorm.percentile_normalization(v, 2, 98, False))


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    """Two merged NIfTI subjects (the second smaller than a FLAVR patch
    along x and z) and their stage-1a HDF5 stores."""
    root = tmp_path_factory.mktemp("sr_data")
    nii, h5 = root / "nii", root / "h5"
    nii.mkdir()
    h5.mkdir()
    rng = np.random.default_rng(0)
    _make_subject_nifti(str(nii / "sub1_0000.nii.gz"), rng)
    _make_subject_nifti(str(nii / "sub2_0000.nii.gz"), rng, shape=(7, 32, 8))
    for s in ("sub1", "sub2"):
        ds = jds.SRPatchDataset(str(nii), [s], 4.0, 1.0, None,
                                "rf-pulse-slr", (16, 16), True)
        jvolume.write_h5(str(h5 / f"{s}_0000.nii.gz.h5"),
                         img_hr=ds.imgs_hr[0], label_hr=ds.labels_hr[0],
                         image_x_rgb=ds.filtered_x[0],
                         image_y_rgb=ds.filtered_y[0])
    return nii, h5


CASES = {
    "wdsr": dict(patch=(16, 16)),
    "wdsr_img": dict(patch=(16, 16), channels=1),
    "flavr": dict(patch=(9, 12, 12)),
    "flavr_img": dict(patch=(9, 12, 12), channels=1),
    "flavr_transform": dict(patch=(9, 12, 12), nnunet_transform=True),
    "flavr_device_lr_sim": dict(patch=(9, 12, 12), device_lr_sim=True),
    "flavr_noflip_noblur": dict(patch=(9, 12, 12), random_flip=False,
                                blur=False),
}


def _both(root, case):
    kw = dict(CASES[case])
    patch = kw.pop("patch")
    flip = kw.pop("random_flip", True)
    args = (str(root), ["sub1", "sub2"], 4.0, 1.0, None, "rf-pulse-slr",
            patch, flip)
    return jds.SRPatchDataset(*args, **kw), SRPatchDataset(*args, **kw)


@pytest.mark.parametrize("source", ["nii", "h5"])
@pytest.mark.parametrize("case", list(CASES))
def test_sr_dataset_bit_equal_to_jax(subjects, case, source):
    root = subjects[0] if source == "nii" else subjects[1]
    jd, td = _both(root, case)
    assert td.subjects == jd.subjects
    for _ in range(6):
        (jl, jh), (tl, th) = jd.sample(), td.sample()
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(th, jh)
    lr, hr = BatchLoader(td, 3, seed=4).next()
    jlr, jhr = jds.BatchLoader(jd, 3, seed=4).next()
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(hr, jhr)


def test_from_volumes_and_anchored_matching(subjects, tmp_path):
    """``from_volumes`` over what the constructor read draws the same
    stream; case_1 never takes case_10's file."""
    _, td = _both(subjects[0], "flavr")
    fv = SRPatchDataset.from_volumes(
        list(zip(td.imgs_hr, td.labels_hr, td.filtered_x, td.filtered_y)),
        4.0, 1.0, (9, 12, 12), True)
    for _ in range(4):
        for a, b in zip(td.sample(), fv.sample()):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    for name in ("case_10_0000.nii.gz", "case_1_0000.nii.gz"):
        _make_subject_nifti(str(tmp_path / name), rng, shape=(8, 8, 4))
    ds = SRPatchDataset(str(tmp_path), ["case_1"], 4.0, 1.0, None,
                        "gaussian", (8, 8), True)
    assert ds.subjects == ["case_1_0000.nii.gz"]


def test_simulate_lr_batch_matches_jax():
    """The resize against JAX's at 1e-5 (FLAVR and WDSR batches); the
    slice dropout at given draws against a plain reference."""
    rng = np.random.default_rng(3)
    hr = rng.uniform(size=(4, 16, 6, 12, 2)).astype(np.float32)
    hr[..., 1] = hr[..., 1] > 0.5
    for src in (hr, hr[:, :, 0]):
        want = np.asarray(jsim.simulate_lr_batch(None, jnp.asarray(src), 4.0,
                                                 zero_dropout=False))
        got = tsim.simulate_lr_batch(None, torch.from_numpy(src), 4.0,
                                     zero_dropout=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    first = np.array([0.05, 0.5, 0.09, 0.9], np.float32)
    last = np.array([0.5, 0.01, 0.2, 0.1], np.float32)
    got = tsim.simulate_lr_batch(None, torch.from_numpy(hr), 4.0,
                                 draws=(first, last)).numpy()
    ref = tsim.simulate_lr_batch(None, torch.from_numpy(hr), 4.0,
                                 zero_dropout=False).numpy()
    ref[first < 0.1, 0] = 0.0
    ref[last < 0.1, -1] = 0.0
    np.testing.assert_array_equal(got, ref)
    gen = torch.Generator().manual_seed(0)
    out = tsim.simulate_lr_batch(gen, torch.from_numpy(hr), 4.0)
    assert out.shape == (4, 4, 6, 12, 2)
    wdsr = tsim.simulate_lr_batch(gen, torch.from_numpy(hr[:, :, 0]), 4.0)
    assert wdsr.shape == (4, 4, 12, 2)


def _sampler_ds(root):
    return SRPatchDataset(str(root), ["sub1", "sub2"], 4.0, 1.0, None,
                          "rf-pulse-slr", (9, 12, 12), True,
                          device_lr_sim=True)


def test_device_sampler_rows_and_batches(subjects):
    """The decision rows equal JAX's sampler's at one seed, and the
    batches equal the host loader's bit for bit."""
    root = subjects[0]
    jdev = jsampler.DeviceSRPatchSampler(jds.SRPatchDataset(
        str(root), ["sub1", "sub2"], 4.0, 1.0, None, "rf-pulse-slr",
        (9, 12, 12), True, device_lr_sim=True), 4, seed=11)
    dev = DeviceSRPatchSampler(_sampler_ds(root), 4, seed=11, device="cpu")
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(8):
        np.testing.assert_array_equal(dev._decisions(r1),
                                      jdev._decisions(r2))
    host = BatchLoader(_sampler_ds(root), 4, seed=11)
    for _ in range(3):
        (lh, hh), (ld, hd) = host.next(), dev.next()
        np.testing.assert_array_equal(ld.numpy(), lh)
        np.testing.assert_array_equal(hd.numpy(), hh)
    dev.close()


def test_device_sampler_shards_and_refusals(subjects):
    root = subjects[0]
    full = BatchLoader(_sampler_ds(root), 4, seed=3, shard=(0, 1))
    parts = [DeviceSRPatchSampler(_sampler_ds(root), 4, seed=3,
                                  shard=(i, 2), device="cpu")
             for i in (0, 1)]
    for _ in range(2):
        lr_f, hr_f = full.next()
        got = [p.next() for p in parts]
        np.testing.assert_array_equal(
            np.concatenate([g[0].numpy() for g in got]), lr_f)
        np.testing.assert_array_equal(
            np.concatenate([g[1].numpy() for g in got]), hr_f)
    for case in ("wdsr", "flavr", "flavr_transform", "flavr_img"):
        with pytest.raises(ValueError, match="hot path"):
            DeviceSRPatchSampler(_both(root, case)[1], 2, device="cpu")
    with pytest.raises(ValueError, match="shard"):
        DeviceSRPatchSampler(_sampler_ds(root), 3, shard=(0, 2),
                             device="cpu")
