"""The port's remaining auxiliary modules against the JAX package's, on
seeded inputs: ``utils.rotate.rotate_vol_2d``, the sobel edges and losses,
both legacy datasets, ``fba`` and its tensor form, and the three patch
sampling functions. Draws from the same ``np.random.Generator`` seed are
bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.data import legacy as jlegacy
from rehrseg_tpu.models import sobel as jsobel
from rehrseg_tpu.ops.fba import fba as jfba_np, fba_jax as jfba_jax
from rehrseg_tpu.utils import patch as jpatch
from rehrseg_tpu.utils.rotate import rotate_vol_2d as jrotate
from rehrseg_tpu_torch.data import legacy as tlegacy
from rehrseg_tpu_torch.models import sobel as tsobel
from rehrseg_tpu_torch.ops import fba as tfba
from rehrseg_tpu_torch.utils import patch as tpatch
from rehrseg_tpu_torch.utils.rotate import rotate_vol_2d as trotate


@pytest.mark.parametrize("angle", [0, 90, -90, 180, -180, 270, -270, 360])
def test_rotate_vol_2d(rng, angle):
    vol = rng.normal(size=(6, 5, 3, 2)).astype(np.float32)
    want = np.asarray(jrotate(vol, angle))
    np.testing.assert_array_equal(trotate(vol, angle), want)
    got_t = trotate(torch.from_numpy(vol), angle)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(
        got_t.numpy(), np.asarray(jrotate(jnp.asarray(vol), angle)))


def test_rotate_refuses_other_angles(rng):
    with pytest.raises(NotImplementedError):
        trotate(rng.normal(size=(4, 4, 2)), 45)


@pytest.mark.parametrize("normalized", [True, False])
def test_sobel_edges(rng, normalized):
    img = rng.normal(size=(2, 12, 15, 3)).astype(np.float32)
    img[:, :, 8:] += 2.0
    want = np.asarray(jsobel.sobel_edges(jnp.asarray(img),
                                         normalized=normalized))
    got = tsobel.sobel_edges(torch.from_numpy(img), normalized=normalized)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sobel_losses_and_gradient(rng):
    a = rng.normal(size=(2, 10, 9, 1)).astype(np.float32)
    b = rng.normal(size=(2, 10, 9, 1)).astype(np.float32)
    for name in ("sobel_l1_loss", "sobel_mse_loss"):
        want = float(getattr(jsobel, name)(jnp.asarray(a), jnp.asarray(b)))
        ta = torch.from_numpy(a).requires_grad_(True)
        got = getattr(tsobel, name)(ta, torch.from_numpy(b))
        assert float(got.detach()) == pytest.approx(want, rel=1e-6, abs=1e-7)
        got.backward()
        assert torch.isfinite(ta.grad).all()
    same = tsobel.sobel_l1_loss(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same) == 0.0


def test_augment_3d_image_draws(rng):
    img = rng.normal(size=(2, 5, 6))
    gj, gt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(6):
        np.testing.assert_array_equal(tlegacy.augment_3d_image(img, gt),
                                      jlegacy.augment_3d_image(img, gj))


def test_legacy_trainset(rng):
    from rehrseg_tpu_torch.ops.blur import (calc_extended_patch_size,
                                            parse_kernel)
    image = rng.normal(size=(32, 32, 8, 2)).astype(np.float32)
    kernel = parse_kernel(None, "rf-pulse-slr", 3.873)
    patch = (16, 16, 1)
    ext, crop_slices = calc_extended_patch_size(kernel, list(patch))
    crop = (slice(None), slice(None)) + crop_slices
    # uniform sampling may center a patch at the rim (the reference's
    # quirk, in both packages): its centers are compared, its patches not
    dj = jlegacy.LegacyTrainSet(image, 4.0, tuple(ext), crop, kernel,
                                n_patches=4, patch_sampling="uniform")
    dt = tlegacy.LegacyTrainSet(image, 4.0, tuple(ext), crop, kernel,
                                n_patches=4, patch_sampling="uniform")
    assert dt.centers == dj.centers
    dj = jlegacy.LegacyTrainSet(image, 4.0, tuple(ext), crop, kernel,
                                n_patches=4)
    dt = tlegacy.LegacyTrainSet(image, 4.0, tuple(ext), crop, kernel,
                                n_patches=4)
    assert dt.centers == dj.centers and len(dt) == 4
    for i in range(4):
        (lt, ht), (lj, hj) = dt[i], dj[i]
        assert ht.shape == (2, 16, 16) and lt.shape == (2, 4, 16)
        np.testing.assert_array_equal(ht, hj)
        np.testing.assert_array_equal(lt, lj)


def test_legacy_segsr_dataset(tmp_path, rng):
    from rehrseg_tpu.io.nifti import NiftiImage, save
    merged = rng.normal(size=(24, 24, 8, 2)).astype(np.float32)
    merged[..., 1] = (merged[..., 1] > 1)
    save(NiftiImage(data=merged, affine=np.diag([1.0, 1.0, 4.0, 1.0])),
         str(tmp_path / "s1_0000.nii.gz"))
    args = (str(tmp_path), ["s1"], 4.0, 1.0, (16, 16, 4))
    dj = jlegacy.LegacySegSRDataset(*args, random_flip=True, seed=3)
    dt = tlegacy.LegacySegSRDataset(*args, random_flip=True, seed=3)
    assert len(dt) == len(dj) == 1
    for _ in range(4):
        (it, lt), (ij, lj) = dt[0], dj[0]
        assert it.shape == lt.shape == (4, 16, 16, 1)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("p", ["infinity", "2"])
def test_fba_numpy(rng, p):
    imgs = [rng.normal(size=(6, 8, 10)).astype(np.float32)
            for _ in range(3)]
    np.testing.assert_array_equal(tfba.fba(imgs, p), jfba_np(imgs, p))


@pytest.mark.parametrize("p", [None, 2.0, 0.5])
def test_fba_tensor_form(rng, p):
    imgs = rng.normal(size=(3, 6, 8, 10)).astype(np.float32)
    want = np.asarray(jfba_jax(jnp.asarray(imgs), p))
    got = tfba.fba_torch(torch.from_numpy(imgs), p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if p is None:   # the max rule equals the numpy form's
        np.testing.assert_allclose(got.numpy(), tfba.fba(list(imgs)),
                                   rtol=1e-5, atol=1e-5)


def test_get_patch(rng):
    img = rng.normal(size=(20, 18, 6, 2))
    for center, size in (((10, 9, 3), (8, 6, 1)), ((5, 5, 2), (4, 4, 3))):
        np.testing.assert_array_equal(tpatch.get_patch(img, center, size),
                                      jpatch.get_patch(img, center, size))
        assert tpatch.get_patch(img, center, size, return_idx=True) == \
            jpatch.get_patch(img, center, size, return_idx=True)


def test_gradient_probs(rng):
    img = rng.normal(size=(20, 18, 6))
    for got, want in zip(tpatch._gradient_probs(img, (8, 6, 1)),
                         jpatch._gradient_probs(img, (8, 6, 1))):
        np.testing.assert_array_equal(got, want)
        assert got.sum() == pytest.approx(1.0)


@pytest.mark.parametrize("weighted", [True, False])
def test_get_random_centers(rng, weighted):
    imgs = [rng.normal(size=(20, 18, 6)), rng.normal(size=(18, 20, 6))]
    got = tpatch.get_random_centers(imgs, (8, 6, 1), 9, weighted=weighted,
                                    rng=np.random.default_rng(11))
    want = jpatch.get_random_centers(imgs, (8, 6, 1), 9, weighted=weighted,
                                     rng=np.random.default_rng(11))
    assert got == want and len(got) == 9
