"""The port's NIfTI module against the JAX package's: files written by one
package and read by the other give byte-equal arrays and equal geometry
(the cases of tests/test_nifti.py), and both keep the nibabel quirks."""

import struct

import numpy as np
import pytest

from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu_torch.io import nifti as tnifti

PAIRS = {"jax_to_port": (jnifti, tnifti), "port_to_jax": (tnifti, jnifti)}


@pytest.mark.parametrize("direction", list(PAIRS))
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_cross_roundtrip(tmp_path, rng, direction, suffix, dtype):
    writer, reader = PAIRS[direction]
    data = (rng.normal(size=(7, 9, 5)) * 10).astype(dtype)
    affine = np.diag([1.0, 1.0, 4.0, 1.0])
    affine[:3, 3] = [-10.0, 3.0, 7.0]
    path = str(tmp_path / f"vol{suffix}")
    writer.save(writer.NiftiImage(data=data, affine=affine), path)
    got, want = reader.load(path), writer.load(path)
    assert got.data.dtype == dtype
    assert got.data.tobytes() == data.tobytes() == want.data.tobytes()
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_allclose(got.affine, affine)
    assert got.header.get_zooms() == want.header.get_zooms()
    assert got.header.dim == want.header.dim
    assert got.header.pixdim == want.header.pixdim


def test_same_bytes_on_disk(tmp_path, rng):
    """Uncompressed, both writers emit the same file."""
    data = rng.normal(size=(6, 5, 4)).astype(np.float32)
    affine = np.diag([0.5, 0.5, 4.0, 1.0])
    for mod, name in ((jnifti, "j.nii"), (tnifti, "t.nii")):
        mod.save(mod.NiftiImage(data=data, affine=affine),
                 str(tmp_path / name))
    assert (tmp_path / "j.nii").read_bytes() == \
        (tmp_path / "t.nii").read_bytes()


@pytest.mark.parametrize("direction", list(PAIRS))
def test_cross_4d(tmp_path, rng, direction):
    writer, reader = PAIRS[direction]
    data = rng.normal(size=(6, 6, 4, 2)).astype(np.float32)
    path = str(tmp_path / "vol4d.nii.gz")
    writer.save(writer.NiftiImage(data=data), path)
    got = reader.load(path)
    assert got.shape == (6, 6, 4, 2)
    assert got.data.tobytes() == data.tobytes()
    np.testing.assert_array_equal(got.get_fdata(np.float32),
                                  writer.load(path).get_fdata(np.float32))


@pytest.mark.parametrize("direction", list(PAIRS))
def test_cross_itk_like(tmp_path, rng, direction):
    """(z, y, x) arrays, (x, y, z) spacing, origin and direction."""
    writer, reader = PAIRS[direction]
    arr = rng.normal(size=(5, 8, 9)).astype(np.float32)
    direction_cos = (0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    path = str(tmp_path / "itk.nii.gz")
    writer.write_image_itk(writer.ItkLikeImage(
        array=arr, spacing=(0.8, 0.9, 4.0), origin=(1.0, 2.0, 3.0),
        direction=direction_cos), path)
    got, want = reader.read_image_itk(path), writer.read_image_itk(path)
    assert got.array.tobytes() == want.array.tobytes() == arr.tobytes()
    assert got.GetSpacing() == want.GetSpacing()
    assert got.GetSpacing() == pytest.approx((0.8, 0.9, 4.0))
    assert got.GetOrigin() == want.GetOrigin() == pytest.approx((1, 2, 3))
    assert got.GetDirection() == want.GetDirection()


def test_scl_slope_zero_means_unscaled(rng):
    data = rng.normal(size=(4, 4, 2)).astype(np.float32)
    for mod in (jnifti, tnifti):
        img = mod.NiftiImage(data=data, affine=np.eye(4))
        img.header.scl_slope = 0.0
        img.header.scl_inter = 100.0
        np.testing.assert_array_equal(img.get_fdata(np.float32), data)
        img.header.scl_slope = 2.0
        img.header.scl_inter = 1.0
        np.testing.assert_allclose(img.get_fdata(np.float32), data * 2 + 1,
                                   rtol=1e-6)


def test_two_file_nifti_rejected(tmp_path, rng):
    p = str(tmp_path / "pair.nii")
    data = rng.normal(size=(2, 2, 2)).astype(np.float32)
    tnifti.save(tnifti.NiftiImage(data=data, affine=np.eye(4)), p)
    raw = bytearray(open(p, "rb").read())
    struct.pack_into("<4s", raw, 344, b"ni1\x00")
    open(p, "wb").write(bytes(raw))
    for mod in (jnifti, tnifti):
        with pytest.raises(ValueError, match="two-file"):
            mod.load(p)
