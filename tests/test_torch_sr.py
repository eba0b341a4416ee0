"""The port's stage-1 SR modules against the JAX package's on the same
numpy-made params and inputs, fp32, on the CPU: UNet3D (FLAVR) plain and
UASR at full channel widths and a small spatial size (forward, ``encode``,
intermediate features), carried over by ``convert.load_flax_flavr_params``;
WDSR at an integer and a fractional scale; WNConv, SEGating, the
transposed conv's kernel mapping, ``pixel_shuffle_axis`` and the B-spline
resize; ``infer_flavr_volume`` (resident and host loop, both heads'
outputs, the zero-padded tail chunk, a z that needs the rational pad) and
``infer_wdsr_volume``; the NIfTI volume helpers (``write_sr_niftis`` files
read by JAX's reader, ``parse_image`` with its quirks); the slice-count
and FWHM math; and the param-shape functions against JAX's ``init``.

Forwards are compared at rtol = atol = 1e-4 (fp32, XLA's and PyTorch's
summation orders differ; the observed gap is about 1e-6)."""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rehrseg_tpu.infer import sr_infer as jsr
from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu.io import volume as jvolume
from rehrseg_tpu.models import UNet3D as JaxUNet3D
from rehrseg_tpu.models import WDSR as JaxWDSR
from rehrseg_tpu.models import layers as jlayers
from rehrseg_tpu.ops import blur as jblur
from rehrseg_tpu.ops import bspline as jbspline
from rehrseg_tpu.ops.pixel_shuffle import pixel_shuffle_axis as jshuffle
from rehrseg_tpu.utils import patch as jpatch
from rehrseg_tpu_torch.infer import sr_infer as tsr
from rehrseg_tpu_torch.io import nifti
from rehrseg_tpu_torch.io import volume as tvolume
from rehrseg_tpu_torch.models import convert, layers
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.wdsr import WDSR
from rehrseg_tpu_torch.ops import blur as tblur
from rehrseg_tpu_torch.ops import bspline as tbspline
from rehrseg_tpu_torch.ops.pixel_shuffle import pixel_shuffle_axis
from rehrseg_tpu_torch.utils import patch as tpatch

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
X_SHAPE = (2, 4, 16, 16, 2)          # (B, D, H, W, C)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def flavr():
    """{use_uncertainty: (JAX UNet3D, flax params, port UNet3D)} over the
    same seeded params, full widths (NF 512..64), 4 -> 4 slices."""
    out = {}
    for unc in (False, True):
        p = convert.random_flavr_params(11 + unc, use_uncertainty=unc)
        model = UNet3D(use_uncertainty=unc)
        convert.load_flax_flavr_params(model, p, unc)
        out[unc] = (JaxUNet3D(img_channels=2, n_inputs=4, n_outputs=4,
                              use_uncertainty=unc), p, model.eval())
    return out


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=X_SHAPE).astype(np.float32)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("kw", [
    dict(use_uncertainty=False), dict(use_uncertainty=True),
    dict(n_outputs=1), dict(img_channels=1, n_inputs=2, n_outputs=2)])
def test_flavr_param_shapes_match_jax_init(kw):
    cfg = dict(dict(img_channels=2, n_inputs=4, n_outputs=4), **{
        k: v for k, v in kw.items() if k != "use_uncertainty"})
    unc = kw.get("use_uncertainty", False)
    jm = JaxUNet3D(use_uncertainty=unc, **cfg)
    x = jnp.zeros((1, cfg["n_inputs"], 16, 16, cfg["img_channels"]))
    got = convert.flavr_param_shapes(use_uncertainty=unc, **cfg)
    assert _shapes(jax.eval_shape(jm.init, jax.random.key(0), x)) == got
    # the bridge lands every leaf in the port's module (strict)
    model = UNet3D(use_uncertainty=unc, **cfg)
    convert.load_flax_flavr_params(
        model, convert.random_flavr_params(0, use_uncertainty=unc, **cfg),
        unc)


@pytest.mark.parametrize("kw", [dict(scale=4.0), dict(scale=2.5),
                                dict(n_resblocks=3, num_channels=8,
                                     out_channel=1, scale=3.0)])
def test_wdsr_param_shapes_match_jax_init(kw):
    cfg = dict(dict(out_channel=2, n_resblocks=16, num_channels=32), **kw)
    x = jnp.zeros((1, 8, 8, cfg["out_channel"]))
    want = _shapes(jax.eval_shape(JaxWDSR(**cfg).init, jax.random.key(0), x))
    assert convert.wdsr_param_shapes(**cfg) == want


def test_flavr_plain_matches_jax(flavr, x):
    jm, p, model = flavr[False]
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = _np(model(torch.from_numpy(x)))
    assert got.shape == want.shape == (2, 4, 16, 16, 2)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[..., 0]).max() <= 1.0     # tanh on the image channel


def test_flavr_uasr_matches_jax(flavr, x):
    jm, p, model = flavr[True]
    want_out, want_unc = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        out, unc = model(torch.from_numpy(x))
    assert out.shape == (2, 4, 16, 16, 2) and unc.shape == (2, 4, 16, 16, 1)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(_np(unc), np.asarray(want_unc), **TOL)


@pytest.mark.parametrize("unc", [False, True])
def test_flavr_encode_and_intermediate_features_match_jax(flavr, x, unc):
    jm, p, model = flavr[unc]
    want = jm.apply(p, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x))
        inter = model(torch.from_numpy(x), return_intermediate_feature=True)
    assert [tuple(f.shape) for f in got] == [
        (2, 4, 8, 8, 64), (2, 4, 8, 8, 64), (2, 4, 4, 4, 128),
        (2, 4, 2, 2, 256), (2, 4, 2, 2, 512)]
    for g, i, w in zip(got, inter, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        np.testing.assert_array_equal(_np(i), _np(g))
    assert model.calc_out_patch_size([4, 32, 32]) == \
        jm.calc_out_patch_size([4, 32, 32]) == [16, 32, 32]


def test_flavr_encoder_bias_only_with_several_outputs():
    """The encoder's convs carry a bias only when n_outputs > 1, the
    downsample never; the decoder's and heads' convs always."""
    keys = set(UNet3D(n_outputs=1).state_dict())
    assert "encoder.stem.0.bias" not in keys
    assert "encoder.layer2.0.conv1.0.bias" not in keys
    assert "encoder.layer2.0.fg.attn_layer.0.bias" in keys
    assert "decoder.1.upconv.0.bias" in keys
    keys4 = set(UNet3D(n_outputs=4).state_dict())
    assert "encoder.stem.0.bias" in keys4
    assert not any("downsample.0.bias" in k for k in keys4)
    assert keys4 == set(convert.flavr_mapping(False, True))


def test_conv_transpose_kernel_mapping_matches_flax():
    """flax ConvTranspose(transpose_kernel=True) with padding k - 1 - p
    (JAX's conv_transpose_torch) equals the port's ConvTranspose3d with
    padding p once its (*K, O, I) kernel is moved to (I, O, *K)."""
    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, h):
            return jlayers.conv_transpose_torch(h, 3, (3, 4, 4), (1, 2, 2),
                                                (1, 1, 1), name="up")

    xin = np.random.default_rng(1).normal(size=(2, 3, 5, 6, 4)).astype(
        np.float32)
    mod = Up()
    p = mod.init(jax.random.key(0), jnp.asarray(xin))
    kernel = np.asarray(p["params"]["up"]["kernel"])
    assert kernel.shape == (3, 4, 4, 3, 4)               # (*K, O, I)
    p = {"params": {"up": {"kernel": np.random.default_rng(2).normal(
        size=kernel.shape).astype(np.float32), "bias": np.arange(
            3, dtype=np.float32)}}}
    want = np.asarray(mod.apply(p, jnp.asarray(xin)))
    conv = layers.conv_transpose_torch(4, 3, (3, 4, 4), (1, 2, 2), (1, 1, 1))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(convert._conv_to_torch(
            p["params"]["up"]["kernel"])))
        conv.bias.copy_(torch.from_numpy(p["params"]["up"]["bias"]))
        got = _np(conv(torch.from_numpy(xin).permute(0, 4, 1, 2, 3))
                  .permute(0, 2, 3, 4, 1))
    assert got.shape == want.shape == (2, 3, 10, 12, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_wnconv_matches_jax(k):
    """g * v / ||v|| with the fp32 norm and its 1e-12; a fresh WNConv's
    kernel equals its v."""
    rng = np.random.default_rng(k)
    xin = rng.normal(size=(2, 7, 6, 3)).astype(np.float32)
    conv = jlayers.WNConv(features=4, kernel_size=(k, k))
    p = {"params": {"v": rng.normal(size=(k, k, 3, 4)).astype(np.float32),
                    "g": rng.normal(size=(4,)).astype(np.float32),
                    "bias": rng.normal(size=(4,)).astype(np.float32)}}
    want = np.asarray(conv.apply(p, jnp.asarray(xin)))
    mod = layers.WNConv(3, 4, k)
    with torch.no_grad():
        mod.weight_v.copy_(torch.from_numpy(convert._conv_to_torch(
            p["params"]["v"])))
        mod.weight_g.copy_(torch.from_numpy(p["params"]["g"]).view(
            4, 1, 1, 1))
        mod.bias.copy_(torch.from_numpy(p["params"]["bias"]))
        got = _np(mod(torch.from_numpy(xin).permute(0, 3, 1, 2))
                  .permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, **TOL)
    fresh = layers.WNConv(3, 4, k)
    v = fresh.weight_v
    norm = (v.float().pow(2).sum((1, 2, 3), keepdim=True) + 1e-12).sqrt()
    torch.testing.assert_close(fresh.weight_g * v / norm, v)
    assert set(dict(fresh.named_parameters())) == {"weight_v", "weight_g",
                                                   "bias"}


def test_segating_matches_jax():
    rng = np.random.default_rng(3)
    xin = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    p = {"params": {"attn": {
        "kernel": rng.normal(size=(1, 1, 1, 6, 6)).astype(np.float32),
        "bias": rng.normal(size=(6,)).astype(np.float32)}}}
    want = np.asarray(jlayers.SEGating().apply(p, jnp.asarray(xin)))
    mod = layers.SEGating(6)
    with torch.no_grad():
        mod.attn_layer[0].weight.copy_(torch.from_numpy(
            convert._conv_to_torch(p["params"]["attn"]["kernel"])))
        mod.attn_layer[0].bias.copy_(torch.from_numpy(
            p["params"]["attn"]["bias"]))
        got = _np(mod(torch.from_numpy(xin).permute(0, 4, 1, 2, 3))
                  .permute(0, 2, 3, 4, 1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scale", [4.0, 2.5])
def test_wdsr_matches_jax(scale):
    """WDSR with bridged params; at 2.5 the fractional pre-resize (x1.25,
    B-spline matrix) precedes the x2 pixel shuffle."""
    cfg = dict(out_channel=2, n_resblocks=3, num_channels=8, scale=scale)
    p = convert.random_wdsr_params(5, **cfg)
    xin = np.random.default_rng(6).normal(size=(2, 8, 12, 2)).astype(
        np.float32)
    jm = JaxWDSR(**cfg)
    want = np.asarray(jm.apply(p, jnp.asarray(xin)))
    model = WDSR(**cfg)
    convert.load_flax_wdsr_params(model, p)
    with torch.no_grad():
        got = _np(model(torch.from_numpy(xin)))
    assert got.shape == want.shape == (2, 32 if scale == 4.0 else 20, 12, 2)
    np.testing.assert_allclose(got, want, **TOL)
    assert model.calc_out_patch_size([8, 12]) == \
        jm.calc_out_patch_size([8, 12])


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_pixel_shuffle_axis_matches_jax(scale):
    xin = np.random.default_rng(scale).normal(
        size=(2, 5, 3, 2 * scale)).astype(np.float32)
    got = pixel_shuffle_axis(torch.from_numpy(xin), scale)
    want = np.asarray(jshuffle(jnp.asarray(xin), scale))
    np.testing.assert_array_equal(_np(got), want)
    # channel c_out * scale + phase lands at x * scale + phase
    np.testing.assert_array_equal(_np(got)[:, 1 * scale + 1, :, 1],
                                  xin[:, 1, :, 1 * scale + 1])


@pytest.mark.parametrize("n,dx,order", [(8, 0.8, 3), (10, 0.4, 3),
                                        (7, 1.5, 0), (9, 2.0 / 3.0, 1)])
def test_bspline_resize_matches_jax(n, dx, order):
    frac = tbspline.as_fraction(dx)
    assert frac == jbspline.as_fraction(dx)
    assert tbspline.output_size(n, dx) == jbspline.output_size(n, dx)
    np.testing.assert_array_equal(tbspline.sample_coords(n, dx),
                                  jbspline.sample_coords(n, dx))
    np.testing.assert_array_equal(tbspline.resize_matrix(n, frac, order),
                                  jbspline.resize_matrix(n, frac, order))
    xin = np.random.default_rng(n).normal(size=(3, n, 4)).astype(np.float32)
    want = np.asarray(jbspline.resize_1d_jax(jnp.asarray(xin), dx, 1,
                                             order))
    np.testing.assert_allclose(
        _np(tbspline.resize_1d(torch.from_numpy(xin), dx, 1, order)), want,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbspline.resize_1d_np(xin, dx, 1, order),
                               jbspline.resize_1d_np(xin, dx, 1, order),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tbspline.zoom_axis_np(xin, 1.0 / dx, 1,
                                                        order),
                                  jbspline.zoom_axis_np(xin, 1.0 / dx, 1,
                                                        order))


@pytest.mark.parametrize("sep", [4.0, 2.5, 2.0, 3.5])
def test_slice_count_and_fwhm_math_match_jax(sep):
    for n in range(1, 30):
        assert tpatch.find_integer_p(n, sep) == jpatch.find_integer_p(n, sep)
        assert tpatch.ideal_size(n, sep) == jpatch.ideal_size(n, sep)
        for p in range(4):
            assert tpatch.projected_size(n, p, sep) == \
                jpatch.projected_size(n, p, sep)
            assert tpatch.calc_slices_to_crop(p, sep) == \
                jpatch.calc_slices_to_crop(p, sep)
    assert tblur.blur_fwhm_in_voxels(1.0, sep) == \
        jblur.blur_fwhm_in_voxels(1.0, sep)
    assert tblur.fwhm_needed(sep, 1.0) == jblur.fwhm_needed(sep, 1.0) == 0.0
    assert tblur.fwhm_units_to_voxel_space(3.0, sep) == \
        jblur.fwhm_units_to_voxel_space(3.0, sep)


# ---------------------------------------------------------- volume inference

@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("unc,out_index", [(False, None), (True, 0),
                                           (True, 1)])
def test_infer_flavr_volume_matches_jax(flavr, unc, out_index, resident):
    """(x, y, z) = (12, 10, 7): H and W padded to 16, 6 windows in chunks
    of 4 (the last chunk zero-padded), 24 output slices."""
    jm, p, model = flavr[unc]
    vol = np.random.default_rng(7).normal(size=(12, 10, 7, 2)).astype(
        np.float32)
    want = np.asarray(jsr.infer_flavr_volume(
        jm, p, vol, 4.0, out_index=out_index, batch=4, device=resident))
    got = tsr.infer_flavr_volume(model, vol, 4.0, out_index=out_index,
                                 batch=4, resident=resident, device="cpu")
    assert got.dtype == np.float32
    assert got.shape == want.shape == (12, 10, 24, 1 if out_index else 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_infer_flavr_volume_rational_pad_matches_jax(flavr):
    """slice_separation 2.5 on z = 6: reflect-padded by 2 slices, 7
    windows (one chunk of 4 and a padded one), 28 slices less the 5 the
    pad maps to."""
    jm, p, model = flavr[False]
    assert tpatch.find_integer_p(6, 2.5) == 2
    vol = np.random.default_rng(8).normal(size=(9, 16, 6, 2)).astype(
        np.float32)
    want = np.asarray(jsr.infer_flavr_volume(jm, p, vol, 2.5, batch=4))
    got = tsr.infer_flavr_volume(model, vol, 2.5, batch=4, device="cpu")
    assert got.shape == want.shape == (9, 16, 23, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_infer_flavr_volume_async_and_host_loop_agree(flavr):
    """The resident path equals the host loop (1e-5), the async form's
    finalize() equals the resident call, and a bf16 compute_dtype runs a
    cast copy (the caller's module stays fp32) near the fp32 result."""
    _, _, model = flavr[True]
    vol = np.random.default_rng(9).normal(size=(8, 8, 5, 2)).astype(
        np.float32)
    kw = dict(batch=3, device="cpu")
    res = tsr.infer_flavr_volume(model, vol, 4.0, out_index=1, **kw)
    host = tsr.infer_flavr_volume(model, vol, 4.0, out_index=1,
                                  resident=False, **kw)
    np.testing.assert_allclose(res, host, rtol=1e-5, atol=1e-5)
    fin = tsr.infer_flavr_volume_async(model, vol, 4.0, out_index=1, **kw)
    np.testing.assert_array_equal(fin(), res)
    bf16 = tsr.infer_flavr_volume(model, vol, 4.0, out_index=1,
                                  compute_dtype=torch.bfloat16, **kw)
    assert next(model.parameters()).dtype == torch.float32
    assert bf16.dtype == np.float32
    np.testing.assert_allclose(bf16, res, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("scale,shape", [(4.0, (5, 6, 6, 2)),
                                         (2.5, (5, 7, 6, 2))])
def test_infer_wdsr_volume_matches_jax(scale, shape):
    """Every x-slice through WDSR in chunks of 4 (5 slices: a padded
    chunk); at 2.5 z = 6 is reflect-padded by 2 and cropped by 5."""
    cfg = dict(out_channel=2, n_resblocks=2, num_channels=8, scale=scale)
    p = convert.random_wdsr_params(12, **cfg)
    model = WDSR(**cfg)
    convert.load_flax_wdsr_params(model, p)
    vol = np.random.default_rng(13).normal(size=shape).astype(np.float32)
    want = np.asarray(jsr.infer_wdsr_volume(JaxWDSR(**cfg), p, vol, scale,
                                            batch=4))
    got = tsr.infer_wdsr_volume(model, vol, scale, batch=4, device="cpu")
    assert got.shape == want.shape == shape[:2] + (int(round(
        6 * scale)), 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_intensity_helpers_match_jax():
    a = np.random.default_rng(14).normal(size=(4, 5, 3)).astype(np.float32)
    got, lo, hi = tvolume.normalize(a, 0, 1)
    want, jlo, jhi = jvolume.normalize(a, 0, 1)
    np.testing.assert_array_equal(got, want)
    assert (lo, hi) == (jlo, jhi)
    np.testing.assert_array_equal(tsr.restore_intensity(got, lo, hi),
                                  jsr.restore_intensity(want, lo, hi))
    np.testing.assert_array_equal(tvolume.inv_normalize(a, 2.0, 5.0),
                                  jvolume.inv_normalize(a, 2.0, 5.0))
    np.testing.assert_array_equal(tsr.zeroonenorm255(a),
                                  jsr.zeroonenorm255(a))


# ------------------------------------------------------------------ NIfTI

@pytest.mark.parametrize("zooms", [(0.9, 0.8, 4.0), (4.0, 0.9, 0.8)])
def test_parse_image_matches_jax(tmp_path, zooms):
    """A merged 2-channel NIfTI (x, y, z, 2) read by both packages: the same
    array, separation, FWHM, extrema, and lr_axis 0 (the quirk: a 2-long
    zoom tuple is the only case that picks by argmax)."""
    data = np.random.default_rng(15).normal(size=(6, 5, 4, 2)).astype(
        np.float32)
    path = str(tmp_path / "merged.nii.gz")
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([*zooms, 1.0])),
               path)
    got = tvolume.parse_image(path, 4.0, 1.0)
    want = jvolume.parse_image(path, 4.0, 1.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:4] == want[1:4] and got[2] == 0
    assert (got[6], got[7]) == (want[6], want[7])
    np.testing.assert_array_equal(got[5], want[5])


@pytest.mark.parametrize("lr_axis", [0, 1, 2])
def test_orientation_helpers_match_jax(lr_axis):
    a = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    np.testing.assert_array_equal(tvolume.lr_axis_to_z(a, lr_axis),
                                  jvolume.lr_axis_to_z(a, lr_axis))
    np.testing.assert_array_equal(tvolume.z_axis_to_lr_axis(a, lr_axis),
                                  jvolume.z_axis_to_lr_axis(a, lr_axis))


def test_h5_volume_is_refused(tmp_path, monkeypatch):
    """An HDF5 volume is refused only where h5py is missing (an ImportError
    naming it); with h5py a store the JAX package wrote loads."""
    path = str(tmp_path / "x.h5")
    jvolume.write_h5(path, img=np.arange(6, dtype=np.float32))
    vol = tvolume.load_volume(path, 4.0, 1.0)
    np.testing.assert_array_equal(vol.data["img"][:], np.arange(6))
    assert (vol.slice_separation, vol.lr_axis) == (4.0, None)
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tvolume.load_volume(path, 4.0, 1.0)


def test_write_sr_niftis_read_by_jax(tmp_path):
    """The port's SR outputs read back by the JAX package's reader: (z, y,
    x) arrays, the HR z-spacing, seg binarized to uint8."""
    rng = np.random.default_rng(16)
    img, seg, unc = (rng.normal(size=(6, 5, 8)).astype(np.float32)
                     for _ in range(3))
    ref = nifti.ItkLikeImage(np.zeros((2, 5, 6), np.float32),
                             (0.9, 0.8, 4.0), (1.0, 2.0, 3.0))
    base = str(tmp_path / "case")
    tvolume.write_sr_niftis(ref, base, 4.0, img_xyz=img, seg_xyz=seg,
                            unc_xyz=unc)
    assert sorted(os.listdir(tmp_path)) == [
        "case_img.nii.gz", "case_seg.nii.gz", "case_uncertainty.nii.gz"]
    for suffix, arr, dtype in (("_img", img, np.float32),
                               ("_seg", (seg > 0).astype(np.uint8),
                                np.uint8),
                               ("_uncertainty", unc, np.float32)):
        back = jnifti.read_image_itk(base + suffix + ".nii.gz")
        assert back.array.dtype == dtype
        np.testing.assert_array_equal(back.array, arr.transpose(2, 1, 0))
        assert back.spacing == pytest.approx((0.9, 0.8, 1.0))
        assert back.origin == pytest.approx((1.0, 2.0, 3.0))


def test_resize_matrix_is_cached_and_read_only():
    a = tbspline.resize_matrix(8, Fraction(4, 5), 3)
    assert tbspline.resize_matrix(8, Fraction(4, 5), 3) is a
    assert not a.flags.writeable
