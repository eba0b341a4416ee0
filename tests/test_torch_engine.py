"""The port's sliding-window engines against the JAX package's, with the
same numpy-made weights and volumes, on the CPU: the parity engine
(fp32 logits, labels), and the aligned engine (its grid, and its LR and
dual labels against the JAX aligned engine, whose Pallas accumulate runs
in interpret mode; once more with the pallas_conv=True forward and with
the "fused" forward on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.models.segnet_packed import (
    segmodel_apply_packed as jax_packed)
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.ops import pconv
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(SMALL_ARCH, 1)


def _fns(params, arch=SMALL_ARCH, **kw):
    """The same packed forward as a JAX model_fn(p, batch) and a port
    model_fn(batch)."""
    kw = dict(pack_max_channels=64, **kw)
    tparams = convert.tree_to_torch(params)

    def jfn(p, b):
        return jax_packed(arch, p, b, **kw)

    def tfn(b):
        return segmodel_apply_packed(arch, tparams, b, **kw)

    return jfn, tfn


def _labels_agree(got, want, logits, margin=1e-3):
    """Labels equal except at voxels whose reference logit margin (top
    two classes) is below ``margin``: there fp32 summation order decides."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= margin
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[decided], want[decided])


def test_combos_match_jax():
    assert tsw._flip_axes_combinations(3) == jsw._flip_axes_combinations(3)


@pytest.mark.parametrize("image,patch", [
    ((6, 24, 24), (4, 16, 16)), ((20, 455, 633), (16, 320, 384)),
    ((5, 17, 40), (5, 16, 16)),
])
def test_parity_starts_match_jax(image, patch):
    np.testing.assert_array_equal(
        tsw.sliding_window_starts(image, patch, 0.5),
        jsw.sliding_window_starts(image, patch, 0.5))


def test_parity_logits_and_labels_match_jax(params):
    """fp32 end to end (input_dtype=float32 on both sides): logits at
    2e-4, labels equal wherever the JAX logit margin is >= 1e-3."""
    jfn, tfn = _fns(params)
    vol = np.random.default_rng(0).normal(size=(6, 24, 24, 1)).astype(
        np.float32)
    patch = (4, 16, 16)
    want = jsw.predict_sliding_window_logits(
        jfn, params, vol, patch, input_dtype=jnp.float32)
    got = tsw.predict_sliding_window_logits(
        tfn, vol, patch, input_dtype=torch.float32, **CPU)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    labels = tsw.predict_sliding_window_labels(
        tfn, vol, patch, input_dtype=torch.float32, **CPU)
    _labels_agree(labels, np.argmax(want, -1), want)


def test_parity_dual_labels_match_jax(params):
    jfn, tfn = _fns(params, dual=True, upscale=4)
    vol = _blob_volume((6, 24, 24), np.random.default_rng(1))[..., None]
    patch = (4, 16, 16)
    want_lr, want_hr = jsw.predict_sliding_window_dual_labels(
        jfn, params, vol, patch, slice_separation=4,
        input_dtype=jnp.float32)
    llr, lhr = tsw._dual_logits(tfn, vol, patch, 4, 0.5, True, True, 2,
                                torch.float32, "cpu")
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels(
        tfn, vol, patch, slice_separation=4, input_dtype=torch.float32,
        **CPU)
    _labels_agree(got_lr, want_lr, llr.numpy())
    _labels_agree(got_hr, want_hr, lhr.numpy())


@pytest.mark.parametrize("image,patch", [
    ((20, 455, 633), (16, 320, 384)), ((12, 38, 190), (4, 16, 128)),
    ((6, 24, 16), (4, 16, 16)), ((6, 27, 190), (4, 16, 128)),
])
def test_aligned_starts_match_jax(image, patch):
    got_s, got_p = tsw.aligned_sliding_window_starts(image, patch, 0.5)
    want_s, want_p = jsw.aligned_sliding_window_starts(image, patch, 0.5)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_p == want_p


def test_aligned_coverage_guard_matches_jax():
    with pytest.raises(ValueError, match="aligned tile grid"):
        jsw.aligned_sliding_window_starts((12, 38, 38), (4, 16, 16), 0.5)
    with pytest.raises(ValueError, match="aligned tile grid"):
        tsw.aligned_sliding_window_starts((12, 38, 38), (4, 16, 16), 0.5)


@pytest.mark.parametrize("shape,patch", [((6, 24, 16), (4, 16, 16)),
                                         ((6, 27, 190), (4, 16, 128))],
                         ids=["aligned_already", "padded"])
def test_aligned_labels_match_jax(params, shape, patch):
    """LR labels of the aligned engine (K2's plain version) against the
    JAX aligned engine (Pallas accumulate in interpret mode), same bf16
    volume upload on both sides."""
    jfn, tfn = _fns(params, plane_out=True)
    vol = _blob_volume(shape, np.random.default_rng(2))[..., None]
    want = jsw.predict_sliding_window_labels_aligned(jfn, params, vol, patch)
    got = tsw.predict_sliding_window_labels_aligned(tfn, vol, patch, **CPU)
    logits = tsw._aligned_logits(tfn, vol, patch, device="cpu")
    margin_src = np.moveaxis(logits.numpy(), 0, -1)[:shape[0], :shape[1],
                                                   :shape[2]]
    _labels_agree(got, want, margin_src)
    assert got.shape == shape


def test_aligned_dual_labels_match_jax(params):
    jfn, tfn = _fns(params, plane_out=True, dual=True, upscale=4)
    vol = _blob_volume((6, 27, 190), np.random.default_rng(3))[..., None]
    patch = (4, 16, 128)
    want_lr, want_hr = jsw.predict_sliding_window_dual_labels_aligned(
        jfn, params, vol, patch, slice_separation=4)
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels_aligned(
        tfn, vol, patch, slice_separation=4, **CPU)
    llr, lhr = tsw._aligned_logits(tfn, vol, patch, slice_separation=4,
                                   device="cpu")
    _labels_agree(got_lr, want_lr,
                  np.moveaxis(llr.numpy(), 0, -1)[:6, :27, :190])
    _labels_agree(got_hr, want_hr,
                  np.moveaxis(lhr.numpy(), 0, -1)[:24, :27, :190])
    assert got_hr.shape == (24, 27, 190)


def test_aligned_dual_pallas_all_matches_jax(monkeypatch):
    """The aligned dual engine with pallas_conv=True on both sides (the
    JAX A/B harness's forward): at features (32, 64, ...) the port's
    forward runs K1 once, K3 twice and K5 twice on every tile."""
    arch = dict(SMALL_ARCH, features_per_stage=(32, 64, 64, 64))
    params = convert.random_flax_params(arch, 1)
    engaged = []
    for name in ("pconv_pad11_cat", "pconv_valid", "pconv3_valid"):
        orig = getattr(pconv, name)

        def spy(*a, _orig=orig, _name=name, **k):
            y = _orig(*a, **k)
            engaged.append(_name if y is not None else None)
            return y

        monkeypatch.setattr(pconv, name, spy)
    jfn, tfn = _fns(params, arch, plane_out=True, dual=True, upscale=4,
                    pallas_conv=True)
    vol = _blob_volume((6, 24, 128), np.random.default_rng(4))[..., None]
    patch = (4, 16, 128)
    want_lr, want_hr = jsw.predict_sliding_window_dual_labels_aligned(
        jfn, params, vol, patch, slice_separation=4)
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels_aligned(
        tfn, vol, patch, slice_separation=4, **CPU)
    tiles = engaged.count("pconv_pad11_cat")
    assert tiles > 0 and None not in engaged
    assert engaged.count("pconv_valid") == 2 * tiles
    assert engaged.count("pconv3_valid") == 2 * tiles
    llr, lhr = tsw._aligned_logits(tfn, vol, patch, slice_separation=4,
                                   device="cpu")
    _labels_agree(got_lr, want_lr,
                  np.moveaxis(llr.numpy(), 0, -1)[:6, :24, :128])
    _labels_agree(got_hr, want_hr,
                  np.moveaxis(lhr.numpy(), 0, -1)[:24, :24, :128])


def test_aligned_dual_fused_matches_jax(monkeypatch):
    """The aligned dual engine with pallas_conv="fused" on both sides (the
    JAX harness's dual_fn_planes_fused): at features (32, 64, ...) the
    port's forward runs K6a once, K6b twice and K6c twice on every
    tile."""
    arch = dict(SMALL_ARCH, features_per_stage=(32, 64, 64, 64))
    params = convert.random_flax_params(arch, 2)
    engaged = []
    for name in ("pconv_pad11_cat", "pconv_valid", "pconv3_valid"):
        orig = getattr(pconv, name)

        def spy(*a, _orig=orig, _name=name, **k):
            y = _orig(*a, **k)
            engaged.append(_name if y is not None and k.get("want_stats")
                           else None)
            return y

        monkeypatch.setattr(pconv, name, spy)
    jfn, tfn = _fns(params, arch, plane_out=True, dual=True, upscale=4,
                    pallas_conv="fused")
    vol = _blob_volume((6, 24, 128), np.random.default_rng(5))[..., None]
    patch = (4, 16, 128)
    want_lr, want_hr = jsw.predict_sliding_window_dual_labels_aligned(
        jfn, params, vol, patch, slice_separation=4)
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels_aligned(
        tfn, vol, patch, slice_separation=4, **CPU)
    tiles = engaged.count("pconv_pad11_cat")
    assert tiles > 0 and None not in engaged
    assert engaged.count("pconv_valid") == 2 * tiles
    assert engaged.count("pconv3_valid") == 2 * tiles
    llr, lhr = tsw._aligned_logits(tfn, vol, patch, slice_separation=4,
                                   device="cpu")
    _labels_agree(got_lr, want_lr,
                  np.moveaxis(llr.numpy(), 0, -1)[:6, :24, :128])
    _labels_agree(got_hr, want_hr,
                  np.moveaxis(lhr.numpy(), 0, -1)[:24, :24, :128])


def test_engines_refuse_a_missing_card(monkeypatch):
    """device=None means the card; without one the engine raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((4, 16, 16, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsw.predict_sliding_window_labels(lambda b: b, vol, (4, 16, 16))
