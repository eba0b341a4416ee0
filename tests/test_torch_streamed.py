"""The port's z-slab streamed engines against the JAX package's, with the
same numpy-made weights and volumes, fp32, on the CPU (LR and dual;
z_slab_tiles 1, 2, 3; mirror off and on), and against the port's own
whole-volume engines; Segmenter(streaming=) against the JAX Segmenter, its
segment_many fallback and its refusal of the aligned grid.

Labels are compared as equal except where the reference logit margin is
below 1e-3 (fp32 summation order: the streamed engines add each slab's
logits into host buffers). The forward is the packed SegModel with
features (32, 32, 32, 32), so K1's wrapper engages at the decoder concat;
a spy counts it once per tile."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models.segnet_packed import (
    segmodel_apply_packed as jax_packed)
from rehrseg_tpu.serve import Segmenter as JaxSegmenter
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.ops import pconv
from rehrseg_tpu_torch.serve import Segmenter
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

ARCH = dict(SMALL_ARCH, features_per_stage=(32, 32, 32, 32))
PATCH = (4, 16, 16)
F32 = dict(input_dtype=torch.float32, device="cpu")
# four z-starts (0, 2, 4, 6) x 2 x 2: 16 tiles; 1, 2 and 3 rows per slab
# give 4, 2 and 2 (unequal) slabs
VOLUME = (10, 24, 24)


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(ARCH, 7)


@pytest.fixture(scope="module")
def fns(params):
    """(JAX LR, JAX dual, port LR, port dual) model functions over the same
    packed forward and weights (module-scoped: JAX's jit caches key on the
    function's identity)."""
    kw = dict(pack_max_channels=64, pallas_conv="cat")
    tp = convert.tree_to_torch(params)
    return (lambda p, b: jax_packed(ARCH, p, b, **kw),
            lambda p, b: jax_packed(ARCH, p, b, dual=True, upscale=4, **kw),
            lambda b: segmodel_apply_packed(ARCH, tp, b, **kw),
            lambda b: segmodel_apply_packed(ARCH, tp, b, dual=True,
                                            upscale=4, **kw))


@pytest.fixture(scope="module")
def vol():
    return _blob_volume(VOLUME, np.random.default_rng(3))[..., None]


def _labels_agree(got, want, logits, margin=1e-3):
    """Labels equal except at voxels whose reference logit margin (top two
    classes) is below ``margin``."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= margin
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert decided.mean() > 0.98, decided.mean()
    np.testing.assert_array_equal(got[decided], want[decided])


def _whole_logits(fns, vol, mirror, dual):
    """The port's whole-volume logits divided by the gaussian weight sums
    (the margin reference); the weights are the engine's accumulation of a
    model that predicts 1 everywhere."""
    def ones(b):
        return torch.ones(*b.shape[:-1], 1)

    args = (vol, PATCH, 4, 0.5, True, mirror)
    if dual:
        llr, lhr = tsw._dual_logits(fns[3], *args, 2, torch.float32, "cpu")
        wlr, whr = tsw._dual_logits(
            lambda b: (ones(b), ones(b).repeat_interleave(4, 1)), *args, 1,
            torch.float32, "cpu")
        return (llr / wlr).numpy(), (lhr / whr).numpy()
    logits, _ = tsw._run_sliding_window(fns[2], vol, PATCH, 1, 0.5, True,
                                        mirror, 2, torch.float32,
                                        device="cpu")
    weights, _ = tsw._run_sliding_window(ones, vol, PATCH, 1, 0.5, True,
                                         mirror, 1, torch.float32,
                                         device="cpu")
    return (logits / weights).numpy()


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("z_slab", [1, 2, 3])
def test_streamed_labels_match_jax(fns, params, vol, z_slab, mirror):
    want = jsw.predict_sliding_window_labels_streamed(
        fns[0], params, vol, PATCH, z_slab_tiles=z_slab, mirror=mirror,
        input_dtype=jnp.float32)
    got = tsw.predict_sliding_window_labels_streamed(
        fns[2], vol, PATCH, z_slab_tiles=z_slab, mirror=mirror, **F32)
    _labels_agree(got, want, _whole_logits(fns, vol, mirror, False))


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("z_slab", [1, 2, 3])
def test_streamed_dual_labels_match_jax(fns, params, vol, z_slab, mirror):
    want_lr, want_hr = jsw.predict_sliding_window_dual_labels_streamed(
        fns[1], params, vol, PATCH, slice_separation=4, z_slab_tiles=z_slab,
        mirror=mirror, input_dtype=jnp.float32)
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels_streamed(
        fns[3], vol, PATCH, slice_separation=4, z_slab_tiles=z_slab,
        mirror=mirror, **F32)
    assert got_hr.shape == (4 * VOLUME[0],) + VOLUME[1:]
    llr, lhr = _whole_logits(fns, vol, mirror, True)
    _labels_agree(got_lr, want_lr, llr)
    _labels_agree(got_hr, want_hr, lhr)


@pytest.mark.parametrize("z_slab", [1, 2, 3])
def test_streamed_matches_whole_volume_engine(fns, vol, z_slab,
                                              monkeypatch):
    """The port's streamed labels against its whole-volume engines: equal
    outside near-ties, LR and dual; K1 engages once per tile (16)."""
    engaged = []
    orig = pconv.pconv_pad11_cat

    def spy(*a, **k):
        y = orig(*a, **k)
        engaged.append(y is not None)
        return y

    monkeypatch.setattr(pconv, "pconv_pad11_cat", spy)
    n_tiles = len(tsw.sliding_window_starts(VOLUME, PATCH))
    assert n_tiles == 16
    lr = tsw.predict_sliding_window_labels_streamed(
        fns[2], vol, PATCH, z_slab_tiles=z_slab, mirror=False, **F32)
    assert engaged == [True] * n_tiles
    whole = tsw.predict_sliding_window_labels(fns[2], vol, PATCH,
                                              mirror=False, **F32)
    _labels_agree(lr, whole, _whole_logits(fns, vol, False, False))
    engaged.clear()
    got_lr, got_hr = tsw.predict_sliding_window_dual_labels_streamed(
        fns[3], vol, PATCH, slice_separation=4, z_slab_tiles=z_slab,
        mirror=False, **F32)
    assert engaged == [True] * n_tiles
    want_lr, want_hr = tsw.predict_sliding_window_dual_labels(
        fns[3], vol, PATCH, slice_separation=4, mirror=False, **F32)
    llr, lhr = _whole_logits(fns, vol, False, True)
    _labels_agree(got_lr, want_lr, llr)
    _labels_agree(got_hr, want_hr, lhr)


@pytest.mark.parametrize("image,z_slab", [((10, 24, 24), 3),
                                          ((20, 455, 633), 1),
                                          ((17, 30, 20), 3)])
def test_slabs_carry_the_whole_volumes_grid(image, z_slab):
    """Each slab's rows, shifted back by z_lo, are the whole volume's
    parity-grid starts, each once; a grid computed on the slab's own shape
    would not be: (17, 30, 20)'s z-starts are 0, 2, 4, 6, 7, 9, 11, 13, and
    the slab of 6, 7, 9 would get 6, 8, 9 from its own shape."""
    patch = PATCH if image[1] < 300 else (16, 320, 384)
    rows = []
    for z_lo, z_hi, slab_rows in tsw._slabs(image, patch, 0.5, z_slab):
        assert all(0 <= r[0] and r[0] + patch[0] <= z_hi - z_lo
                   and r[3] == 1 for r in slab_rows)
        rows += [(r[0] + z_lo, r[1], r[2]) for r in slab_rows]
    np.testing.assert_array_equal(
        np.asarray(rows), tsw.sliding_window_starts(image, patch))
    if image == (17, 30, 20):
        z_lo, z_hi, slab_rows = list(tsw._slabs(image, patch, 0.5, 3))[1]
        assert z_lo == 6
        own = tsw.sliding_window_starts((z_hi - z_lo,) + image[1:], patch)
        assert sorted(map(tuple, own.tolist())) != sorted(
            r[:3] for r in slab_rows)


def _pair(params, **kw):
    jseg = JaxSegmenter(model=JaxSegModel(num_classes=2, upscale=4,
                                          arch=ARCH),
                        params=params, patch_size=PATCH, slice_separation=4,
                        compute_dtype=jnp.float32, **kw)
    tseg = Segmenter.from_flax(params, ARCH, PATCH, device="cpu",
                               compute_dtype=torch.float32, **kw)
    return jseg, tseg


def _agree(got, want, min_frac=0.999):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got == want) >= min_frac, np.mean(got == want)


@pytest.mark.parametrize("hr", [False, True])
def test_segmenter_streaming_matches_jax(params, hr):
    """Segmenter(streaming=2) of both packages on a volume padded to the
    patch and cropped back; labels agree on at least 99.9 % of voxels."""
    jseg, tseg = _pair(params, streaming=2)
    v = _blob_volume((9, 14, 20), np.random.default_rng(4))
    got, want = tseg.segment(v, hr=hr), jseg.segment(v, hr=hr)
    if hr:
        assert got[0].shape == (9, 14, 20) and got[1].shape == (36, 14, 20)
        _agree(got[0], want[0])
        _agree(got[1], want[1])
    else:
        assert got.shape == (9, 14, 20)
        _agree(got, want)


def test_segment_many_streaming_is_sequential_segment(params, monkeypatch):
    """Under streaming, segment_many is one streamed segment() per volume
    (the JAX fallback), in order."""
    _, tseg = _pair(params, streaming=1)
    vols = [_blob_volume((6, 16, 18), np.random.default_rng(5)),
            _blob_volume((5, 20, 16), np.random.default_rng(6))]
    calls = []
    orig = tsw.predict_sliding_window_labels_streamed

    def spy(*a, **k):
        calls.append(k["z_slab_tiles"])
        return orig(*a, **k)

    monkeypatch.setattr(tsw, "predict_sliding_window_labels_streamed", spy)
    many = tseg.segment_many(vols)
    assert calls == [1, 1]
    for v, got in zip(vols, many):
        np.testing.assert_array_equal(got, tseg.segment(v))


def test_streaming_refuses_the_aligned_grid(params):
    """As in the JAX package, tile_grid='aligned' does not compose with
    streaming; both raise ValueError."""
    with pytest.raises(ValueError, match="streaming"):
        _pair(params, streaming=2, tile_grid="aligned")[1]
    with pytest.raises(ValueError, match="streaming"):
        Segmenter(SegModel(2, 4, arch=ARCH), PATCH, streaming=2,
                  tile_grid="aligned", device="cpu")
