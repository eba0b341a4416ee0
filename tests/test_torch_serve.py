"""The port's Segmenter against the JAX Segmenter with the same weights at
fp32 (segment, segment(hr=True), segment_many, both tile grids), plus the
port's two structural rules: it imports no JAX and nothing of the JAX
package, and it never runs on the CPU unless asked to."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.serve import Segmenter as JaxSegmenter
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.parallel.mesh import Mesh, make_mesh
from rehrseg_tpu_torch.serve import Segmenter
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

PATCH = (4, 16, 16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(SMALL_ARCH, 5)


def _pair(params, **kw):
    """(JAX Segmenter, port Segmenter) over the same weights, fp32."""
    jseg = JaxSegmenter(model=JaxSegModel(num_classes=2, upscale=4,
                                          arch=SMALL_ARCH),
                        params=params, patch_size=PATCH, slice_separation=4,
                        compute_dtype=jnp.float32, **kw)
    tseg = Segmenter.from_flax(params, SMALL_ARCH, PATCH, device="cpu",
                               compute_dtype=torch.float32, **kw)
    return jseg, tseg


def _agree(got, want, max_frac=1e-3):
    """Label maps equal but for near-tie voxels (fp32 summation order):
    at most ``max_frac`` of the voxels."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got != want) <= max_frac, np.mean(got != want)


def _vol(shape, seed):
    return _blob_volume(shape, np.random.default_rng(seed))


@pytest.mark.parametrize("tile_grid", ["parity", "aligned"])
def test_segment_matches_jax(params, tile_grid):
    jseg, tseg = _pair(params, tile_grid=tile_grid)
    vol = _vol((6, 24, 16), 0)
    _agree(tseg.segment(vol), jseg.segment(vol))


@pytest.mark.parametrize("tile_grid", ["parity", "aligned"])
def test_segment_hr_matches_jax(params, tile_grid):
    jseg, tseg = _pair(params, tile_grid=tile_grid)
    vol = _vol((5, 20, 16), 1)       # padded to the patch and cropped back
    lr, hr = tseg.segment(vol, hr=True)
    want_lr, want_hr = jseg.segment(vol, hr=True)
    assert lr.shape == (5, 20, 16) and hr.shape == (20, 20, 16)
    _agree(lr, want_lr)
    _agree(hr, want_hr)


@pytest.mark.parametrize("tile_grid", ["parity", "aligned"])
def test_segment_many_matches_jax_and_single(params, tile_grid):
    jseg, tseg = _pair(params, tile_grid=tile_grid)
    vols = [_vol((5, 20, 16), 2), _vol((6, 16, 24), 3)]
    many = tseg.segment_many(vols)
    for v, got, want in zip(vols, many, jseg.segment_many(vols)):
        _agree(got, want)
        np.testing.assert_array_equal(got, tseg.segment(v))


def test_segment_hr_pallas_all_matches_jax(monkeypatch):
    """Segmenter(pallas_conv=True) on the aligned grid against the JAX
    Segmenter (its served "cat" forward, the same math), at an arch whose
    packed stages take K3 and K5."""
    from rehrseg_tpu_torch.ops import pconv

    arch = dict(SMALL_ARCH, features_per_stage=(32, 64, 64, 64))
    params = convert.random_flax_params(arch, 6)
    patch = (4, 16, 128)
    engaged = []
    for name in ("pconv_valid", "pconv3_valid"):
        orig = getattr(pconv, name)

        def spy(*a, _orig=orig, _name=name, **k):
            engaged.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(pconv, name, spy)
    jseg = JaxSegmenter(model=JaxSegModel(num_classes=2, upscale=4,
                                          arch=arch),
                        params=params, patch_size=patch, slice_separation=4,
                        compute_dtype=jnp.float32, tile_grid="aligned")
    tseg = Segmenter.from_flax(params, arch, patch, device="cpu",
                               compute_dtype=torch.float32,
                               tile_grid="aligned", pallas_conv=True)
    vol = _vol((6, 24, 128), 6)
    lr, hr = tseg.segment(vol, hr=True)
    assert {"pconv_valid", "pconv3_valid"} <= set(engaged)
    want_lr, want_hr = jseg.segment(vol, hr=True)
    _agree(lr, want_lr)
    _agree(hr, want_hr)


def test_segment_hr_fused_matches_jax(monkeypatch):
    """Segmenter(pallas_conv="fused") on the aligned grid against the JAX
    Segmenter (its served "cat" forward, the same math), at an arch whose
    packed stages defer their norms: K6a at the decoder concat, K6b and
    K6c consuming the deferred norms on every tile."""
    from rehrseg_tpu_torch.ops import pconv

    arch = dict(SMALL_ARCH, features_per_stage=(32, 64, 64, 64))
    params = convert.random_flax_params(arch, 7)
    patch = (4, 16, 128)
    engaged = []
    for name in ("pconv_pad11_cat", "pconv_valid", "pconv3_valid"):
        orig = getattr(pconv, name)

        def spy(*a, _orig=orig, _name=name, **k):
            y = _orig(*a, **k)
            if y is not None and k.get("want_stats"):
                engaged.append(_name)
            return y

        monkeypatch.setattr(pconv, name, spy)
    jseg = JaxSegmenter(model=JaxSegModel(num_classes=2, upscale=4,
                                          arch=arch),
                        params=params, patch_size=patch, slice_separation=4,
                        compute_dtype=jnp.float32, tile_grid="aligned")
    tseg = Segmenter.from_flax(params, arch, patch, device="cpu",
                               compute_dtype=torch.float32,
                               tile_grid="aligned", pallas_conv="fused")
    vol = _vol((6, 24, 128), 8)
    lr, hr = tseg.segment(vol, hr=True)
    assert {"pconv_pad11_cat", "pconv_valid", "pconv3_valid"} <= set(engaged)
    want_lr, want_hr = jseg.segment(vol, hr=True)
    _agree(lr, want_lr)
    _agree(hr, want_hr)


def test_unpacked_eval_matches_jax(params):
    jseg, tseg = _pair(params, packed_eval=False, mirror=False)
    vol = _vol((6, 24, 24), 4)
    _agree(tseg.segment(vol), jseg.segment(vol))


def test_aligned_serves_parity_where_it_cannot_cover(params):
    """A patch narrower than the 128 W-snap on a multi-tile W axis: the
    aligned grid refuses, so the volume is served on the parity grid."""
    _, aligned = _pair(params, tile_grid="aligned")
    _, parity = _pair(params)
    vol = _vol((6, 20, 40), 5)
    assert not aligned._aligned_ok((6, 20, 40))
    np.testing.assert_array_equal(aligned.segment(vol), parity.segment(vol))


def test_constructor_errors(params):
    model = SegModel(2, 4, arch=SMALL_ARCH)
    with pytest.raises(ValueError, match="tile_grid"):
        Segmenter(model, PATCH, tile_grid="diagonal", device="cpu")
    with pytest.raises(ValueError, match="aligned"):
        Segmenter(model, PATCH, tile_grid="aligned", mirror=False,
                  device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        Segmenter(model, PATCH, tile_grid="aligned", streaming=2,
                  device="cpu")
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="do not compose"):
        Segmenter(model, PATCH, mesh=mesh, streaming=2)
    with pytest.raises(ValueError, match="mesh sharding"):
        Segmenter(model, PATCH, mesh=mesh, tile_grid="aligned")
    # a spatial mesh builds; the port-only modes have no spatial form
    spatial = Mesh([[torch.device("cpu")] * 2])
    assert Segmenter(model, PATCH, mesh=spatial).mesh is spatial
    for mode in (True, "fused"):
        with pytest.raises(ValueError, match="no spatial form"):
            Segmenter(model, PATCH, mesh=spatial, pallas_conv=mode)
    assert Segmenter(model, PATCH, mesh=mesh, pallas_conv="fused").mesh \
        is mesh
    assert Segmenter(model, PATCH, device="cpu", streaming=2).streaming == 2


def test_segmenter_never_silently_uses_the_cpu(monkeypatch):
    """Without a card and without device="cpu", construction raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Segmenter(SegModel(2, 4, arch=SMALL_ARCH), PATCH)


def test_port_imports_no_jax():
    """Importing every module of the port (39 today) leaves no jax, no
    flax, no rehrseg_tpu / rehrseg_tpu.*, no pyyaml, no orbax and no h5py
    module loaded."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import rehrseg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'rehrseg_tpu', 'yaml', 'orbax', 'h5py')]\n"
        "n = sum(1 for m in sys.modules if m.startswith('rehrseg_tpu_torch'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 39 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
