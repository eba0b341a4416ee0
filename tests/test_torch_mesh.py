"""The port's TTA-sharded engine and ``Segmenter(mesh=)`` against the JAX
package's ``tta_mesh`` on the CPU, at SMALL_ARCH and fp32: a mesh of 2 and
of 8 devices (one CPU named several times, as XLA's forced host device
count names it for JAX) against JAX's ``predict_sliding_window_labels(
tta_mesh=make_mesh(8))`` on the same bridged weights, labels equal
wherever the reference logit margin is >= 1e-3 (the engine tests' rule);
the meshed port against the unmeshed port; the Segmenter's ValueErrors
against JAX's; ``make_mesh(spatial=)`` giving JAX's (data, spatial) grid.
The spatial axis's engines are tests/test_torch_spatial.py's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models.segnet_packed import (
    segmodel_apply_packed as jax_packed)
from rehrseg_tpu.parallel import make_mesh as jax_make_mesh
from rehrseg_tpu.parallel import replicate
from rehrseg_tpu.serve import Segmenter as JaxSegmenter
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.parallel.mesh import Mesh, make_mesh
from rehrseg_tpu_torch.serve import Segmenter
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH
from tests.test_torch_engine import _labels_agree

torch.set_num_threads(2)

PATCH = (4, 16, 16)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(SMALL_ARCH, 3)


def _cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def _port_fn(params, seen=None):
    """The packed LR forward as a port model_fn; ``seen`` collects each
    call's batch size and device."""
    tparams = convert.tree_to_torch(params)

    def fn(batch):
        if seen is not None:
            seen.append((batch.shape[0], batch.device))
        return segmodel_apply_packed(SMALL_ARCH, tparams, batch,
                                     pack_max_channels=64)
    return fn


def test_meshed_engine_matches_jax_tta_mesh(params):
    """JAX's labels on its 8-device mesh, the port's on meshes of 2 and 8;
    the port's unmeshed logits give the margin."""
    assert len(jax.devices()) == 8
    vol = _blob_volume((6, 24, 24), np.random.default_rng(0))[..., None]

    def jfn(p, b):
        return jax_packed(SMALL_ARCH, p, b, pack_max_channels=64)

    jmesh = jax_make_mesh(8)
    with jmesh:
        want = jsw.predict_sliding_window_labels(
            jfn, replicate(params, jmesh), vol, PATCH,
            input_dtype=jnp.float32, tta_mesh=jmesh)
    logits = tsw.predict_sliding_window_logits(
        _port_fn(params), vol, PATCH, input_dtype=torch.float32,
        device="cpu")
    _labels_agree(np.argmax(logits, -1), want, logits)
    n_tiles = len(tsw.sliding_window_starts(vol.shape[:3], PATCH))
    for n in (2, 8):
        seen = []
        got = tsw.predict_sliding_window_labels(
            _port_fn(params, seen), vol, PATCH, input_dtype=torch.float32,
            tta_mesh=_cpu_mesh(n))
        _labels_agree(got, want, logits)
        # one forward per block: n blocks of 8 / n flips per tile
        assert seen == [(8 // n, CPU)] * (n * n_tiles)


def test_meshed_engine_matches_unmeshed(params):
    """Logits of the meshed engine against the unmeshed one (the same
    forwards on smaller batches): 1e-5; tiles_per_step 2 splits 16."""
    vol = _blob_volume((6, 24, 16), np.random.default_rng(1))[..., None]
    fn = _port_fn(params)
    kw = dict(input_dtype=torch.float32, device="cpu")
    want = tsw.predict_sliding_window_logits(fn, vol, PATCH, **kw)
    for mesh, k in ((_cpu_mesh(2), 1), (_cpu_mesh(4), 2),
                    (make_mesh(devices=[CPU]), 1)):
        got = tsw.predict_sliding_window_logits(
            fn, vol, PATCH, tiles_per_step=k, tta_mesh=mesh, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mesh_must_divide_the_mirror_batch(params):
    vol = _blob_volume((6, 24, 16), np.random.default_rng(1))[..., None]
    with pytest.raises(ValueError, match="'data' axis of 3"):
        tsw.predict_sliding_window_labels(
            _port_fn(params), vol, PATCH, input_dtype=torch.float32,
            tta_mesh=_cpu_mesh(3))


def test_segmenter_mesh_matches_unmeshed(params):
    """Segmenter(mesh=) on the LR parity path, segment_many over the mesh,
    the mesh's first device as the Segmenter's, one weight replica for a
    device named twice."""
    kw = dict(compute_dtype=torch.float32)
    plain = Segmenter.from_flax(params, SMALL_ARCH, PATCH, device="cpu",
                                **kw)
    meshed = Segmenter.from_flax(params, SMALL_ARCH, PATCH,
                                 mesh=_cpu_mesh(2), **kw)
    assert meshed.device == CPU
    vols = [_blob_volume((6, 24, 16), np.random.default_rng(s))
            for s in (2, 3)]
    vol_p, _ = plain._prep(vols[0])
    logits = tsw.predict_sliding_window_logits(
        plain._fn(False), vol_p, PATCH, input_dtype=torch.float32,
        device="cpu")
    got = meshed.segment(vols[0])
    _labels_agree(got, plain.segment(vols[0]), logits)
    many = meshed.segment_many(vols)
    np.testing.assert_array_equal(many[0], got)
    assert len(meshed._replicas) == 1
    lr, hr = meshed.segment(vols[1], hr=True)
    want_lr, want_hr = plain.segment(vols[1], hr=True)
    np.testing.assert_array_equal(lr, want_lr)
    np.testing.assert_array_equal(hr, want_hr)
    with pytest.raises(ValueError, match="first device"):
        Segmenter.from_flax(params, SMALL_ARCH, PATCH, mesh=_cpu_mesh(2),
                            device="meta", **kw)


def test_segmenter_mesh_errors_match_jax(params):
    """Mesh with streaming, and mesh with the aligned grid: the same
    ValueError, word for word, as the JAX Segmenter's."""
    jmodel = JaxSegModel(num_classes=2, upscale=4, arch=SMALL_ARCH)
    model = SegModel(2, 4, arch=SMALL_ARCH)
    jmesh = jax_make_mesh(8)
    for kw in (dict(streaming=2), dict(tile_grid="aligned")):
        with pytest.raises(ValueError) as want:
            JaxSegmenter(model=jmodel, params=params, patch_size=PATCH,
                         mesh=jmesh, **kw)
        with pytest.raises(ValueError) as got:
            Segmenter(model, PATCH, mesh=_cpu_mesh(2), **kw)
        assert str(got.value) == str(want.value)


def test_spatial_axis_raises_naming_10c(params):
    """The name is the one this test had while a 'spatial' axis raised;
    it now checks that ``make_mesh(spatial=)`` builds JAX's grid (device
    i at row i // spatial, column i % spatial) and that the meshed engine
    and Segmenter take it, while a count the axis does not divide still
    raises JAX's ValueError."""
    names = [torch.device("cpu", i) for i in range(8)]
    for n, spatial in ((8, 2), (4, 4), (8, 1)):
        mesh = make_mesh(n, spatial=spatial, devices=names)
        jmesh = jax_make_mesh(n, spatial=spatial)
        assert mesh.shape == dict(jmesh.shape)
        assert [[d.index for d in row] for row in mesh.devices] == \
            [[d.id for d in row] for row in jmesh.devices]
        assert mesh.groups() == mesh.devices
        assert mesh.data_devices == [row[0] for row in mesh.devices]
    with pytest.raises(ValueError, match="must divide") as got:
        make_mesh(devices=[CPU] * 3, spatial=2)
    with pytest.raises(ValueError, match="must divide") as want:
        jax_make_mesh(3, spatial=2)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    spatial = Mesh([[CPU, CPU]])
    assert spatial.shape == {"data": 1, "spatial": 2}
    vol = np.zeros((4, 16, 16, 1), np.float32)
    assert tsw.predict_sliding_window_labels(
        _port_fn(params), vol, PATCH, tta_mesh=spatial).shape == (4, 16, 16)
    assert Segmenter(SegModel(2, 4, arch=SMALL_ARCH), PATCH,
                     mesh=spatial).device == CPU


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    """No devices named: every visible card; none visible raises rather
    than building a mesh on the CPU; more devices asked than exist
    raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.shape == {"data": 2, "spatial": 1}
    assert mesh.data_devices == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="3 devices asked for"):
        make_mesh(3)
