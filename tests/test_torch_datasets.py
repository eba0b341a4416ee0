"""The port's stage-2 data path against the JAX package's, on the CPU:
``SegSRDataset.sample`` bit-equal to JAX's at the same
``np.random.default_rng`` seed, with the device augmentation on (raw crops)
and off (the host transform chain), with and without uncertainty and
flips, from HDF5 stores written by one package and read by the other;
``from_volumes`` equal to the store-reading constructor; ``BatchLoader``
(also sharded) and ``PrefetchLoader`` batches in the same order as JAX's;
the HDF5 helpers; and a store refused with an ImportError naming h5py
where h5py cannot be imported."""

import sys

import numpy as np
import pytest

from rehrseg_tpu.data import datasets as jds
from rehrseg_tpu.data import transforms as jtr
from rehrseg_tpu.io import volume as jvolume
from rehrseg_tpu_torch.data import datasets as tds
from rehrseg_tpu_torch.data import transforms as ttr
from rehrseg_tpu_torch.io import volume as tvolume

SUBJECTS = ["sub_a", "sub_b", "sub_c"]
PATCH_XYZ = (16, 16, 4)
PATCH_ORI = (24, 20, 4)


def _volumes(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate([(40, 36, 24), (30, 28, 20), (20, 18, 12)]):
        img = rng.normal(size=shape).astype(np.float32) * (i + 1) + i
        seg = (rng.uniform(size=shape) > 0.6).astype(np.float32)
        unc = rng.uniform(0, 255, size=shape).astype(np.float32)
        out.append((img, seg, unc))
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{writer: directory} of the same volumes written as HDF5 stores by
    each package (the third subject with the ``_0000`` suffix)."""
    vols = _volumes()
    dirs = {}
    for name, mod in (("jax", jvolume), ("port", tvolume)):
        d = tmp_path_factory.mktemp(f"h5_{name}")
        for s, (img, seg, unc) in zip(SUBJECTS, vols):
            fname = s + ("_0000.h5" if s == "sub_c" else ".h5")
            mod.write_h5(str(d / fname), img=img, seg=seg, uncertainty=unc)
        dirs[name] = str(d)
    return dirs


def _kw(uncertainty, flip, device_augment):
    return dict(random_flip=flip, uncertainty=uncertainty,
                device_augment=device_augment)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("device_augment", [False, True])
@pytest.mark.parametrize("uncertainty,flip", [(True, True), (False, False)])
def test_sample_bit_equal(stores, device_augment, uncertainty, flip):
    """Samples equal bit for bit: the port reading JAX's stores against JAX
    reading the port's, at the same seeds."""
    kw = _kw(uncertainty, flip, device_augment)
    tset = tds.SegSRDataset(stores["jax"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, seed=3, **kw)
    jset = jds.SegSRDataset(stores["port"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, seed=3, **kw)
    assert len(tset) == len(jset) == 3
    for i in range(6):
        t, j = tset.sample(), jset.sample()
        _assert_same(t, j)
        assert t["img"].shape == ((4, 24, 20, 1) if device_augment
                                  else (4, 16, 16, 1))
        assert t["label_hr"].shape[0] == 16
        if i < 3:
            _assert_same(tset.sample(i, np.random.default_rng(i)),
                         jset.sample(i, np.random.default_rng(i)))


def test_lazy_stores_bit_equal(stores):
    """preload=False keeps store handles and normalizes per draw."""
    kw = _kw(True, True, False)
    tset = tds.SegSRDataset(stores["jax"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, preload=False, seed=5, **kw)
    jset = jds.SegSRDataset(stores["jax"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, preload=False, seed=5, **kw)
    for _ in range(3):
        _assert_same(tset.sample(), jset.sample())


@pytest.mark.parametrize("uncertainty", [True, False])
def test_from_volumes_equals_the_stores(stores, uncertainty):
    kw = _kw(uncertainty, True, True)
    vols = [(i, s, u if uncertainty else None) for i, s, u in _volumes()]
    a = tds.SegSRDataset.from_volumes(vols, 4.0, 1.0, PATCH_ORI, PATCH_XYZ,
                                      seed=2, **kw)
    b = tds.SegSRDataset(stores["port"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                         PATCH_XYZ, seed=2, **kw)
    for _ in range(4):
        _assert_same(a.sample(), b.sample())


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_batch_loaders_keep_the_order(stores, shard):
    kw = _kw(True, True, False)
    tset = tds.SegSRDataset(stores["port"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, **kw)
    jset = jds.SegSRDataset(stores["port"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                            PATCH_XYZ, **kw)
    tl = tds.BatchLoader(tset, 4, seed=1, shard=shard)
    jl = jds.BatchLoader(jset, 4, seed=1, shard=shard)
    want = [jl.next() for _ in range(3)]
    for w in want:
        _assert_same(tl.next(), w)
        assert w["img"].shape[0] == (2 if shard else 4)
    # the prefetch thread keeps the wrapped loader's order
    tl2 = tds.PrefetchLoader(tds.BatchLoader(
        tds.SegSRDataset(stores["port"], SUBJECTS, 4.0, 1.0, PATCH_ORI,
                         PATCH_XYZ, **kw), 4, seed=1, shard=shard))
    try:
        for w in want:
            _assert_same(tl2.next(), w)
    finally:
        tl2.close()
    with pytest.raises(RuntimeError, match="closed"):
        tl2.next()


def test_shard_checks():
    with pytest.raises(ValueError, match="divisible"):
        tds.BatchLoader(None, 3, shard=(0, 2))
    with pytest.raises(ValueError, match="out of range"):
        tds.BatchLoader(None, 4, shard=(2, 2))


def test_prefetch_surfaces_errors_and_keeps_serving():
    class Flaky:
        n = 0

        def next(self):
            self.n += 1
            if self.n == 2:
                raise OSError("transient")
            return self.n

    loader = tds.PrefetchLoader(Flaky(), depth=1)
    try:
        assert loader.next() == 1
        with pytest.raises(OSError, match="transient"):
            loader.next()
        assert loader.next() == 3
    finally:
        loader.close()


def test_transforms_copy_matches_jax():
    """The port's own TrainingTransforms draws and computes as JAX's."""
    rng = np.random.default_rng(4)
    d = {"data": rng.normal(size=(1, 3, 20, 18)).astype(np.float32),
         "seg": (rng.uniform(size=(1, 3, 20, 18)) > 0.5).astype(np.float32),
         "uncertainty": rng.uniform(size=(1, 3, 20, 18)).astype(np.float32)}
    kw = dict(enable_uncertainty=True, extra_keys=["seg", "uncertainty"])
    for seed in range(6):
        t = ttr.TrainingTransforms((3, 12, 10), **kw)(
            np.random.default_rng(seed), **d)
        j = jtr.TrainingTransforms((3, 12, 10), **kw)(
            np.random.default_rng(seed), **d)
        _assert_same(t, j)


def test_h5_helpers_and_refusal_without_h5py(tmp_path, monkeypatch):
    path = str(tmp_path / "v.h5")
    tvolume.write_h5(path, a=np.arange(4.0), b=np.ones((2, 2)))
    store = tvolume.H5Store(path)
    assert sorted(store.keys()) == ["a", "b"]
    assert store["b"].shape == (2, 2) and store["b"].ndim == 2
    np.testing.assert_array_equal(store["a"].read(), np.arange(4.0))
    np.testing.assert_array_equal(store["a"][1:3], [1.0, 2.0])
    assert store["a"][...] is not None
    a, b = jvolume.read_h5(path, "a", "b")
    np.testing.assert_array_equal(b, np.ones((2, 2)))
    np.testing.assert_array_equal(tvolume.read_h5(path, "a")[0], a)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tds.SegSRDataset(str(tmp_path), ["v"], 4.0, 1.0, PATCH_ORI,
                         PATCH_XYZ)
    with pytest.raises(ImportError, match="h5py"):
        tvolume.read_h5(path, "a")
