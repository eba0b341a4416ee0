"""The port's worker-process loader (``data.datasets.MultiprocessBatchLoader``)
against the JAX package's on the CPU: three batches byte-equal to JAX's
loader over the same dataset (the port's ``SegSRDataset``, which
tests/test_torch_datasets.py holds bit-equal to JAX's), seed and shard,
with 2 workers forked and with 1 worker spawned (``REHRSEG_MP_CONTEXT``),
and to ``BatchLoader(shard=(0, 1))``; a worker's exception surfaced in the
parent; a worker that dies reported by the liveness watchdog;
``pipeline._make_loader``'s choice under ``loader_workers``, the device
sampler and data parallelism."""

import os

import numpy as np
import pytest

from rehrseg_tpu.data.datasets import (
    MultiprocessBatchLoader as JaxMultiprocessBatchLoader)
from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.config import Config
from rehrseg_tpu_torch.data import datasets as tds
from rehrseg_tpu_torch.data.device_sampler import DeviceSRPatchSampler
from rehrseg_tpu_torch.parallel import multihost as mh
from tests.test_torch_datasets import PATCH_ORI, PATCH_XYZ, _volumes


@pytest.fixture(scope="module")
def dataset():
    return tds.SegSRDataset.from_volumes(
        _volumes(), 4.0, 1.0, PATCH_ORI, PATCH_XYZ, random_flip=True,
        uncertainty=True, device_augment=True)


def _batches(loader, n=3):
    try:
        return [loader.next() for _ in range(n)]
    finally:
        loader.close()


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_batches_equal_jax(dataset, shard):
    want = _batches(JaxMultiprocessBatchLoader(dataset, 4, num_workers=2,
                                               seed=5, shard=shard))
    got = _batches(tds.MultiprocessBatchLoader(dataset, 4, num_workers=2,
                                               seed=5, shard=shard))
    ref = tds.BatchLoader(dataset, 4, seed=5, shard=shard or (0, 1))
    for g, w in zip(got, want):
        _same(g, w)
        _same(g, ref.next())


def test_spawned_worker(dataset, monkeypatch):
    monkeypatch.setenv("REHRSEG_MP_CONTEXT", "spawn")
    got = _batches(tds.MultiprocessBatchLoader(dataset, 2, num_workers=1,
                                               seed=2), n=2)
    ref = tds.BatchLoader(dataset, 2, seed=2, shard=(0, 1))
    for g in got:
        _same(g, ref.next())


class _Failing:
    def sample(self, i=None, rng=None):
        raise ValueError("bad sample")


class _Dying:
    def sample(self, i=None, rng=None):
        os._exit(3)


def test_worker_errors_surface():
    loader = tds.MultiprocessBatchLoader(_Failing(), 2, num_workers=1)
    with pytest.raises(RuntimeError, match="ValueError: bad sample"):
        loader.next()
    loader.close()
    loader = tds.MultiprocessBatchLoader(_Dying(), 2, num_workers=1)
    with pytest.raises(RuntimeError, match=r"died \(exitcodes \[3\]\)"):
        loader.next()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next()


def _cfg(**extra):
    return Config(data_path="unused", tmp_path="unused",
                  checkpoint_path="unused", extra=extra)


def test_make_loader_choice(dataset, monkeypatch):
    """One process: the device sampler where the dataset fits it (a stage-2
    dataset does not); loader_workers > 0 the worker loader, else the
    prefetch thread. Data parallelism: no device sampler, each loader
    sharded by the process index."""
    from rehrseg_tpu_torch.infer.sr_infer import postprocess_sr_volume

    rng = np.random.default_rng(5)
    vols = []
    for _ in range(2):
        img = rng.uniform(size=(24, 24, 20, 1)).astype(np.float32)
        fx, fy = postprocess_sr_volume(img, 3.87)
        vols.append((img, (img > 0.6).astype(np.uint8), fx, fy))
    sr = tds.SRPatchDataset.from_volumes(vols, 4.0, 1.0, (9, 12, 12), True,
                                         device_lr_sim=True)
    loader = pipeline._make_loader(_cfg(loader_workers=2), sr, 2, "cpu")
    assert isinstance(loader, DeviceSRPatchSampler)
    for extra, kind in (({"loader_workers": 2},
                         tds.MultiprocessBatchLoader),
                        ({}, tds.PrefetchLoader)):
        loader = pipeline._make_loader(_cfg(**extra), dataset, 2, "cpu")
        assert isinstance(loader, kind)
        assert set(loader.next()) == {"img", "label_lr", "label_hr",
                                      "uncertainty_lr"}
        loader.close()
    loader = pipeline._make_loader(
        _cfg(loader_workers=1, device_sampler=False), sr, 2, "cpu")
    assert isinstance(loader, tds.MultiprocessBatchLoader)
    loader.close()
    monkeypatch.setattr(mh, "is_multihost", lambda: True)
    monkeypatch.setattr(mh, "data_shard", lambda: (1, 2))
    loader = pipeline._make_loader(_cfg(), sr, 2, "cpu")
    assert isinstance(loader, tds.PrefetchLoader)
    assert loader.loader.shard == (1, 2)
    loader.close()
    loader = pipeline._make_loader(_cfg(loader_workers=1), sr, 2, "cpu")
    assert loader.shard == (1, 2)
    (lr, hr) = loader.next()
    assert lr.shape[0] == 1
    loader.close()
    np.testing.assert_array_equal(
        lr, tds.BatchLoader(sr, 2, shard=(1, 2)).next()[0])
