"""The port's tracing (``rehrseg_tpu_torch.utils.timer``): spans that are
one shared null context with no profiler running and ``record_function``
ranges inside one, nested and carrying their request id; the counters and
the kernels' launch counts; the serving, stage-1, stage-2 and loader spans
and counters of toy runs on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rehrseg_tpu_torch.data.datasets import (BatchLoader, PrefetchLoader,
                                             SRPatchDataset)
from rehrseg_tpu_torch.data.device_aug import augment_sr_hr_batch
from rehrseg_tpu_torch.data.device_sampler import DeviceSRPatchSampler
from rehrseg_tpu_torch.data.device_sr_sim import simulate_lr_batch
from rehrseg_tpu_torch.infer import sliding_window as sw
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.ops.pconv import pconv_pad11_cat
from rehrseg_tpu_torch.ops.tail import accumulate_tta_tile
from rehrseg_tpu_torch.serve import Segmenter
from rehrseg_tpu_torch.train import optim
from rehrseg_tpu_torch.train import seg_trainer as tst
from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step
from rehrseg_tpu_torch.train.state import TrainState
from rehrseg_tpu_torch.utils import timer
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

PATCH = (4, 16, 16)
SERVING = {"rehrseg.segment", "rehrseg.segment.prep",
           "rehrseg.segment.upload", "rehrseg.segment.tile",
           "rehrseg.segment.mirror", "rehrseg.segment.forward",
           "rehrseg.segment.accumulate", "rehrseg.segment.argmax",
           "rehrseg.segment.fetch", "rehrseg.segment.crop",
           "rehrseg.segnet.encoder", "rehrseg.segnet.norm_act"}


def _traced(fn):
    """(fn's result, its host events with parents, the counters' change)
    of one call under the CPU profiler, which keeps the spans' inputs."""
    before = timer.counters()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    after = timer.counters()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return out, [e for e in prof.events() if e.name.startswith("rehrseg.")], \
        moved


def _parent(e):
    """The nearest enclosing ``rehrseg.*`` span of ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("rehrseg."):
        p = p.cpu_parent
    return p.name if p is not None else None


def test_span_off_is_one_null_context(monkeypatch):
    def refuse(*a):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = timer.span("rehrseg.a"), timer.span("rehrseg.b", request=3)
    assert a is b is timer._NULL
    with timer.span("rehrseg.a", request=3):
        pass


def test_span_on_nests_and_carries_the_request_id():
    def work():
        with timer.span("rehrseg.outer", request=41):
            with timer.span("rehrseg.inner"):
                torch.ones(3).add_(1)
            with timer.span("rehrseg.inner"):
                pass

    _, events, _ = _traced(work)
    outer = [e for e in events if e.name == "rehrseg.outer"]
    inner = [e for e in events if e.name == "rehrseg.inner"]
    assert len(outer) == 1 and len(inner) == 2
    assert outer[0].concrete_inputs == [41]
    assert all(_parent(e) == "rehrseg.outer" for e in inner)
    assert all(e.is_user_annotation for e in events)
    assert outer[0].time_range.start <= inner[0].time_range.start
    assert inner[1].time_range.end <= outer[0].time_range.end


def test_count_and_counters(monkeypatch):
    base = timer.counters().get("test.things", 0)
    assert timer.count("test.things") == base + 1
    assert timer.count("test.things", 4) == base + 5
    snap = timer.counters()
    timer.count("test.things")
    assert snap["test.things"] == base + 5
    monkeypatch.setattr(accumulate_tta_tile, "launches", 7)
    monkeypatch.setattr(pconv_pad11_cat, "launches", 5)
    monkeypatch.setattr(pconv_pad11_cat, "fused_launches", 2)
    got = timer.counters()
    assert (got["k1.launches"], got["k2.launches"], got["k6a.launches"]) \
        == (5, 7, 2)
    assert {f"k{k}.launches" for k in
            ("1", "2", "3", "4", "5", "6a", "6b", "6c", "7")} <= set(got)


@pytest.fixture(scope="module")
def segmenters():
    params = convert.random_flax_params(SMALL_ARCH, 5)
    return {grid: Segmenter.from_flax(params, SMALL_ARCH, PATCH,
                                      device="cpu",
                                      compute_dtype=torch.float32,
                                      tile_grid=grid)
            for grid in ("parity", "aligned")}


def _volume(shape, seed):
    return np.random.default_rng(seed).normal(100, 20, shape).astype(
        np.float32)


def _tiles(grid, shape):
    padded = tuple(max(s, p) for s, p in zip(shape, PATCH))
    if grid == "aligned":
        return len(sw.aligned_sliding_window_starts(padded, PATCH)[0])
    return len(sw.sliding_window_starts(padded, PATCH))


@pytest.mark.parametrize("hr", [False, True])
@pytest.mark.parametrize("grid", ["parity", "aligned"])
def test_segment_spans_and_counters(segmenters, grid, hr):
    vol = _volume((6, 24, 16), 0)
    _, events, moved = _traced(lambda: segmenters[grid].segment(vol, hr=hr))
    names = {e.name for e in events}
    assert names == SERVING
    req = [e for e in events if e.name == "rehrseg.segment"]
    assert len(req) == 1 and _parent(req[0]) is None
    assert req[0].concrete_inputs == [timer.counters()["serve.volumes"]]
    tiles = [e for e in events if e.name == "rehrseg.segment.tile"]
    assert len(tiles) == _tiles(grid, vol.shape)
    for e in events:
        if e.name in ("rehrseg.segment.mirror", "rehrseg.segment.forward",
                      "rehrseg.segment.accumulate"):
            assert _parent(e) == "rehrseg.segment.tile"
        elif e.name == "rehrseg.segnet.encoder":
            assert _parent(e) == "rehrseg.segment.forward"
        elif e.name == "rehrseg.segnet.norm_act":
            assert _parent(e) in ("rehrseg.segnet.encoder",
                                  "rehrseg.segment.forward")
        elif e.name != "rehrseg.segment":
            assert _parent(e) == "rehrseg.segment", e.name
    assert moved["serve.volumes"] == 1
    assert moved["serve.tiles"] == _tiles(grid, vol.shape)
    assert "serve.aligned_fallbacks" not in moved


def test_segment_aligned_fallback_is_counted(segmenters):
    vol = _volume((6, 24, 40), 1)      # W takes 3 tiles of 16 < its snap
    _, _, moved = _traced(lambda: segmenters["aligned"].segment(vol))
    assert moved["serve.aligned_fallbacks"] == 1
    assert moved["serve.tiles"] == _tiles("parity", vol.shape)


@pytest.mark.parametrize("grid", ["parity", "aligned"])
def test_segment_many_one_request_a_volume(segmenters, grid):
    vols = [_volume((6, 24, 16), 2), _volume((5, 16, 16), 3)]
    many, events, moved = _traced(
        lambda: segmenters[grid].segment_many(vols))
    req = [e for e in events if e.name == "rehrseg.segment"]
    assert len(req) == 2
    assert [e.name for e in events].count("rehrseg.segment.fetch") == 1
    assert moved["serve.volumes"] == 2
    assert moved["serve.tiles"] == sum(_tiles(grid, v.shape) for v in vols)
    for v, m in zip(vols, many):
        np.testing.assert_array_equal(m, segmenters[grid].segment(v))


def _sampler(batch):
    """A DeviceSRPatchSampler on the CPU over two small seeded stores,
    and the FLAVR model its batches feed."""
    rng = np.random.default_rng(0)
    model = UNet3D(2, 4, 4)
    patch = model.calc_out_patch_size([4, 16, 16])
    vols = []
    for _ in range(2):
        img = rng.uniform(size=(24, 20, 18)).astype(np.float32)
        lab = (img > 0.5).astype(np.float32)
        vols.append((img[..., None], lab[..., None],
                     img.transpose(2, 0, 1)[:, None],
                     img.transpose(2, 1, 0)[:, None]))
    ds = SRPatchDataset.from_volumes(vols, 4.0, 1.0, patch, True, blur=True,
                                     nnunet_transform=False,
                                     device_lr_sim=True, channels=2)
    return DeviceSRPatchSampler(ds, batch, seed=1, device="cpu"), model


def test_sr_step_spans_and_counters():
    loader, model = _sampler(batch=2)
    opt, sched = optim.onecycle_adam(model, 1e-4, 100)
    state = TrainState(model, opt, sched)
    step = make_sr_train_step(model, enable_uncertainty=False,
                              slice_separation=4, num_slices=4)
    gen = torch.Generator().manual_seed(0)

    def one_step():
        lr_b, hr_b = loader.next()
        hr_b = augment_sr_hr_batch(gen, hr_b)
        lr_b = simulate_lr_batch(gen, lr_b, 4.0)
        return step(state, lr_b, hr_b)

    _, events, moved = _traced(one_step)
    names = [e.name for e in events]
    for name in ("rehrseg.sampler.next", "rehrseg.augment",
                 "rehrseg.lr_sim", "rehrseg.sr_step"):
        assert names.count(name) == 1 and _parent(
            events[names.index(name)]) is None, name
    parents = {e.name: _parent(e) for e in events}
    assert parents["rehrseg.sampler.draw"] == "rehrseg.sampler.next"
    assert parents["rehrseg.sampler.gather"] == "rehrseg.sampler.next"
    for child in ("forward", "backward", "optimizer"):
        assert parents[f"rehrseg.sr_step.{child}"] == "rehrseg.sr_step"
    assert "rehrseg.sr_step.all_reduce" not in parents
    assert events[names.index("rehrseg.sr_step")].concrete_inputs == [0]
    assert moved["train.steps"] == 1 and moved["train.samples"] == 2


def test_seg_step_spans_and_counters():
    seg = SegModel(2, 4, arch=SMALL_ARCH)
    state = TrainState(seg, optim.nesterov_sgd(seg),
                       optim.poly_epoch_schedule(1e-2, 4, 1))
    rng = np.random.default_rng(0)
    batch = tst.SegBatch(
        torch.from_numpy(rng.normal(size=(2, 4, 16, 16, 1)).astype(
            np.float32)),
        torch.from_numpy((rng.uniform(size=(2, 4, 16, 16, 1)) > 0.5)
                         .astype(np.float32)),
        torch.from_numpy((rng.uniform(size=(2, 16, 16, 16, 1)) > 0.5)
                         .astype(np.float32)),
        torch.zeros(2, 4, 16, 16, 1))
    step = tst.make_seg_train_step(seg, enable_uncertainty=False,
                                   enable_distillation=False, remat=False)
    _, events, moved = _traced(lambda: step(state, batch))
    parents = {e.name: _parent(e) for e in events}
    assert {_parent(e) for e in events
            if e.name == "rehrseg.segnet.norm_act"} == {
        "rehrseg.segnet.encoder", "rehrseg.seg_step.forward"}
    parents.pop("rehrseg.segnet.norm_act")
    assert parents.pop("rehrseg.seg_step") is None
    assert parents.pop("rehrseg.segnet.encoder") == \
        "rehrseg.seg_step.forward"
    assert parents == {f"rehrseg.seg_step.{c}": "rehrseg.seg_step"
                       for c in ("forward", "loss", "backward",
                                 "optimizer")}
    assert moved["train.steps"] == 1 and moved["train.samples"] == 2


class _Counting:
    """A dataset whose samples count up."""

    def __init__(self):
        self.n = 0

    def sample(self, rng=None):
        self.n += 1
        return (np.full(2, self.n, np.float32),)


def test_loader_spans_and_counters():
    loader = PrefetchLoader(BatchLoader(_Counting(), 3))
    try:
        batches, events, moved = _traced(
            lambda: [loader.next() for _ in range(4)])
    finally:
        loader.close()
    assert [b[0][0, 0] for b in batches] == [1, 4, 7, 10]
    # the wrapped loader's spans run on the prefetch thread, when traced
    assert {e.name for e in events} == {"rehrseg.loader.next"}
    assert len(events) >= 4
    assert moved["loader.batches"] == 4
    assert moved.get("loader.wait_ns", 0) >= 0
