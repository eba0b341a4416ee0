"""The packed forward's encoder and residual spans and the residual-block
counter, as ``tests/test_torch_trace.py`` reads the others: under the CPU
profiler every packed forward has one ``rehrseg.segnet.encoder`` span,
the residual arch one ``rehrseg.segnet.residual`` span a block inside it,
and ``segnet.res_blocks`` grows by the arch's block count a forward; the
plain arch emits the encoder span alone."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.serve import Segmenter
from rehrseg_tpu_torch.utils import timer
from tests.test_packed_segmodel import ARCH_SMALL
from tests.test_torch_resenc import ARCH_RES, PATCH, _volume

torch.set_num_threads(2)

N_BLOCKS = sum(ARCH_RES["n_blocks_per_stage"])


def _traced(fn):
    """(fn's result, its ``rehrseg.*`` host events, the counters' change)
    of one call under the CPU profiler."""
    before = timer.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = timer.counters()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return out, [e for e in prof.events() if e.name.startswith("rehrseg.")], \
        moved


def _names(events):
    out = {}
    for e in events:
        out[e.name] = out.get(e.name, 0) + 1
    return out


def _parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("rehrseg."):
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("arch,blocks", [(ARCH_RES, N_BLOCKS),
                                         (ARCH_SMALL, 0)],
                         ids=["residual", "plain"])
@pytest.mark.parametrize("pallas_conv", [False, "cat"])
def test_forward_spans_and_counter(arch, blocks, pallas_conv):
    params = convert.tree_to_torch(convert.random_flax_params(arch, 0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 32, 48, 1)).astype(np.float32))

    def fwd():
        with torch.no_grad():
            return segmodel_apply_packed(arch, params, x, dual=True,
                                         pack_max_channels=64,
                                         pallas_conv=pallas_conv)

    _, events, moved = _traced(fwd)
    names = _names(events)
    assert names.get("rehrseg.segnet.encoder") == 1
    assert names.get("rehrseg.segnet.residual", 0) == blocks
    assert all(_parent(e) == "rehrseg.segnet.encoder" for e in events
               if e.name == "rehrseg.segnet.residual")
    assert moved.get("segnet.res_blocks", 0) == blocks


def test_each_served_forward_has_its_spans():
    """Through ``Segmenter.segment(hr=True)`` on the aligned grid: one
    encoder span inside every ``rehrseg.segment.forward``, and the blocks'
    spans and counts a forward."""
    model = SegModel(2, 4, arch=ARCH_RES)
    convert.load_flax_params(model, convert.random_flax_params(ARCH_RES, 1))
    seg = Segmenter(model=model, patch_size=PATCH, tile_grid="aligned",
                    device="cpu", compute_dtype=torch.float32)
    _, events, moved = _traced(
        lambda: seg.segment(_volume((10, 44, 48), 2), hr=True))
    names = _names(events)
    forwards = names["rehrseg.segment.forward"]
    assert forwards == moved["serve.tiles"] >= 2
    assert names["rehrseg.segnet.encoder"] == forwards
    assert names["rehrseg.segnet.residual"] == N_BLOCKS * forwards
    assert moved["segnet.res_blocks"] == N_BLOCKS * forwards
    assert all(_parent(e) == "rehrseg.segment.forward" for e in events
               if e.name == "rehrseg.segnet.encoder")
