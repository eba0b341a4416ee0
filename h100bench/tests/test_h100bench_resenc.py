"""The ResEnc serving cell's additions at a toy size on the CPU: the
driver's whole run comes out correct with its residual-block count, each
serving fault and the lower-precision control come out not correct, the
served tile's operations are counted on the ResEnc reference, and the two
residual-encoder readers read the program's spans (a number on a traced
window, None on a trace without them)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from h100bench import control, count, faults, run
from h100bench.reference import resenc_segnet as ref_resenc
from h100bench.reference import segnet as ref_segnet
from h100bench.run import load_reader
from h100bench.tests.test_h100bench_spans import (
    kernel, launch, span, trace_of)

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
E2E = [{"name": "setup_s", "unit": "s"},
       {"name": "seg_vox_per_s", "unit": "vox/s"}]
READERS = ("encoder_ms_per_vol.serve", "residual_ms_per_vol.serve")
SEED = 2 ** 31 + 11


def _config():
    return json.loads((BENCH / "tests/data/segmodel-resenc-tiny.json")
                      .read_text())


def resenc_cell(per_layer=()):
    """The cell's traffic (its own file) at a toy volume and config; the
    toy limits as ``test_h100bench_drivers.py``'s."""
    tr = json.loads((BENCH / "workloads/serve-dual-aligned-resenc.json")
                    .read_text())
    tr.update(volume_shape=[6, 24, 200], distinct_volumes=2,
              limits={"lr_gap": 0.25, "hr_gap": 0.25})
    return SimpleNamespace(
        name="toy", entry={"chips": 1}, config=_config(), traffic=tr,
        end_to_end=E2E,
        per_layer=[{"name": m, "unit": "ms"} for m in per_layer])


def one_run(cell, trace=False):
    result, checks, info = run.run_cell(
        cell, SEED, 0.2, trace, CPU, t_start=time.perf_counter())
    assert run.forbidden_modules() == []
    return result, info


def test_sound_run_counts_its_blocks():
    res, info = one_run(resenc_cell())
    assert res["correct"], res
    assert res["metrics"]["seg_vox_per_s"]["value"] > 0
    blocks = sum(_config()["n_blocks_per_stage"])
    assert info["res_blocks_per_volume"] == blocks * info["tiles_per_volume"]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_fault_is_caught(fault, monkeypatch):
    faults.SERVE[fault](monkeypatch)
    assert not one_run(resenc_cell())[0]["correct"]


def test_control_fails():
    cell = resenc_cell()
    drv = run.load_driver("serve_volumes_resenc").setup(
        cell, 11, CPU, run.SetupClock(time.perf_counter()))
    drv.window(0.1)
    drv.release()
    limits = cell.traffic["limits"]
    assert any(v > limits[n] for n, v in drv.control_check())


def test_control_reads_a_fault_by_the_drivers_name():
    """``control.py --fault`` finds the serving faults under this driver's
    name once the driver is loaded, and the planted fault reads above the
    limits."""
    cell = resenc_cell()
    run.load_driver("serve_volumes_resenc")
    assert faults.BY_DRIVER["serve_volumes_resenc"] is faults.SERVE
    got = control.readings(cell, 12, 0.1, CPU, fault="altered_answer")
    assert any(got[n] > v for n, v in cell.traffic["limits"].items())


def test_tile_flops_count_the_resenc_reference():
    """The served tile's operations: the ResEnc reference's convolutions
    under 8 flips, not the plain model's; at the cell's size 16.35 TFLOP
    (the plain model's 9.99), the encoder 64.5 % of them."""
    cell = resenc_cell()
    drv = run.load_driver("serve_volumes_resenc").setup(
        cell, 13, CPU, run.SetupClock(time.perf_counter()))
    drv.release()
    cfg = _config()
    arch = ref_resenc.arch_from_config(cfg)
    patch = tuple(cfg["patch_size"])
    want = 2 * count.conv_macs(ref_resenc.SegModel(arch), (8, *patch, 1),
                               hr=True)
    assert drv.tile_flops() == want
    assert want != count.seg_tile_flops(ref_segnet.arch_from_config(cfg),
                                        patch, dual=True)
    full = json.loads((BENCH / "configs/segmodel-nnunet-resenc-3d-fullres"
                       ".json").read_text())
    macs = count.conv_macs(
        ref_resenc.SegModel(ref_resenc.arch_from_config(full)),
        (8, *full["patch_size"], 1), by_module=True, hr=True)
    total = sum(macs.values())
    assert 2 * total / 1e12 == pytest.approx(16.349, abs=0.001)
    enc = sum(v for k, v in macs.items() if k.startswith("encoder"))
    assert enc / total == pytest.approx(0.645, abs=0.001)


def test_one_state_dict_loads_into_both():
    from rehrseg_tpu_torch.models.segnet import SegModel

    arch = ref_resenc.arch_from_config(_config())
    with torch.device("meta"):
        ref = ref_resenc.SegModel(arch).state_dict()
        prog = SegModel(arch=arch).state_dict()
    assert {k: v.shape for k, v in ref.items()} == \
        {k: v.shape for k, v in prog.items()}


def test_readers_on_a_traced_cpu_window():
    """A traced toy run reports both readers (the CPU trace has no device
    operations, so each reads 0 ms)."""
    res, _ = one_run(resenc_cell(READERS), trace=True)
    assert res["correct"], res
    for m in READERS:
        assert res["metrics"][m]["value"] == 0.0


def _serving(with_spans: bool):
    """One volume in a 100 ms window: kernels launched at 12 (10 ms, inside
    the encoder and a residual span), 21 (5 ms, inside the encoder only)
    and 41 (4 ms, outside both)."""
    ev = [span("h100bench.window", 0, 100),
          launch(1, 12), kernel(20, 30, corr=1),
          launch(2, 21), kernel(30, 35, corr=2),
          launch(3, 41), kernel(45, 49, corr=3)]
    if with_spans:
        ev += [span("rehrseg.segnet.encoder", 10, 25),
               span("rehrseg.segnet.residual", 11, 13)]
    return SimpleNamespace(trace=trace_of(ev),
                           driver=SimpleNamespace(volumes_done=1))


@pytest.mark.parametrize("metric,want", [
    ("encoder_ms_per_vol.serve", 15.0), ("residual_ms_per_vol.serve", 10.0)])
def test_reader_on_a_synthetic_trace(metric, want):
    reader = load_reader(metric)
    assert reader.read(_serving(True)) == pytest.approx(want, abs=1e-6)
    assert reader.read(_serving(False)) is None
