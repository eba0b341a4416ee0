"""Each driver's whole run at a toy size on the CPU, past the harness's
look for a card: a sound run comes out correct, and a run whose timed path
is broken underneath (each fault the cell can have), or whose program is
replaced by the lower-precision control, comes out not correct. The
command itself refuses to run without a card.

The toy limits sit between the toy's sound readings (serving gaps
0.03-0.07 logits in bf16; fp32 training gaps under 1e-3) and its control's
(fp8 serving gaps 0.35-0.6; fp8 training first-gradient gaps 0.03-0.07)."""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from h100bench import faults, run

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
E2E = [{"name": "setup_s", "unit": "s"},
       {"name": "seg_vox_per_s", "unit": "vox/s"},
       {"name": "train_samples_per_s", "unit": "samples/s"}]


def serve_cell(grid: str, hr: bool):
    cfg = json.loads((BENCH / "tests/data/segmodel-tiny.json").read_text())
    tr = dict(driver="serve_volumes", volume_shape=[6, 24, 200],
              distinct_volumes=2, hr=hr, check_requests=2,
              segmenter=dict(tile_grid=grid, pallas_conv="cat",
                             compute_dtype="bfloat16"),
              limits={"lr_gap": 0.25, "hr_gap": 0.25})
    return SimpleNamespace(name="toy", entry={"chips": 1}, config=cfg,
                           traffic=tr, end_to_end=E2E, per_layer=[])


def train_cell():
    cfg = json.loads((BENCH / "configs/flavr-unet3d-4x.json").read_text())
    cfg["patch_size"] = 32
    tr = json.loads((BENCH / "workloads/train-stage1b.json").read_text())
    tr.update(batch=2, subjects=2, subject_shape=[40, 44, 36],
              precision="fp32",
              limits={"loss": 1e-3, "first_grad": 1e-2, "change": 1e-2})
    return SimpleNamespace(name="toy", entry={"chips": 1}, config=cfg,
                           traffic=tr, end_to_end=E2E, per_layer=[])


def one_run(cell, seed=2 ** 31 + 5):
    result, checks, info = run.run_cell(
        cell, seed, 0.2, False, CPU, t_start=time.perf_counter())
    assert run.forbidden_modules() == []
    assert list(result)[-1] == "checks"
    return result


SERVE = [("aligned", True), ("parity", False)]


@pytest.mark.parametrize("grid,hr", SERVE)
def test_serve_sound(grid, hr):
    res = one_run(serve_cell(grid, hr))
    assert res["correct"], res
    assert res["metrics"]["seg_vox_per_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("grid,hr", SERVE)
@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serve_fault_is_caught(grid, hr, fault, monkeypatch):
    faults.SERVE[fault](monkeypatch)
    assert not one_run(serve_cell(grid, hr))["correct"]


@pytest.mark.parametrize("grid,hr", SERVE)
def test_serve_control_fails(grid, hr):
    cell = serve_cell(grid, hr)
    drv = run.load_driver("serve_volumes").setup(
        cell, 11, CPU, run.SetupClock(time.perf_counter()))
    drv.window(0.2)
    drv.release()
    limits = cell.traffic["limits"]
    assert any(v > limits[n] for n, v in drv.control_check())


def test_train_sound():
    res = one_run(train_cell())
    assert res["correct"], res
    assert res["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_caught(fault, monkeypatch):
    faults.TRAIN[fault](monkeypatch)
    assert not one_run(train_cell())["correct"]


def test_train_control_fails():
    cell = train_cell()
    drv = run.load_driver("train_stage1_sr").setup(
        cell, 11, CPU, run.SetupClock(time.perf_counter()))
    drv.window(0.1)
    drv.release()
    limits = cell.traffic["limits"]
    assert any(v > limits[n] for n, v in drv.control_check())


def test_command_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "cache_env", lambda *a: None)
    assert run.main(["--workload", "seg-serve-dual-aligned", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2


def test_jax_loaded_by_the_check_withholds_the_result(monkeypatch, capsys):
    """A module of JAX that the check loads, after the window has closed,
    is still found: no result line, exit 3."""
    drv_mod = run.load_driver("serve_volumes")
    real = drv_mod.ServeVolumes.check

    def check(self, served=None):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(self, served)

    monkeypatch.setattr(drv_mod.ServeVolumes, "check", check)
    result, checks, info = run.run_cell(
        serve_cell("parity", False), 2 ** 31 + 7, 0.2, False, CPU,
        t_start=time.perf_counter())
    capsys.readouterr()
    assert run.report(result, checks, info) == 3
    captured = capsys.readouterr()
    assert '"correct"' not in captured.out
    assert "jax" in captured.err
