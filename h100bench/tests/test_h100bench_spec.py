"""The benchmark's files against its contract, on the CPU: names, units,
the data each cell finds by name, the yardstick's counts, and the imports
that the harness and its reference may not make."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in SPEC["workloads"]}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _traffic(cell):
    return json.loads((BENCH / "workloads"
                       / f"{cell['traffic']}.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_finds_config_traffic_and_driver(name):
    cell = CELLS[name]
    confs = {c["name"]: c for c in SPEC["configs"]}
    assert cell["config"] in confs
    assert (ROOT / confs[cell["config"]]["file"]).is_file()
    tr = _traffic(cell)
    assert (BENCH / "drivers" / f"{tr['driver']}.py").is_file()
    assert tr["limits"], "every cell compares at least one number"
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert _reports(E2E["setup_s"], name)
    assert any(_reports(m, name) for n, m in E2E.items() if n != "setup_s")
    assert any(_reports(m, name) for m in SPEC["per_layer"])


def test_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric(metric):
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["layer"] and "\n" not in metric["layer"]
    moved = E2E[metric["moves"]]
    assert metric["workloads"], "a per-layer metric lists its cells"
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert _reports(moved, cell)


def test_names_and_units():
    names = [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(SPEC["workloads"]) + len(SPEC["configs"])]))\
        == len(SPEC["workloads"]) + len(SPEC["configs"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_counts_on_meta_tensors():
    from h100bench import count
    from h100bench.reference.flavr import UNet3D
    from h100bench.reference.segnet import DEFAULT_ARCH

    tile = count.seg_tile_flops(DEFAULT_ARCH, (16, 320, 384), dual=True)
    assert tile / 1e12 == pytest.approx(9.99, abs=0.005)
    head = tile - count.seg_tile_flops(DEFAULT_ARCH, (16, 320, 384),
                                       dual=False)
    assert head / 1e12 == pytest.approx(2.21, abs=0.005)
    fwd = count.seg_forward_flops(DEFAULT_ARCH, (2, 16, 256, 320, 1),
                                  dual=True)
    assert fwd / 1e12 == pytest.approx(1.662, abs=0.0005)
    step = 3 * 2 * count.conv_macs(UNet3D(), (32, 4, 96, 96, 2))
    assert step / 1e12 == pytest.approx(5.80, abs=0.005)
    k1 = count.k1_launch(DEFAULT_ARCH, (16, 320, 384))
    assert count.bound_s(k1["flops"], k1["bytes"]) * 1e3 == pytest.approx(
        1.042, abs=0.0005)


@pytest.mark.parametrize("widths,agree", [([64, 128, 256, 512], True),
                                          ([32, 64, 128, 256], False)])
def test_flavr_widths_come_from_the_config(widths, agree):
    """The reference is built from the configuration's ``encoder_widths``;
    the program's UNet3D, whose widths are its own, takes weights of those
    shapes only where the two agree."""
    import torch

    from h100bench.reference.flavr import UNet3D
    from h100bench.weights import shapes_of
    from rehrseg_tpu_torch.models.flavr import UNet3D as ProgramUNet3D

    cfg = json.loads((BENCH / "configs/flavr-unet3d-4x.json").read_text())
    cfg["encoder_widths"] = widths
    with torch.device("meta"):
        ref = shapes_of(UNet3D.from_config(cfg))
        prog = shapes_of(ProgramUNet3D(img_channels=cfg["img_channels"],
                                       n_inputs=cfg["n_inputs"],
                                       n_outputs=cfg["n_outputs"]))
    assert (ref == prog) is agree


def test_no_jax_in_a_fresh_interpreter():
    drivers = sorted(p.stem for p in (BENCH / "drivers").glob("*.py")
                     if p.stem != "__init__")
    code = "\n".join([
        "import sys",
        "from h100bench import run, trace, control, count",
        *(f"import h100bench.drivers.{d}" for d in drivers),
        "for m in run.load_spec()['per_layer']:",
        "    run.load_reader(m['name'])",
        "import rehrseg_tpu_torch.serve, rehrseg_tpu_torch.pipeline",
        "import rehrseg_tpu_torch.train.sr_trainer",
        "import rehrseg_tpu_torch.data.device_sampler",
        "print(run.forbidden_modules())",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for m in mods:
            assert m.split(".")[0] not in ("rehrseg_tpu_torch",
                                           "rehrseg_tpu", "jax", "flax")
