"""The port's serving CLI against the JAX package's on the same weights and
inputs (--out, --out-dir with --hr, --step best; --mode sr with the plain
and the UASR UNet3D; the port on the CPU with --device cpu, reading a JSON
config), the CLI in a process where pyyaml, orbax, h5py and JAX cannot be
imported, and the port's packaging: where the kernels are built and that
the CUDA sources ship with the package.

Both CLIs serve bf16; for the comparisons both build their Segmenter at
fp32, where labels agree on at least 99.9 % of voxels (fp32 summation
order differs between XLA and PyTorch). In bf16 the two roundings differ
on about 0.5 % of these random-weight voxels."""

import functools
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

import jax.numpy as jnp

import rehrseg_tpu.serve as jserve
from chip_smoke import json_with_dots
import rehrseg_tpu_torch.serve as tserve
from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu.serve import main as jax_serve_main
from rehrseg_tpu.train import TrainState
from rehrseg_tpu.train import checkpoint as jckpt
from rehrseg_tpu_torch import kernels
from rehrseg_tpu_torch.io import nifti
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.serve import main as serve_main
from rehrseg_tpu_torch.train import checkpoint as ckpt
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PATCH = [4, 16, 16]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Checkpoints of the same weights for both packages (step 1 and the
    tag "best", each its own weights), configs (YAML for JAX, JSON for the
    port) and two input volumes; returns their paths."""
    root = tmp_path_factory.mktemp("served")
    jdir, tdir = root / "jax_ckpt", root / "port_ckpt"
    for step, seed in ((1, 21), ("best", 22)):
        params = convert.random_flax_params(SMALL_ARCH, seed)
        state = TrainState.create(params, optax.sgd(1e-3))
        jckpt.save_checkpoint(str(jdir), state, step=step)
        model = SegModel(2, 4, arch=SMALL_ARCH)
        convert.load_flax_params(model, params)
        ckpt.save_checkpoint(str(tdir), model, step=1,
                             tag=None if step == 1 else step)
    arch = {k: [list(x) if isinstance(x, tuple) else x for x in v]
            if isinstance(v, tuple) else v for k, v in SMALL_ARCH.items()}
    cfg = {"slice_thickness": 4.0, "target_thickness": 1.0,
           "smore_initialization": False, "enable_distillation": False,
           "arch_override": arch, "patch_size_zyx": PATCH}
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (root / "cfg.json").write_text(json_with_dots(cfg))
    affine = np.diag([0.9, 0.8, 4.0, 1.0])
    inputs = []
    for i, shape in enumerate([(6, 20, 24), (5, 18, 16)]):
        vol = _blob_volume(shape, np.random.default_rng(30 + i))
        path = root / f"case{i}_0000.nii.gz"
        nifti.save(nifti.NiftiImage(data=vol.transpose(2, 1, 0),
                                    affine=affine), str(path))
        inputs.append(str(path))
    return dict(root=root, jax_ckpt=str(jdir), port_ckpt=str(tdir),
                yaml=str(root / "cfg.yaml"), json=str(root / "cfg.json"),
                inputs=inputs)


def _agree(got, want, max_frac=1e-3):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got != want) <= max_frac, np.mean(got != want)


@pytest.fixture
def fp32(monkeypatch):
    """Both CLIs build their Segmenter at fp32."""
    for mod, dtype in ((jserve, jnp.float32), (tserve, torch.float32)):
        monkeypatch.setattr(mod, "load_segmenter_from_checkpoint",
                            functools.partial(
                                mod.load_segmenter_from_checkpoint,
                                compute_dtype=dtype))


def _run_both(served, monkeypatch, tmp_path, args_for):
    """Run JAX's serve_main and the port's main with ``args_for(out_root)``
    under out roots tmp/jax and tmp/port."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    tout.mkdir()
    monkeypatch.setattr("sys.argv", ["serve", *args_for(jout),
                                     "--ckpt", served["jax_ckpt"],
                                     "--config", served["yaml"]])
    jax_serve_main()
    serve_main([*args_for(tout), "--ckpt", served["port_ckpt"],
                "--config", served["json"], "--device", "cpu"])
    return jout, tout


def _read(path):
    return jnifti.read_image_itk(str(path))


def test_cli_out_matches_jax(served, fp32, monkeypatch, tmp_path, capsys):
    inp = served["inputs"][0]
    jout, tout = _run_both(served, monkeypatch, tmp_path,
                           lambda d: [inp, "--out", str(d / "seg.nii.gz")])
    assert f"{inp} -> {tout / 'seg.nii.gz'}" in capsys.readouterr().out
    got, want = _read(tout / "seg.nii.gz"), _read(jout / "seg.nii.gz")
    assert got.array.shape == (6, 20, 24)
    assert set(np.unique(got.array)) <= {0, 1}
    _agree(got.array, want.array)
    assert got.GetSpacing() == want.GetSpacing() == pytest.approx(
        (0.9, 0.8, 4.0))


def test_cli_out_dir_hr_matches_jax(served, fp32, monkeypatch, tmp_path):
    """Many inputs with --out-dir; --hr then means "also write HR", one
    ``_hr_seg`` file per input at z-spacing / slice_separation."""
    jout, tout = _run_both(
        served, monkeypatch, tmp_path,
        lambda d: [*served["inputs"], "--out-dir", str(d), "--hr", "yes"])
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == [
        "case0_0000_hr_seg.nii.gz", "case0_0000_seg.nii.gz",
        "case1_0000_hr_seg.nii.gz", "case1_0000_seg.nii.gz"]
    for name, shape in (("case0_0000", (6, 20, 24)),
                        ("case1_0000", (5, 18, 16))):
        lr, hr = _read(tout / f"{name}_seg.nii.gz"), \
            _read(tout / f"{name}_hr_seg.nii.gz")
        assert lr.array.shape == shape
        assert hr.array.shape == (4 * shape[0],) + shape[1:]
        assert hr.GetSpacing() == pytest.approx((0.9, 0.8, 1.0))
        _agree(lr.array, _read(jout / f"{name}_seg.nii.gz").array)
        _agree(hr.array, _read(jout / f"{name}_hr_seg.nii.gz").array)


def test_cli_step_best_matches_jax(served, fp32, monkeypatch, tmp_path):
    inp = served["inputs"][0]
    jout, tout = _run_both(
        served, monkeypatch, tmp_path,
        lambda d: [inp, "--out", str(d / "seg.nii.gz"), "--step", "best",
                   "--hr", str(d / "hr.nii.gz"), "--no-mirror"])
    for name in ("seg.nii.gz", "hr.nii.gz"):
        _agree(_read(tout / name).array, _read(jout / name).array)
    # the tag's weights, not step 1's
    serve_main([inp, "--out", str(tmp_path / "step1.nii.gz"), "--step", "1",
                "--no-mirror", "--ckpt", served["port_ckpt"], "--config",
                served["json"], "--device", "cpu"])
    assert np.mean(_read(tmp_path / "step1.nii.gz").array
                   != _read(tout / "seg.nii.gz").array) > 0.01


def test_cli_refusals(served, tmp_path):
    """Many inputs with --out, and (in either mode) one input without
    --out, exit through argparse's error."""
    base = ["--ckpt", served["port_ckpt"], "--config", served["json"],
            "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve_main([*served["inputs"], "--out", str(tmp_path / "o.nii.gz"),
                    *base])
    for mode in ("seg", "sr"):
        with pytest.raises(SystemExit):
            serve_main([served["inputs"][0], "--mode", mode, *base])
    assert not os.listdir(tmp_path)


_BLOCK = ("import runpy, sys\n"
          "for m in ('yaml', 'orbax', 'jax', 'flax', 'h5py', 'optax',"
          " 'rehrseg_tpu'):\n"
          "    sys.modules[m] = None\n")

# the stage-2 training modules
TRAINING_MODULES = (
    "losses", "pipeline", "data.datasets", "data.device_aug",
    "data.transforms", "data.normalize", "models.distiller", "ops.warp",
    "train.seg_trainer", "train.optim", "train.state", "train.precision",
    "train.torch_import", "utils.metrics", "utils.timer",
    "utils.preemption", "io.volume")


def _run_blocked(args, code=None):
    """``python -m rehrseg_tpu_torch.serve ARGS`` (or ``code``) in a
    process where yaml, orbax, h5py, optax, flax and jax cannot be
    imported."""
    if code is None:
        code = ("sys.argv = ['serve'] + sys.argv[1:]\n"
                "runpy.run_module('rehrseg_tpu_torch.serve', "
                "run_name='__main__')\n")
        args = [*args, "--device", "cpu"]
    r = subprocess.run(
        [sys.executable, "-c", _BLOCK + code, *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO),
                           OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_runs_without_pyyaml_orbax_or_jax(served, served_sr, tmp_path):
    """The CLI in seg mode and in --mode sr (UASR), with the JSON
    configs, where pyyaml, orbax, h5py, optax, flax and jax cannot be
    imported; the stage-2 training modules import there too."""
    _run_blocked([], code="import importlib\n" + "".join(
        f"importlib.import_module('rehrseg_tpu_torch.{m}')\n"
        for m in TRAINING_MODULES))
    out = tmp_path / "seg.nii.gz"
    _run_blocked([served["inputs"][1], "--out", str(out), "--ckpt",
                  served["port_ckpt"], "--config", served["json"], "--step",
                  "1"])
    assert _read(out).array.shape == (5, 18, 16)
    _run_blocked([served_sr["inputs"][1], "--mode", "sr", "--out",
                  str(tmp_path / "sr.nii.gz"), "--sr-uncertainty", "--ckpt",
                  served_sr["port_unc"], "--config", served_sr["json"]])
    assert _read(tmp_path / "sr_uncertainty.nii.gz").array.shape == \
        (16, 9, 11)


# ------------------------------------------------------------ --mode sr

SR_SHAPES = [(12, 10, 5), (11, 9, 5)]    # (x, y, z) merged inputs


@pytest.fixture(scope="module")
def served_sr(tmp_path_factory):
    """UNet3D checkpoints (plain and UASR, full widths) of the same seeded
    flax params for both packages (orbax for JAX, ``train.checkpoint`` for
    the port), configs (YAML, JSON) and two merged 2-channel (image,
    label) NIfTI inputs at spacing (0.9, 0.8, 4.0)."""
    root = tmp_path_factory.mktemp("served_sr")
    paths = {}
    for unc in (False, True):
        params = convert.random_flavr_params(40 + unc, use_uncertainty=unc)
        jdir, tdir = root / f"jax_{int(unc)}", root / f"port_{int(unc)}"
        jckpt.save_checkpoint(str(jdir), TrainState.create(
            params, optax.sgd(1e-3)), step=1)
        model = UNet3D(use_uncertainty=unc)
        convert.load_flax_flavr_params(model, params, unc)
        ckpt.save_checkpoint(str(tdir), model, step=1)
        paths["jax_unc" if unc else "jax"] = str(jdir)
        paths["port_unc" if unc else "port"] = str(tdir)
    cfg = {"slice_thickness": 4.0, "target_thickness": 1.0, "num_slices": 4}
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (root / "cfg.json").write_text(json_with_dots(cfg))
    inputs = []
    for i, shape in enumerate(SR_SHAPES):
        rng = np.random.default_rng(50 + i)
        img = _blob_volume(shape, rng)
        lab = (img > 1.5).astype(np.float32)
        path = root / f"merged{i}.nii.gz"
        nifti.save(nifti.NiftiImage(data=np.stack([img, lab], -1),
                                    affine=np.diag([0.9, 0.8, 4.0, 1.0])),
                   str(path))
        inputs.append(str(path))
    return dict(paths, root=root, yaml=str(root / "cfg.yaml"),
                json=str(root / "cfg.json"), inputs=inputs)


def _run_both_sr(served_sr, monkeypatch, tmp_path, args_for, unc):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    tout.mkdir()
    flags = ["--mode", "sr"] + (["--sr-uncertainty"] if unc else [])
    monkeypatch.setattr("sys.argv", [
        "serve", *args_for(jout), *flags, "--ckpt",
        served_sr["jax_unc" if unc else "jax"], "--config",
        served_sr["yaml"]])
    jax_serve_main()
    serve_main([*args_for(tout), *flags, "--ckpt",
                served_sr["port_unc" if unc else "port"], "--config",
                served_sr["json"], "--device", "cpu"])
    return jout, tout


def _sr_close(got, want):
    """An SR volume within 1e-4 of JAX's, relative to its value range
    (fp32 both sides); same shape, spacing and dtype."""
    assert got.array.shape == want.array.shape
    assert got.array.dtype == want.array.dtype == np.float32
    assert got.GetSpacing() == pytest.approx(want.GetSpacing())
    span = float(want.array.max() - want.array.min())
    np.testing.assert_allclose(got.array, want.array, rtol=0,
                               atol=1e-4 * span)


def test_cli_sr_matches_jax(served_sr, monkeypatch, tmp_path, capsys):
    """--mode sr, one input with --out: ``<out>_img`` and ``_seg`` at z
    spacing 1.0 mm with 4 * (z - 1) slices, against JAX's CLI (both fp32
    on the CPU); seg equal on at least 99.9 % of voxels."""
    inp = served_sr["inputs"][0]
    jout, tout = _run_both_sr(
        served_sr, monkeypatch, tmp_path,
        lambda d: [inp, "--out", str(d / "sr.nii.gz")], unc=False)
    assert f"SR -> {tout / 'sr'}_*.nii.gz" in capsys.readouterr().out
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == [
        "sr_img.nii.gz", "sr_seg.nii.gz"]
    img = _read(tout / "sr_img.nii.gz")
    assert img.array.shape == (16, 10, 12)
    assert img.GetSpacing() == pytest.approx((0.9, 0.8, 1.0))
    _sr_close(img, _read(jout / "sr_img.nii.gz"))
    seg, want = _read(tout / "sr_seg.nii.gz"), _read(jout / "sr_seg.nii.gz")
    assert seg.array.dtype == np.uint8 and set(np.unique(seg.array)) <= {0, 1}
    assert np.mean(seg.array == want.array) >= 0.999


def test_cli_sr_uncertainty_out_dir_matches_jax(served_sr, monkeypatch,
                                                tmp_path):
    """--mode sr --sr-uncertainty with --out-dir over two inputs: one
    ``<name>_uncertainty`` map each, in (0, 1), against JAX's CLI."""
    jout, tout = _run_both_sr(
        served_sr, monkeypatch, tmp_path,
        lambda d: [*served_sr["inputs"], "--out-dir", str(d)], unc=True)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == [
        "merged0_uncertainty.nii.gz", "merged1_uncertainty.nii.gz"]
    for i, (x, y, z) in enumerate(SR_SHAPES):
        got = _read(tout / f"merged{i}_uncertainty.nii.gz")
        assert got.array.shape == (4 * (z - 1), y, x)
        _sr_close(got, _read(jout / f"merged{i}_uncertainty.nii.gz"))


def test_build_dir_resolution(tmp_path, monkeypatch):
    """$REHRSEG_TORCH_BUILD_DIR wins; in a checkout the build stays in
    build/rehrseg_tpu_torch/; installed, it goes to the user's cache."""
    monkeypatch.delenv("REHRSEG_TORCH_BUILD_DIR", raising=False)
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    assert kernels.default_build_dir() == \
        REPO / "build" / "rehrseg_tpu_torch"
    assert kernels.BUILD_DIR == REPO / "build" / "rehrseg_tpu_torch"
    site = tmp_path / "site-packages" / "rehrseg_tpu_torch"
    site.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert kernels.default_build_dir(site) == \
        tmp_path / "home" / ".cache" / "rehrseg_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert kernels.default_build_dir(site) == \
        tmp_path / "xdg" / "rehrseg_tpu_torch"
    monkeypatch.setenv("REHRSEG_TORCH_BUILD_DIR", str(tmp_path / "mine"))
    for pkg in (site, kernels.PACKAGE_DIR):
        assert kernels.default_build_dir(pkg) == tmp_path / "mine"


def test_pyproject_ships_the_cuda_sources():
    with open(REPO / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    patterns = project["tool"]["setuptools"]["package-data"][
        "rehrseg_tpu_torch"]
    shipped = {p.name for pat in patterns
               for p in kernels.PACKAGE_DIR.glob(pat)}
    needed = {*kernels.SOURCES.values(), *kernels.PROBES.values(),
              *(p.name for p in kernels.CSRC.glob("*.cuh"))}
    assert needed <= shipped
    assert "torch" in project["project"]["optional-dependencies"]["torch"]
    assert "jax" in project["project"]["dependencies"]
