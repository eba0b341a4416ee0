"""The port's stage 0 and stage 1a, the stage-2 stores and the pipeline's
entry point against the JAX package's ``Pipeline`` on
tests/test_pipeline_e2e.py's phantom, on the CPU, fp32: the merged NIfTIs;
the interpolation branch's and the SMORE branch's HDF5 stores and SMORE
NIfTIs (test_torch_sr's TOL), the logged loss (rtol 1e-4); resume by
artifact and the NIfTI backfill; ``sr_mode: img``; ``postprocess_flavr``'s
stores. The JAX models' ``init`` is patched to the seeded weights the port
starts from. Then the port alone: ``cli.main`` from stage 0 to stage 2
and a rerun that trains nothing; stage 1b on the device path through
``dataset=``; ``--help`` with jax unimportable; what still raises."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu.io import volume as jvolume
from rehrseg_tpu.models import UNet3D as JaxUNet3D
from rehrseg_tpu.models import WDSR as JaxWDSR
from rehrseg_tpu.pipeline import Pipeline
from rehrseg_tpu_torch import cli, pipeline
from rehrseg_tpu_torch.config import Config
from rehrseg_tpu_torch.data.datasets import (MultiprocessBatchLoader,
                                           SegSRDataset, SRPatchDataset)
from rehrseg_tpu_torch.infer.sr_infer import (interpolate_pseudo_sr,
                                              postprocess_sr_volume)
from rehrseg_tpu_torch.io import nifti
from rehrseg_tpu_torch.io.volume import parse_image
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.parallel import spatial as sparse
from tests.test_pipeline_e2e import TINY_ARCH, _tiny_config
from tests.test_torch_cli import _run_blocked
from tests.test_torch_sr import TOL

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _seeded_np(kind, *args):
    make = (convert.random_wdsr_params if kind == "wdsr"
            else convert.random_flavr_params)
    names = (("out_channel", "n_resblocks", "num_channels", "scale")
             if kind == "wdsr" else
             ("img_channels", "n_inputs", "n_outputs", "use_uncertainty"))
    return make(0, **dict(zip(names, args)))


def _seeded(kind, *args):
    """Fresh device arrays each call: the JAX step donates its state."""
    return jax.tree.map(jnp.asarray, _seeded_np(kind, *args))


def seeded_init(monkeypatch):
    """JAX's WDSR and UNet3D ``init`` return the seeded params the port's
    pipeline starts from (``convert.random_*_params(0, ...)``)."""
    def wdsr_init(self, key, x0):
        return _seeded("wdsr", self.out_channel, self.n_resblocks,
                       self.num_channels, self.scale)

    def flavr_init(self, key, x0):
        return _seeded("flavr", self.img_channels, self.n_inputs,
                       self.n_outputs, self.use_uncertainty)

    monkeypatch.setattr(JaxWDSR, "init", wdsr_init)
    monkeypatch.setattr(JaxUNet3D, "init", flavr_init)


def phantom(root):
    """tests/test_pipeline_e2e.py's two subjects: a noisy volume with a
    bright blob and its label, 4 mm slices."""
    rng = np.random.default_rng(0)
    for d in ("imagesTr", "labelsTr"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for name in ("sub1", "sub2"):
        shape = (24, 24, 8)
        img = rng.normal(size=shape).astype(np.float32)
        img[8:16, 8:16, 2:6] += 3.0
        lab = np.zeros(shape, dtype=np.float32)
        lab[8:16, 8:16, 2:6] = 1.0
        aff = np.diag([1.0, 1.0, 4.0, 1.0])
        jnifti.save(jnifti.NiftiImage(data=img, affine=aff),
                    str(root / "imagesTr" / f"{name}_0000.nii.gz"))
        jnifti.save(jnifti.NiftiImage(data=lab, affine=aff),
                    str(root / "labelsTr" / f"{name}.nii.gz"))


def configs(root, **extra):
    """(JAX config, port config) of ``_tiny_config`` in fp32 over one
    phantom, each with its own tmp and checkpoint directories."""
    jc = _tiny_config(root)
    jc.tmp_path, jc.checkpoint_path = str(root / "jtmp"), str(root / "jckpt")
    jc.extra.update(precision="fp32", **extra)
    fields = {k: getattr(jc, k) for k in Config.__dataclass_fields__}
    tc = Config(**{**fields, "tmp_path": str(root / "ttmp"),
                   "checkpoint_path": str(root / "tckpt"),
                   "extra": json.loads(json.dumps(jc.extra))})
    return jc, tc


def h5(path):
    import h5py

    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


def assert_same_h5(a, b, exact=()):
    da, db = h5(a), h5(b)
    assert set(da) == set(db)
    for k in da:
        assert da[k].shape == db[k].shape and da[k].dtype == db[k].dtype, k
        if k in exact:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            np.testing.assert_allclose(da[k], db[k], err_msg=k, **TOL)


def losses(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def mtimes(root):
    return {str(p): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()}


def test_preprocess_interp_and_postprocess_match_jax(tmp_path):
    """Stage 0's merged volumes, the interpolation branch's stores, and
    postprocess_flavr over the same SR NIfTIs, in both packages."""
    phantom(tmp_path)
    jc, tc = configs(tmp_path)
    jp = Pipeline(jc)
    jp.preprocess()
    jp.stage1a_smore()
    pipeline.preprocess(tc)
    pipeline.stage1a_smore(tc, device="cpu")
    paths = pipeline.pipeline_paths(tc)
    names = sorted(os.listdir(paths["merge_data"]))
    assert names == ["sub1_0000.nii.gz", "sub2_0000.nii.gz"]
    for s in names:
        a = nifti.load(os.path.join(paths["merge_data"], s))
        b = jnifti.load(os.path.join(jp.merge_data_path, s))
        np.testing.assert_array_equal(a.data, b.data)
        assert a.header.get_zooms() == b.header.get_zooms()
        assert_same_h5(os.path.join(paths["sr_h5"], s + ".h5"),
                       os.path.join(jp.sr_h5_path, s + ".h5"),
                       exact=("label_hr",))
    before = mtimes(tmp_path / "ttmp")
    pipeline.stage1a_smore(tc, device="cpu")     # every store exists
    assert mtimes(tmp_path / "ttmp") == before

    # the same SR NIfTIs under both packages' flavr_output, one subject
    # without an uncertainty map
    rng = np.random.default_rng(4)
    for s in names:
        ref = nifti.read_image_itk(os.path.join(tc.data_path, s))
        base = s.replace(".nii.gz", "")
        arrays = dict(img_xyz=rng.normal(size=(24, 24, 28)),
                      seg_xyz=rng.normal(size=(24, 24, 28)))
        if s.startswith("sub1"):
            arrays["unc_xyz"] = rng.uniform(size=(24, 24, 28))
        for out in (paths["flavr_output"], jp.flavr_output_path):
            jvolume.write_sr_niftis(ref, os.path.join(out, base), 4.0,
                                    **arrays)
    jp.postprocess_flavr()
    pipeline.postprocess_flavr(tc)
    for s in names:
        h = s.replace(".nii.gz", ".h5")
        assert_same_h5(os.path.join(paths["segsr_h5"], h),
                       os.path.join(jp.segsr_h5_path, h),
                       exact=("seg", "uncertainty"))


@pytest.mark.parametrize("sr_mode", ["img+seg", "img"])
def test_stage1a_smore_matches_jax(tmp_path, monkeypatch, sr_mode):
    """The SMORE branch: WDSR training (2 steps, host LR simulation) and
    inference; the stores and NIfTIs, the logged loss; a rerun writes
    nothing; a missing NIfTI is backfilled from the store."""
    seeded_init(monkeypatch)
    phantom(tmp_path)
    jc, tc = configs(tmp_path, sr_mode=sr_mode)
    jc.smore_initialization = tc.smore_initialization = True
    jp = Pipeline(jc)
    jp.preprocess()
    jp.stage1a_smore()
    pipeline.preprocess(tc)
    pipeline.stage1a_smore(tc, device="cpu")
    paths = pipeline.pipeline_paths(tc)
    jl, tl = (losses(os.path.join(c.checkpoint_path, "smore"))
              for c in (jc, tc))
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [0]
    assert tl[0]["loss"] == pytest.approx(jl[0]["loss"], rel=1e-4)
    # JAX evaluates the one-cycle schedule in fp32
    assert tl[0]["lr"] == pytest.approx(jl[0]["lr"], rel=1e-5)
    suffixes = ["_img"] + (["_seg"] if sr_mode == "img+seg" else [])
    for s in sorted(os.listdir(paths["merge_data"])):
        assert_same_h5(os.path.join(paths["sr_h5"], s + ".h5"),
                       os.path.join(jp.sr_h5_path, s + ".h5"),
                       exact=("label_hr",))
        base = s.replace(".nii.gz", "")
        for suf in suffixes:
            a = nifti.read_image_itk(os.path.join(
                tc.tmp_path, "smore_output", base + suf + ".nii.gz"))
            b = jnifti.read_image_itk(os.path.join(
                jc.tmp_path, "smore_output", base + suf + ".nii.gz"))
            assert a.array.shape == b.array.shape == (32, 24, 24)
            assert a.spacing == b.spacing
            np.testing.assert_allclose(a.array, b.array, **TOL)
        assert not os.path.exists(os.path.join(
            tc.tmp_path, "smore_output", base + "_seg.nii.gz")) \
            or sr_mode == "img+seg"
    if sr_mode == "img":
        return
    before = mtimes(tmp_path / "ttmp")
    pipeline.stage1a_smore(tc, device="cpu")
    assert mtimes(tmp_path / "ttmp") == before
    img = os.path.join(tc.tmp_path, "smore_output", "sub1_0000_img.nii.gz")
    want = nifti.read_image_itk(img).array
    os.remove(img)
    pipeline.stage1a_smore(tc, device="cpu")
    np.testing.assert_array_equal(nifti.read_image_itk(img).array, want)
    assert losses(os.path.join(tc.checkpoint_path, "smore")) == tl


def test_cli_runs_the_pipeline_and_resumes(tmp_path, capsys):
    """``cli.main(--config --device cpu)``: stage 0 to stage 2 on the
    phantom (WDSR SMORE, FLAVR, UASR, distilled stage 2), every artifact
    written; the rerun trains nothing and writes no metric."""
    phantom(tmp_path)
    _, tc = configs(tmp_path)
    tc.smore_initialization = True
    cfg = {k: getattr(tc, k) for k in Config.__dataclass_fields__}
    cfg["extra"]["arch_override"] = dict(TINY_ARCH)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    seg, state, _ = cli.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    for word in ("TRAINING NETWORK SMORE", "TRAINING NETWORK FLAVR",
                 "TRAINING NETWORK FLAVR WITH UNCERTAINTY",
                 "TRAINING NETWORK REHRSeg"):
        assert word in out
    assert state.step == 2 and set(state.params) == {"seg", "distiller"}
    tmp = tmp_path / "ttmp"
    for sub in ("sub1_0000", "sub2_0000"):
        for f in (f"smore_output/{sub}_img.nii.gz",
                  f"smore_output/{sub}_seg.nii.gz",
                  f"data_merged_sr_h5/{sub}.nii.gz.h5",
                  f"flavr_output/{sub}_img.nii.gz",
                  f"flavr_output/{sub}_seg.nii.gz",
                  f"flavr_output/{sub}_uncertainty.nii.gz",
                  f"data_merged_segsr_h5/{sub}.h5"):
            assert (tmp / f).is_file(), f
    ck = tmp_path / "tckpt"
    logs = {d: losses(str(ck / d)) for d in ("smore", "flavr",
                                             "flavr_uncertainty", "segsr")}
    assert all(np.isfinite(r["loss"]) for v in logs.values() for r in v)
    before = mtimes(tmp)
    _, state2, _ = cli.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "TRAINING NETWORK SMORE" not in out
    assert "TRAINING NETWORK FLAVR" not in out
    assert state2.step == 2
    assert mtimes(tmp) == before
    assert {d: losses(str(ck / d)) for d in logs} == logs
    shutil.rmtree(ck)       # UNet3D checkpoints with Adam's moments: 1 GB


def test_stage1b_device_path_through_dataset(tmp_path):
    """Stage 1b on ``dataset=`` (SRPatchDataset.from_volumes over
    interpolated pseudo-HR volumes) with device_lr_sim, the device sampler
    and device_augment_sr: what the card runs (chip_smoke ``stage1``), on
    the CPU; a dataset that disagrees with the config raises."""
    phantom(tmp_path)
    _, tc = configs(tmp_path, device_lr_sim=True, device_augment_sr=True)
    pipeline.preprocess(tc)
    merged = pipeline.pipeline_paths(tc)["merge_data"]
    vols = []
    for s in sorted(os.listdir(merged)):
        image, _, _, fwhm, *_ = parse_image(os.path.join(merged, s), 4.0,
                                            1.0)
        img, lab = interpolate_pseudo_sr(image[..., 0], image[..., 1], 4.0)
        fx, fy = postprocess_sr_volume(img, fwhm)
        vols.append((img[..., None], lab[..., None].astype(np.uint8), fx,
                     fy))
    ds = SRPatchDataset.from_volumes(vols, 4.0, 1.0, [16, 16, 16], True,
                                     device_lr_sim=True)
    loader = pipeline._make_loader(tc, ds, 2, "cpu")
    assert type(loader).__name__ == "DeviceSRPatchSampler"
    loader.close()
    _, s1b = pipeline.stage1b_flavr(tc, dataset=ds, device="cpu")
    assert s1b.step == 2
    assert sorted(os.listdir(os.path.join(tc.checkpoint_path, "flavr"))) \
        == ["2", "metrics.jsonl"]
    out = os.path.join(tc.tmp_path, "flavr_output")
    for f in sorted(os.listdir(out)):
        a = nifti.read_image_itk(os.path.join(out, f)).array
        assert a.shape == (28, 24, 24) and np.isfinite(a).all(), f
    assert len(os.listdir(out)) == 4
    ds_host = SRPatchDataset.from_volumes(vols, 4.0, 1.0, [16, 16, 16],
                                          True)
    with pytest.raises(ValueError, match="device_lr_sim"):
        pipeline.stage1b_flavr(
            configs(tmp_path / "other", device_lr_sim=True)[1],
            dataset=ds_host, device="cpu")
    shutil.rmtree(tc.checkpoint_path)


def _spatial_dataset():
    """Two seeded stage-2 volumes at the tiny config's patch (4, 16, 16),
    device augmentation on."""
    rng = np.random.default_rng(5)
    vols = []
    for _ in range(2):
        img = rng.normal(size=(20, 20, 8)).astype(np.float32)
        vols.append((img, (img > 0.4).astype(np.float32),
                     rng.uniform(0, 255, size=img.shape).astype(np.float32)))
    return SegSRDataset.from_volumes(vols, 4.0, 1.0, (20, 20, 4),
                                     (16, 16, 4), random_flip=True,
                                     uncertainty=True, device_augment=True)


def test_entry_points_raise_what_is_still_to_port(tmp_path, monkeypatch):
    """``main``'s path checks (reached with ``--fold all`` and
    REHRSEG_PLATFORM=cpu too); ``mesh_spatial`` > 1 trains stage 2 with
    each patch's H over two names of the CPU, and ``--fold all`` refuses
    it with JAX's message; ``loader_workers > 0`` gives the worker loader;
    an unknown ``sr_infer_dtype`` raises."""
    phantom(tmp_path)
    _, tc = configs(tmp_path)
    cfg = {k: getattr(tc, k) for k in Config.__dataclass_fields__}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**cfg, "data_path": str(tmp_path / "no")}))
    with pytest.raises(ValueError, match="Input image path"):
        pipeline.main(str(path), device="cpu")
    path.write_text(json.dumps({**cfg, "seg_path": str(tmp_path / "no")}))
    with pytest.raises(ValueError, match="nnUNet does not exist"):
        pipeline.main(str(path), device="cpu")
    # --fold all and REHRSEG_PLATFORM=cpu reach main's path checks
    with pytest.raises(ValueError, match="nnUNet does not exist"):
        cli.main(["--config", str(path), "--fold", "all"])
    monkeypatch.setenv("REHRSEG_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="nnUNet does not exist"):
        cli.main(["--config", str(path)])
    monkeypatch.delenv("REHRSEG_PLATFORM")
    # spatial sharding trains (a seeded teacher, a seeded dataset); --fold
    # all keeps JAX's refusal
    tc.extra["mesh_spatial"] = 2
    sparse.reset_record()
    _, state, _ = pipeline.stage2_segsr(
        tc, flavr_model=UNet3D(2, 4, 4), dataset=_spatial_dataset(),
        device="cpu")
    assert state.step == 2 and len(sparse.RECORD) > 0
    assert any(len(rows) == 2 for _, rows in sparse.RECORD)
    assert all(torch.isfinite(p).all() for p in state.params["seg"]
               .parameters())
    with pytest.raises(NotImplementedError, match="mesh_spatial") as got:
        pipeline.stage2_segsr_all_folds(
            Config(**{**cfg, "fold": "all",
                      "data_path": str(tmp_path / "imagesTr"),
                      "seg_path": ""}), device="cpu")
    jc_all = _tiny_config(tmp_path)
    jc_all.fold, jc_all.extra["mesh_spatial"] = "all", 2
    with pytest.raises(NotImplementedError) as want:
        Pipeline(jc_all)
    assert str(got.value) == str(want.value)
    del tc.extra["mesh_spatial"]
    tc.extra["loader_workers"] = 2
    pipeline.preprocess(tc)
    ds = SRPatchDataset(pipeline.pipeline_paths(tc)["merge_data"],
                        ["sub1"], 4.0, 1.0, None, "gaussian", (16, 16),
                        True)
    loader = pipeline._make_loader(tc, ds, 2, "cpu")
    assert isinstance(loader, MultiprocessBatchLoader)
    loader.close()
    tc.extra["sr_infer_dtype"] = "fp16"
    with pytest.raises(ValueError, match="sr_infer_dtype"):
        pipeline._sr_infer_dtype(tc)


def test_cli_help_without_jax():
    """``python -m rehrseg_tpu_torch.cli --help`` and the stage-1 modules
    import where jax, flax, optax, h5py and the JAX package cannot."""
    _run_blocked(["--help"], code=(
        "import importlib\n"
        "for m in ('cli', 'pipeline', 'train.sr_trainer', 'ops.slr', "
        "'ops.blur', 'data.device_sampler', 'data.device_sr_sim', "
        "'data.datasets', 'infer.sr_infer', 'train.torch_import'):\n"
        "    importlib.import_module('rehrseg_tpu_torch.' + m)\n"
        "sys.argv = ['cli'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('rehrseg_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"))
