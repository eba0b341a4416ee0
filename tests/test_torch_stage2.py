"""The port's stage-2 loop (``pipeline.stage2_segsr``) against the JAX
package's ``Pipeline.stage2_segsr`` on the same config, HDF5 store,
validation NIfTIs and nnUNet warm-start checkpoint, on the CPU at
SMALL_ARCH, fp32, host augmentation, no distillation: the losses the two
runs log (step 1, then step 2 after a resume from the step-1 checkpoint)
at rtol 1e-4, the validation dice at 1e-3; the checkpoints (step, ``best``
tag, final step) and a resume that continues; a preemption that saves and
raises, then a rerun that finishes; the profile window; the warm start's
fail-loud rule against JAX's importer; spatially sharded training
(``extra.mesh_spatial``) against the unsharded run."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from rehrseg_tpu.config import Config as JaxConfig
from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu.io import volume as jvolume
from rehrseg_tpu.pipeline import Pipeline
from rehrseg_tpu.train import torch_import as jimport
from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.config import Config
from rehrseg_tpu_torch.data.datasets import SegSRDataset
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.parallel import spatial as sparse
from rehrseg_tpu_torch.train import checkpoint as ckpt
from rehrseg_tpu_torch.train import torch_import
from rehrseg_tpu_torch.utils.preemption import TrainingPreempted
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

TRAIN, VAL = ["s0", "s1"], ["v0"]
HR_SHAPE = (84, 84, 20)        # (x, y, z) pseudo-HR stores
VAL_SHAPE = (6, 84, 84)        # (z, y, x) validation NIfTIs


def _nnunet_state_dict(seed=0):
    """An nnUNet-keyed SegModel checkpoint (deep-supervision heads too, as
    nnUNet saves them) from seeded params."""
    m = SegModel(2, 4, arch=SMALL_ARCH, deep_supervision=True)
    convert.load_flax_params(m, convert.random_flax_params(
        SMALL_ARCH, seed, deep_supervision=True))
    return {k: v.clone() for k, v in m.state_dict().items()}


def _tree(root):
    """The directory layout both pipelines read: HDF5 stores, validation
    NIfTIs, nnUNet splits and the fold's checkpoint_final.pth."""
    rng = np.random.default_rng(0)
    h5 = root / "tmp" / "data_merged_segsr_h5"
    h5.mkdir(parents=True)
    for s in TRAIN:
        img = rng.normal(size=HR_SHAPE).astype(np.float32)
        seg = (img > 0.4).astype(np.float32)
        unc = rng.uniform(0, 255, size=HR_SHAPE).astype(np.float32)
        jvolume.write_h5(str(h5 / f"{s}.h5"), img=img, seg=seg,
                         uncertainty=unc)
    for d in ("imagesTr", "labelsTr"):
        (root / d).mkdir()
    for s in VAL:
        img = rng.normal(size=VAL_SHAPE).astype(np.float32)
        lab = (img > 0.3).astype(np.uint8)
        jnifti.write_image_itk(jnifti.ItkLikeImage(img, (1.0, 1.0, 4.0)),
                               str(root / "imagesTr" / f"{s}_0000.nii.gz"))
        jnifti.write_image_itk(jnifti.ItkLikeImage(lab, (1.0, 1.0, 4.0)),
                               str(root / "labelsTr" / f"{s}.nii.gz"))
    seg_path = root / "nnUNet_results" / "DS" / "trainer"
    (seg_path / "fold_0").mkdir(parents=True)
    torch.save({"network_weights": _nnunet_state_dict()},
               str(seg_path / "fold_0" / "checkpoint_final.pth"))
    pre = root / "nnUNet_preprocessed" / "DS"
    pre.mkdir(parents=True)
    (pre / "splits_final.json").write_text(
        json.dumps([{"train": TRAIN, "val": VAL}]))
    return str(seg_path)


def _config(cls, root, seg_path, ckpt_dir, epochs, **extra):
    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in SMALL_ARCH.items()}
    return cls(
        data_path=str(root / "imagesTr"), tmp_path=str(root / "tmp"),
        checkpoint_path=str(root / ckpt_dir), seg_path=seg_path,
        slice_thickness=4.0, target_thickness=1.0, random_flip=True,
        enable_uncertainty=True, batch_size_segsr=2, lr_segsr=1e-2,
        epochs=epochs, save_iters_segsr=1, enable_distillation=False,
        fold=0,
        extra={"arch_override": arch, "patch_size_zyx": [4, 16, 16],
               "precision": "fp32", "device_augment": False,
               "eval_mirror": False, **extra})


def _log(ckpt_dir):
    with open(os.path.join(ckpt_dir, "segsr", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_stage2_matches_jax_with_resume(tmp_path, capsys):
    seg_path = _tree(tmp_path)
    for epochs in (1, 2):      # step 1, then resume for step 2
        Pipeline(_config(JaxConfig, tmp_path, seg_path, "ckpt_jax",
                         epochs)).stage2_segsr()
        _, state, best = pipeline.stage2_segsr(
            _config(Config, tmp_path, seg_path, "ckpt_port", epochs),
            device="cpu")
        assert state.step == epochs
    out = capsys.readouterr().out
    assert "nnUNet warm start (fold 0)" in out
    assert "remat auto-select: all (device reports no bytes_limit" in out
    jlog, tlog = _log(str(tmp_path / "ckpt_jax")), _log(
        str(tmp_path / "ckpt_port"))
    jl = [r for r in jlog if "loss" in r]
    tl = [r for r in tlog if "loss" in r]
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [1, 2]
    for t, j in zip(tl, jl):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
    jd = [r["val_dice"] for r in jlog if "val_dice" in r]
    td = [r["val_dice"] for r in tlog if "val_dice" in r]
    assert len(td) == len(jd) == 2
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)
    assert best == max(td)
    seg_dir = str(tmp_path / "ckpt_port" / "segsr")
    assert ckpt.latest_step(seg_dir) == 2
    assert ckpt.restore_checkpoint_raw(seg_dir, "best")["step"] in (1, 2)
    raw = ckpt.restore_checkpoint_raw(seg_dir)
    assert raw["step"] == 2 and raw["opt_state"]["state"]


def _dataset(uncertainty=True, device_augment=True, n=2):
    rng = np.random.default_rng(1)
    vols = []
    for _ in range(n):
        img = rng.normal(size=HR_SHAPE).astype(np.float32)
        vols.append((img, (img > 0.4).astype(np.float32),
                     rng.uniform(0, 255, size=HR_SHAPE).astype(np.float32)))
    return SegSRDataset.from_volumes(vols, 4.0, 1.0, (80, 80, 4),
                                     (16, 16, 4), random_flip=True,
                                     uncertainty=uncertainty,
                                     device_augment=device_augment)


class _Signaling:
    """A dataset whose k-th sample sends this process SIGTERM."""

    def __init__(self, ds, fire_at):
        self.ds, self.fire_at, self.n = ds, fire_at, 0
        self.device_augment = ds.device_augment

    def __len__(self):
        return len(self.ds)

    def sample(self, *a, **k):
        self.n += 1
        if self.n == self.fire_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.ds.sample(*a, **k)


def test_preemption_saves_and_resumes(tmp_path):
    """SIGTERM while the loop runs: the 9th sample starts batch 5, which the
    prefetch thread (a queue of 2 batches, a third in hand) draws only once
    the loop has taken batch 2, inside the preemption guard (a signal
    before the guard is installed would end the process, as in JAX)."""
    seg_path = _tree(tmp_path)
    cfg = _config(Config, tmp_path, seg_path, "ckpt", 6,
                  device_augment=True, remat="hires")
    cfg.save_iters_segsr = 100
    with pytest.raises(TrainingPreempted) as ei:
        pipeline.stage2_segsr(cfg, dataset=_Signaling(_dataset(), 9),
                              device="cpu")
    seg_dir = str(tmp_path / "ckpt" / "segsr")
    assert 1 <= ei.value.step < 6
    assert ckpt.latest_step(seg_dir) == ei.value.step
    _, state, _ = pipeline.stage2_segsr(cfg, dataset=_dataset(),
                                        device="cpu")
    assert state.step == 6 and ckpt.latest_step(seg_dir) == 6


def test_profile_window_and_distillation(tmp_path):
    """Six distilled steps with the device augmentation and a profile of
    steps 5-10 (the loop ends inside the window)."""
    seg_path = _tree(tmp_path)
    cfg = _config(Config, tmp_path, seg_path, "ckpt", 6,
                  device_augment=True, remat="all", precision="bf16",
                  profile_dir=str(tmp_path / "prof"))
    cfg.enable_distillation = True
    cfg.save_iters_segsr = 100
    cfg.num_slices = 4
    _, state, _ = pipeline.stage2_segsr(cfg, dataset=_dataset(),
                                        device="cpu")
    assert set(state.params) == {"seg", "distiller"}
    assert state.step == 6
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    log = _log(str(tmp_path / "ckpt"))
    assert np.isfinite(log[-1]["loss"])


def test_warm_start_matches_jax_importer():
    """The same nnUNet state dict through both importers lands the same
    weights; the < 90 % rule fails loudly in both unless allowed."""
    sd = {"module." + k: v for k, v in _nnunet_state_dict(4).items()}
    # the all_modules aliases of nnUNet's ConvDropoutNormReLU
    sd = {k.replace(".convs.0.conv.", ".convs.0.all_modules.0."): v
          for k, v in sd.items()}
    jparams = convert.random_flax_params(SMALL_ARCH, 9)
    jparams, loaded, jrep = jimport.import_segmodel(
        jparams, {k: v.numpy() for k, v in sd.items()}, SMALL_ARCH,
        verbose=False)
    model = SegModel(2, 4, arch=SMALL_ARCH)
    rep = torch_import.import_segmodel(model, sd, verbose=False)
    assert rep.match_rate == pytest.approx(jrep.match_rate)
    assert sorted(rep.loaded_keys) == sorted(loaded)
    assert sorted(rep.unconsumed) == sorted(jrep.unconsumed)
    want = convert.state_dict_from_flax(jparams, SMALL_ARCH)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    junk = {f"other.{i}.weight": np.ones((3, 3)) for i in range(200)}
    junk.update({k: v.numpy() for k, v in list(sd.items())[:40]})
    with pytest.raises(ValueError, match="matched only"):
        jimport.import_segmodel(convert.random_flax_params(SMALL_ARCH, 9),
                                junk, SMALL_ARCH, verbose=False)
    with pytest.raises(ValueError, match="matched only"):
        torch_import.import_segmodel(
            model, {k: torch.as_tensor(v) for k, v in junk.items()},
            verbose=False)
    rep = torch_import.import_segmodel(
        model, {k: torch.as_tensor(v) for k, v in junk.items()},
        verbose=False, allow_partial=True)
    assert rep.match_rate < 0.9


@pytest.mark.parametrize("extra", [{"mesh_spatial": 2},
                                   {"mesh_spatial": 4, "loader_workers": 2}])
def test_unported_options_raise(tmp_path, extra):
    """The name is the one this test had while spatial sharding raised:
    ``extra.mesh_spatial`` now trains (with the worker loader too), each
    patch's H over that many names of the CPU, and logs the loss the
    unsharded run logs (1e-5) with the same validation dice."""
    seg_path = _tree(tmp_path)
    logs = {}
    for name, ex in (("sharded", extra),
                     ("whole", {**extra, "mesh_spatial": 1})):
        cfg = _config(Config, tmp_path, seg_path, name, 1, **ex)
        sparse.reset_record()
        _, state, best = pipeline.stage2_segsr(
            cfg, dataset=_dataset(device_augment=False), device="cpu")
        assert state.step == 1
        sharded = [rows for _, rows in sparse.RECORD if len(rows) > 1]
        assert (len(sharded) > 0) == (name == "sharded")
        logs[name] = (_log(str(tmp_path / name)), best)
    (got, got_best), (want, want_best) = logs["sharded"], logs["whole"]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        if "loss" in w:
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
    assert got_best == pytest.approx(want_best, rel=1e-3, abs=1e-3)