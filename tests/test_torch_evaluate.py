"""The port's fold evaluation against the JAX package's, with the same
numpy-made weights and volumes on the CPU: calculate_dice, the three
branches of evaluate_case_volume, and pipeline.evaluate over synthetic
NIfTI subjects (per-subject and mean dice, bad_cases, the empty-split
error, the saved predictions and their spacing). Both sides run fp32
weights on a bf16-uploaded volume, as a trainer's evaluation does.

Labels are compared as in tests/test_torch_serve.py (equal on at least
99.9 % of voxels: fp32 summation order differs between XLA and PyTorch);
a dice is held to 1e-6 plus what the differing voxels can move it,
3 * n_differing / (sum(pred) + sum(label))."""

import os

import numpy as np
import pytest
import torch

from rehrseg_tpu import pipeline as jpipeline
from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.io import nifti as jnifti
from rehrseg_tpu.losses import calculate_dice as jax_dice
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.io import nifti
from rehrseg_tpu_torch.losses import calculate_dice
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

PATCH = (4, 16, 16)
SHAPE = (3, 14, 24)      # (z, y, x); padded to the patch in z and y


@pytest.fixture(scope="module")
def models():
    """(JAX SegModel, its params, port SegModel) with the same weights."""
    params = convert.random_flax_params(SMALL_ARCH, 11)
    model = SegModel(2, 4, arch=SMALL_ARCH)
    convert.load_flax_params(model, params)
    return JaxSegModel(num_classes=2, upscale=4, arch=SMALL_ARCH), params, \
        model


def _agree(got, want, max_frac=1e-3):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got != want) <= max_frac, np.mean(got != want)


def _dice_close(got, want, pred, ref_pred, label):
    """Returns the tolerance it held the two dice to."""
    n_diff = int(np.sum(pred != ref_pred))
    tol = 1e-6 + 3 * n_diff / (np.sum(pred) + np.sum(label))
    assert abs(got - want) <= tol, (got, want, n_diff)
    return tol


def _case(seed):
    vol = _blob_volume(SHAPE, np.random.default_rng(seed))
    vol += np.linspace(0, 1, SHAPE[2], dtype=np.float32)
    return vol, (vol > 1.5).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_dice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pred = (rng.random((5, 6, 7)) > 0.5).astype(np.uint8)
    lab = (rng.random((5, 6, 7)) > 0.3).astype(np.uint8)
    assert calculate_dice(pred, lab) == jax_dice(pred, lab)
    assert calculate_dice(lab, lab) == pytest.approx(1.0)
    assert calculate_dice(np.zeros(4), np.zeros(4)) == jax_dice(
        np.zeros(4), np.zeros(4)) == 1.0


@pytest.mark.parametrize("branch", ["lr", "hr_model_fn", "dual"])
def test_evaluate_case_volume_matches_jax(models, branch):
    jmodel, params, model = models
    j_lr, j_dual = jpipeline.seg_model_fns(jmodel)
    t_lr, t_dual = pipeline.seg_model_fns(model)
    vol, lab = _case(2)
    kw = dict(slice_separation=4)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if branch == "hr_model_fn":
        jkw["hr_model_fn"] = lambda p, b: j_dual(p, b)[1]
        tkw["hr_model_fn"] = lambda b: t_dual(b)[1]
    elif branch == "dual":
        jkw["dual_model_fn"], tkw["dual_model_fn"] = j_dual, t_dual
    want_lr, want_hr, want_dice = jsw.evaluate_case_volume(
        j_lr, params, vol, lab, PATCH, **jkw)
    lr, hr, dice = tsw.evaluate_case_volume(t_lr, vol, lab, PATCH, **tkw)
    hr_shape = SHAPE if branch == "lr" else (4 * SHAPE[0],) + SHAPE[1:]
    assert lr.shape == SHAPE and hr.shape == hr_shape
    _agree(lr, want_lr)
    _agree(hr, want_hr)
    _dice_close(dice, want_dice, lr, want_lr, lab)
    assert dice == calculate_dice(lr, lab)
    assert tsw.evaluate_case_volume(t_lr, vol, None, PATCH,
                                    device="cpu")[2] is None


def _write_subjects(root, n):
    img_dir, lab_dir = root / "imagesTr", root / "labelsTr"
    img_dir.mkdir()
    lab_dir.mkdir()
    affine = np.diag([0.9, 0.8, 4.0, 1.0])
    affine[:3, 3] = [5.0, -3.0, 1.0]
    subjects = [f"case_{i}" for i in range(n)]
    for i, s in enumerate(subjects):
        vol, lab = _case(10 + i)
        for arr, path in ((vol, img_dir / f"{s}_0000.nii.gz"),
                          (lab, lab_dir / f"{s}.nii.gz")):
            nifti.save(nifti.NiftiImage(data=arr.transpose(2, 1, 0),
                                        affine=affine), str(path))
    return str(img_dir), str(lab_dir), subjects


@pytest.mark.parametrize("eval_hr", [False, True], ids=["lr", "hr"])
def test_evaluate_matches_jax(models, tmp_path, capsys, eval_hr):
    """Three subjects, one skipped as a bad case: per-subject dice, the
    returned mean, and the saved predictions with their geometry."""
    jmodel, params, model = models
    img_dir, lab_dir, subjects = _write_subjects(tmp_path, 3)
    kw = dict(patch_size=PATCH, val_img_path=img_dir,
              val_label_path=lab_dir, split=subjects, slice_separation=4,
              eval_hr=eval_hr, bad_cases=("case_1",))
    want = jpipeline.evaluate(jmodel, params,
                              save_path=str(tmp_path / "jax"), **kw)
    jax_out = capsys.readouterr().out
    got = pipeline.evaluate(model, save_path=str(tmp_path / "port"),
                            device="cpu", **kw)
    out = capsys.readouterr().out
    dice, tols = {}, []
    for line in out.splitlines():
        if line.startswith("Subject "):
            name, value = line[len("Subject "):].split(": ")
            dice[name] = float(value)
    assert list(dice) == ["case_0", "case_2"]
    assert got == pytest.approx(sum(dice.values()) / 2, abs=1e-12)
    assert "Global dice: " in out and "Average dice: " in out
    assert jax_out.count("Subject ") == 2
    for s in ("case_0", "case_2"):
        lab = jnifti.read_image_itk(
            os.path.join(lab_dir, f"{s}.nii.gz")).array
        ref = jnifti.read_image_itk(os.path.join(img_dir, f"{s}_0000.nii.gz"))
        kinds = ("lr", "hr") if eval_hr else ("lr",)
        for kind in kinds:
            name = os.path.join("val", f"{s}_pred_{kind}.nii.gz")
            t = jnifti.read_image_itk(str(tmp_path / "port" / name))
            j = jnifti.read_image_itk(str(tmp_path / "jax" / name))
            _agree(t.array, j.array)
            sep = 4 if kind == "hr" else 1
            assert t.array.shape == (SHAPE[0] * sep,) + SHAPE[1:]
            assert t.GetSpacing() == j.GetSpacing()
            assert t.GetSpacing() == pytest.approx(
                (ref.spacing[0], ref.spacing[1], ref.spacing[2] / sep))
            assert t.GetOrigin() == ref.origin
            assert t.GetDirection() == ref.direction
            if kind == "lr":
                assert dice[s] == calculate_dice(t.array, lab)
                tols.append(_dice_close(dice[s], jax_dice(j.array, lab),
                                        t.array, j.array, lab))
        assert not os.path.exists(
            tmp_path / "port" / "val" / "case_1_pred_lr.nii.gz")
    if not eval_hr:
        assert not os.path.exists(
            tmp_path / "port" / "val" / "case_0_pred_hr.nii.gz")
    assert abs(got - want) <= sum(tols) / len(tols), (got, want)


def test_evaluate_empty_split_raises(models, tmp_path):
    _, _, model = models
    img_dir, lab_dir, subjects = _write_subjects(tmp_path, 1)
    with pytest.raises(ValueError, match="no subjects evaluated"):
        pipeline.evaluate(model, PATCH, img_dir, lab_dir, subjects, 4,
                          bad_cases=tuple(subjects), device="cpu")
    with pytest.raises(ValueError, match="no subjects evaluated"):
        pipeline.evaluate(model, PATCH, img_dir, lab_dir, [], 4,
                          device="cpu")


def test_seg_model_fns_unpacked_matches_packed(models):
    """packed=False runs the module's own forward: the same logits."""
    _, _, model = models
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, *PATCH, 1)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        for got, want in zip(pipeline.seg_model_fns(model, packed=False)[1](x),
                             pipeline.seg_model_fns(model)[1](x)):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
