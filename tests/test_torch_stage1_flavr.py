"""The port's stages 1b and 1c against the JAX package's ``Pipeline`` on
tests/test_pipeline_e2e.py's phantom, on the CPU, fp32, host LR
simulation and host transforms, both warm-started from one synthetic
reference-keyed FLAVR checkpoint (``pretrain_path``, written here): the
logged losses (rtol 1e-4), the ``_img`` / ``_uncertainty`` NIfTIs
(test_torch_sr's TOL; ``_seg`` labels on >= 99.9 % of voxels), the
stage-2 stores; a rerun that trains and writes nothing. (The importers
are in tests/test_torch_sr_train.py, stage 1b through ``dataset=`` on the
device path in tests/test_torch_stage1.py.)"""

import os
import shutil

import numpy as np
import pytest
import torch

from rehrseg_tpu import pipeline as jpipeline
from rehrseg_tpu.pipeline import Pipeline
from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.io import nifti
from tests.test_torch_sr import TOL
from tests.test_torch_sr_train import _reference_flavr_sd
from tests.test_torch_stage1 import (configs, h5, losses, mtimes, phantom,
                                     seeded_init)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines through stages 0, 1a (interpolation), 1b, 1c and the
    stage-2 stores; the port's printed lines."""
    root = tmp_path_factory.mktemp("stage1_flavr")
    phantom(root)
    torch.save({"state_dict": _reference_flavr_sd(5)},
               str(root / "FLAVR_4x.pth"))
    jc, tc = configs(root)
    for c in (jc, tc):
        c.pretrain_path = str(root / "FLAVR_4x.pth")
        c.nnunet_transform = True
    with pytest.MonkeyPatch.context() as mp:
        seeded_init(mp)
        # the JAX loop's batches straight from its BatchLoader: the same
        # stream as through its prefetch thread, whose close waits on the
        # worker for seconds here
        mp.setattr(jpipeline, "PrefetchLoader", lambda loader: loader)
        jp = Pipeline(jc)
        jp.preprocess()
        jp.stage1a_smore()
        jp.stage1b_flavr()
        jp.stage1c_uncertainty()
        jp.postprocess_flavr()
    from contextlib import redirect_stdout
    from io import StringIO

    out = StringIO()
    with redirect_stdout(out):
        pipeline.preprocess(tc)
        pipeline.stage1a_smore(tc, device="cpu")
        _, s1b = pipeline.stage1b_flavr(tc, device="cpu")
        _, s1c = pipeline.stage1c_uncertainty(tc, device="cpu")
        pipeline.postprocess_flavr(tc)
    assert s1b.step == 2 and s1c.step == 1
    yield root, jc, tc, out.getvalue()
    shutil.rmtree(root)     # a UNet3D checkpoint with Adam's moments: 0.5 GB


def test_stages_1b_1c_match_jax(runs):
    root, jc, tc, printed = runs
    assert "FLAVR warm start: loaded" in printed
    for d in ("flavr", "flavr_uncertainty"):
        jl = [r for r in losses(os.path.join(jc.checkpoint_path, d))
              if "loss" in r]
        tl = [r for r in losses(os.path.join(tc.checkpoint_path, d))
              if "loss" in r]
        assert [r["step"] for r in tl] == [r["step"] for r in jl] == [0]
        assert tl[0]["loss"] == pytest.approx(jl[0]["loss"], rel=1e-4), d
    tp, jp = (os.path.join(c.tmp_path, "flavr_output") for c in (tc, jc))
    for s in ("sub1_0000", "sub2_0000"):
        for suf in ("_img", "_uncertainty", "_seg"):
            a = nifti.read_image_itk(os.path.join(tp, s + suf + ".nii.gz"))
            b = nifti.read_image_itk(os.path.join(jp, s + suf + ".nii.gz"))
            assert a.array.shape == b.array.shape == (28, 24, 24)
            assert a.spacing == b.spacing == (1.0, 1.0, 1.0)
            if suf == "_seg":
                assert np.mean(a.array == b.array) >= 0.999
            else:
                np.testing.assert_allclose(a.array, b.array, **TOL)
        da, db = (h5(os.path.join(c.tmp_path, "data_merged_segsr_h5",
                                  s + ".h5")) for c in (tc, jc))
        np.testing.assert_allclose(da["img"], db["img"], rtol=1e-4,
                                   atol=1e-2)      # 0-255 scale
        assert np.mean(da["seg"] == db["seg"]) >= 0.999
        # the map is truncated to uint8: one step apart at most
        assert np.abs(da["uncertainty"].astype(int)
                      - db["uncertainty"].astype(int)).max() <= 1


def test_rerun_trains_and_writes_nothing(runs, capsys):
    root, _, tc, _ = runs
    before = mtimes(root / "ttmp")
    logs = {d: losses(os.path.join(tc.checkpoint_path, d))
            for d in ("flavr", "flavr_uncertainty")}
    _, s1b = pipeline.stage1b_flavr(tc, device="cpu")
    _, s1c = pipeline.stage1c_uncertainty(tc, device="cpu")
    out = capsys.readouterr().out
    assert "NETWORK FLAVR TRAINED, LOADING LAST WEIGHTS" in out
    assert "TRAINING" not in out
    assert (s1b.step, s1c.step) == (2, 1)
    assert mtimes(root / "ttmp") == before
    assert {d: losses(os.path.join(tc.checkpoint_path, d))
            for d in logs} == logs
