"""The port's data-parallel stage-2 step on a 2-rank gloo cluster on the
CPU (tests/torch_dp_worker.py): one packed SMALL_ARCH step with
uncertainty, fp32, remat none, plain and distilled (the full-width FLAVR
teacher, the distiller), global batch 4 of (4, 16, 16), each rank stepping
on its 2 rows, against the 1-process step on the global batch from the
same weights: the logged loss (the global batch's mean), every gradient
and the parameters after the update within a relative norm of 1e-5 per
leaf (only the fp32 summation order differs: the seg losses are
per-sample means and the distiller divides by the batch, so the mean of
the ranks' gradients is the global batch's); the parameters equal bit for
bit across ranks.

Then the loop, ``pipeline.stage2_segsr`` on 2 gloo ranks against the same
call in one process over the same global stream, on the tree of
tests/test_torch_stage2.py (two
steps of global batch 4 with the device augmentation, remat auto, one
validation and one save at step 2): the final weights within 1e-5 per
leaf and equal bit for bit across ranks, the logged loss within 1e-5 and
lr equal, the validation dice within 1e-3 (the stage-2 tests' dice
tolerance), the same checkpoints (latest step, ``best`` tag) written by
the primary alone, as many saves as the one process made."""

import json
import os

import pytest

from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_multihost import STEP_TOL, run_cluster
from tests.test_torch_stage2 import _tree
from tests.torch_dp_worker import rel_errors, stage2_loop_run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_cluster("stage2", tmp_path_factory.mktemp("stage2_dp"))


@pytest.mark.parametrize("kind", ["plain", "kd"])
def test_dp_seg_step_matches_one_process(ranks, kind):
    a, b = (res[kind] for res in ranks)
    assert a["digest"] == b["digest"]
    for res in (a, b):
        assert res["loss"] == pytest.approx(res["ref_loss"], rel=STEP_TOL)
        assert res["grad_err"] < STEP_TOL, res["grad_err"]
        assert res["param_err"] < STEP_TOL, res["param_err"]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2_loop")
    _tree(root)
    ranks = run_cluster("stage2_loop", root)
    # the one process reads the ranks' global stream (a BatchLoader with
    # shard=None draws another), as the stage-1 loop's test does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline._mh, "data_shard", lambda: (0, 1))
        one = stage2_loop_run(str(root), "ckpt_one")
    return root, ranks, one


def _metrics(root, ckpt_dir):
    with open(os.path.join(root, ckpt_dir, "segsr", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_dp_stage2_loop_matches_one_process(loop):
    root, (a, b), one = loop
    assert a["digest"] == b["digest"]
    assert a["step"] == b["step"] == one["step"] == 2
    assert a["saves"] == one["saves"] > 0 and b["saves"] == 0
    err = rel_errors(a["weights"], one["weights"])
    assert max(err.values()) < STEP_TOL, max(err, key=err.get)
    dp, ref = _metrics(root, "ckpt_dp"), _metrics(root, "ckpt_one")
    assert [sorted(r) for r in dp] == [sorted(r) for r in ref]
    assert [r["step"] for r in dp] == [r["step"] for r in ref] == [2, 2]
    for d, r in zip(dp, ref):
        if "loss" in r:
            assert d["loss"] == pytest.approx(r["loss"], rel=STEP_TOL)
            assert d["lr"] == r["lr"]
        else:
            assert d["val_dice"] == pytest.approx(r["val_dice"], rel=1e-3,
                                                  abs=1e-3)
    assert a["best"] == b["best"] == pytest.approx(one["best"], rel=1e-3,
                                                   abs=1e-3)
    for d in ("ckpt_dp", "ckpt_one"):
        seg_dir = os.path.join(root, d, "segsr")
        assert ckpt.latest_step(seg_dir) == 2
        assert ckpt.restore_checkpoint_raw(seg_dir, "best")["step"] == 2
