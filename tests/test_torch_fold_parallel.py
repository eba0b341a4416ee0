"""The port's fold-parallel training against the JAX package's on the CPU:
the fold-parallel step over K = 2 and 4 folds (one WDSR per fold from its
own seeded params, a batch each; the CPU named K times, as XLA's forced
host device count gives JAX its devices) against JAX's
``make_fold_parallel_step`` (losses rtol 1e-5, parameters a relative norm
of 1e-4 per leaf, tests/test_torch_sr_train's NORM_TOL), and each fold
equal bit for bit to one plain step of that fold;
``stage2_segsr_all_folds`` against ``Pipeline.stage2_segsr_all_folds`` as
tests/test_torch_stage2.py drives ``stage2_segsr`` (two folds of nnUNet's
splits, each warm-started from its own checkpoint, SMALL_ARCH, fp32, host
augmentation: the per-fold logged losses at rtol 1e-4 and validation dice
at 1e-3, the per-fold checkpoint directories), then a resume from the larger of unequal fold steps; fewer
devices than folds raising; ``cli.main(["--fold", "all", "--device",
"cpu"])`` on a tiny config (stages 0-1 once, then both folds)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch import cli, pipeline
from rehrseg_tpu_torch.config import Config
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.wdsr import WDSR
from rehrseg_tpu_torch.parallel import fold_parallel as fp
from rehrseg_tpu_torch.train import checkpoint as ckpt
from rehrseg_tpu_torch.train import optim, sr_trainer
from rehrseg_tpu_torch.train.state import TrainState
from tests.test_torch_train import NORM_TOL, _rel

torch.set_num_threads(2)

WDSR_KW = dict(out_channel=2, n_resblocks=1, num_channels=8, scale=4.0)
CPU = torch.device("cpu")


def _fold_inputs(k_folds):
    """Per fold: seeded WDSR params and a (lr, hr) batch of 2."""
    rng = np.random.default_rng(k_folds)
    params = [convert.random_wdsr_params(k, **WDSR_KW)
              for k in range(k_folds)]
    lr = rng.uniform(size=(k_folds, 2, 8, 16, 2)).astype(np.float32)
    hr = rng.uniform(size=(k_folds, 2, 32, 16, 2)).astype(np.float32)
    hr[..., 1] = hr[..., 1] > 0.5
    return params, lr, hr


def _port_fold(p_np):
    model = WDSR(**WDSR_KW)
    convert.load_flax_wdsr_params(model, p_np)
    state = TrainState(model, *optim.onecycle_adam(model, 1e-3, 10))
    step = sr_trainer.make_sr_train_step(model, enable_uncertainty=False,
                                         slice_separation=4, num_slices=1)
    return model, state, step


def _sd(tree):
    m = WDSR(**WDSR_KW)
    convert.load_flax_wdsr_params(m, tree)
    return m.state_dict()


@pytest.mark.parametrize("k_folds", [2, 4])
def test_fold_parallel_step_matches_jax(k_folds):
    import jax
    import jax.numpy as jnp

    from rehrseg_tpu.models import WDSR as JaxWDSR
    from rehrseg_tpu.parallel import fold_parallel as jfp
    from rehrseg_tpu.train import (TrainState as JaxTrainState,
                                   make_sr_train_step, onecycle_adam)

    params, lr, hr = _fold_inputs(k_folds)
    tx, _ = onecycle_adam(1e-3, 10)
    jmesh = jfp.make_fold_mesh(k_folds)
    jstates = [JaxTrainState.create(jax.tree.map(jnp.asarray, p), tx)
               for p in params]
    stacked = jfp.place_fold_state(jfp.stack_fold_states(jstates), jmesh)
    jstep = make_sr_train_step(JaxWDSR(**WDSR_KW), tx,
                               enable_uncertainty=False, slice_separation=4,
                               num_slices=1, donate=False,
                               precision="fp32")
    with jmesh:
        stacked, jm = jfp.make_fold_parallel_step(jstep, jmesh)(
            stacked, *jfp.place_fold_batch((lr, hr), jmesh))
    jlosses = np.asarray(jm["loss"])
    jfolds = jfp.unstack_fold_state(stacked, k_folds)

    mesh = fp.make_fold_mesh(k_folds, devices=[CPU] * k_folds)
    folds = [_port_fold(p) for p in params]
    states = [f[1] for f in folds]
    step = fp.make_fold_parallel_step([f[2] for f in folds], mesh)
    batches = [(torch.from_numpy(lr[k]), torch.from_numpy(hr[k]))
               for k in range(k_folds)]
    states, metrics = step(states, batches)
    assert [s.step for s in states] == [1] * k_folds
    losses = [float(m["loss"]) for m in metrics]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(np.unique(np.round(losses, 6))) == k_folds
    for k in range(k_folds):
        want = _sd(jax.tree.map(np.asarray, jfolds[k].params))
        for name, v in folds[k][0].state_dict().items():
            assert _rel(v.numpy(), want[name].numpy()) < NORM_TOL, name
        # the fold's state equals one plain step of that fold
        model, state, plain = _port_fold(params[k])
        plain(state, *batches[k])
        for name, v in model.state_dict().items():
            assert torch.equal(v, folds[k][0].state_dict()[name]), name


def test_fold_mesh_needs_a_device_per_fold(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(AssertionError, match="need 2 devices, have 1"):
        fp.make_fold_mesh(2)
    assert fp.make_fold_mesh(2, devices=[CPU, CPU]).shape["data"] == 2
    step = fp.make_fold_parallel_step(lambda s, x: (s, {}),
                                      fp.make_fold_mesh(1, devices=[CPU]))
    with pytest.raises(ValueError, match="1 states and batches"):
        step([1, 2], [(0,), (0,)])


# ------------------------------------------------------------ all folds

def _two_folds(root):
    """tests/test_torch_stage2.py's tree with nnUNet splits of two folds,
    each fold warm-started from its own nnUNet checkpoint (the packages'
    seeded initializations differ; the warm start makes them equal)."""
    from tests.test_torch_stage2 import (TRAIN, VAL, _nnunet_state_dict,
                                         _tree)

    seg_path = _tree(root)
    os.makedirs(os.path.join(seg_path, "fold_1"))
    torch.save({"network_weights": _nnunet_state_dict(1)},
               os.path.join(seg_path, "fold_1", "checkpoint_final.pth"))
    (root / "nnUNet_preprocessed" / "DS" / "splits_final.json").write_text(
        json.dumps([{"train": TRAIN, "val": VAL},
                    {"train": TRAIN[::-1], "val": VAL}]))
    return seg_path


def _log(ckpt_dir):
    with open(os.path.join(ckpt_dir, "segsr_folds", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_all_folds_match_jax_and_resume_from_max(tmp_path, capsys):
    from rehrseg_tpu.config import Config as JaxConfig
    from rehrseg_tpu.pipeline import Pipeline
    from tests.test_torch_stage2 import _config

    seg_path = _two_folds(tmp_path)
    jcfg = _config(JaxConfig, tmp_path, seg_path, "ckpt_jax", 1)
    jcfg.fold = "all"
    Pipeline(jcfg).stage2_segsr_all_folds()
    cfg = _config(Config, tmp_path, seg_path, "ckpt_port", 1)
    cfg.fold = "all"
    segs, states, best = pipeline.stage2_segsr_all_folds(cfg, device="cpu")
    assert [s.step for s in states] == [1, 1] and len(segs) == 2
    jlog, tlog = _log(str(tmp_path / "ckpt_jax")), _log(
        str(tmp_path / "ckpt_port"))
    for key in ("loss_fold0", "loss_fold1"):
        j = [r[key] for r in jlog if key in r]
        t = [r[key] for r in tlog if key in r]
        assert len(t) == len(j) == 1
        assert t[0] == pytest.approx(j[0], rel=1e-4)
    for k in range(2):
        key = f"val_dice_fold{k}"
        j = [r[key] for r in jlog if key in r]
        t = [r[key] for r in tlog if key in r]
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)
        assert best[k] == pytest.approx(max(t[0], 0.0))
        d = str(tmp_path / "ckpt_port" / f"segsr_fold{k}")
        assert ckpt.latest_step(d) == 1
    losses = [r[f"loss_fold{k}"] for r in tlog for k in range(2)
              if f"loss_fold{k}" in r]
    assert losses[0] != losses[1]
    # a torn save: fold 1 has no checkpoint, so the folds resume from 1
    shutil.rmtree(tmp_path / "ckpt_port" / "segsr_fold1")
    capsys.readouterr()
    cfg.epochs = 2
    _, states, _ = pipeline.stage2_segsr_all_folds(cfg, device="cpu")
    out = capsys.readouterr().out
    assert ("WARNING: unequal fold checkpoint steps [1, 0]; resuming from "
            "max") in out
    assert [s.step for s in states] == [2, 1]
    for k in range(2):
        d = str(tmp_path / "ckpt_port" / f"segsr_fold{k}")
        assert ckpt.latest_step(d) == 2


def test_cli_fold_all(tmp_path, capsys):
    """``--fold all`` through the CLI on the CPU: stages 0-1 once (the zoom
    fallback, one FLAVR step), then both synthetic folds' stage 2."""
    from tests.test_pipeline_e2e import TINY_ARCH
    from tests.test_torch_stage1 import configs, phantom

    phantom(tmp_path)
    _, tc = configs(tmp_path)
    cfg = {k: getattr(tc, k) for k in Config.__dataclass_fields__}
    cfg["extra"]["arch_override"] = dict(TINY_ARCH)
    cfg.update(enable_uncertainty=False, enable_distillation=False,
               n_patches=2)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    segs, states, best = cli.main(["--config", str(path), "--fold", "all",
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "TRAINING NETWORK FLAVR" in out
    assert "TRAINING NETWORK REHRSeg x2 folds" in out
    assert len(segs) == 2 and [s.step for s in states] == [1, 1]
    assert len(best) == 2 and all(0.0 <= b <= 1.0 for b in best)
    for k in range(2):
        assert ckpt.latest_step(str(tmp_path / "tckpt" / f"segsr_fold{k}")) \
            == 1
    shutil.rmtree(tmp_path / "tckpt")
