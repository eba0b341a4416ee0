"""Spatially sharded stage-2 training in the port (``make_seg_train_step(
spatial_devices=)``, ``multihost.place_global`` / ``replicate_any``,
``extra.mesh_spatial``) on the CPU, the CPU named twice:

  - JAX's ``test_spatial_sharded_seg_step`` (tests/test_train.py) with a
    spatial extent of 2: SMALL_ARCH, batch 4 x (4, 32, 32), uncertainty and
    distillation, the sharded step against the port's unsharded step at
    JAX's tolerances (loss rtol / atol 1e-6, parameters rtol 5e-4, atol
    1e-5);
  - JAX's sharded step (a (data 1, spatial 2) mesh, its
    ``place_global`` / ``replicate_any``) on the same weights and batch,
    uncertainty on, no teacher (its compile alone would take most of a
    minute): the loss terms at rtol 1e-4 (tests/test_torch_stage2.py's
    tolerance against JAX) and every parameter after the update within a
    relative norm of 1e-4 (tests/test_torch_train.py's);
  - two steps of ``pipeline.stage2_segsr`` with ``mesh_spatial: 2``
    (device augmentation, remat auto) against the unsharded loop: logged
    losses at 1e-5, the same dice at 1e-3;
  - a 2-rank gloo cluster whose ranks each step H-sharded over two names
    of the CPU (tests/torch_dp_worker.py), against one process stepping
    the global batch unsharded: losses, gradients and parameters within
    1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.parallel import make_mesh as jax_make_mesh
from rehrseg_tpu.parallel import multihost as jmh
from rehrseg_tpu.train import optim as joptim
from rehrseg_tpu.train import seg_trainer as jst
from rehrseg_tpu.train.state import TrainState as JaxTrainState
from rehrseg_tpu_torch import pipeline
from rehrseg_tpu_torch.config import Config
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.distiller import Distiller
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.parallel import multihost as mh
from rehrseg_tpu_torch.parallel import spatial as sp
from rehrseg_tpu_torch.train import optim, seg_trainer as st
from rehrseg_tpu_torch.train.state import TrainState
from tests.test_models import SMALL_ARCH
from tests.test_torch_multihost import STEP_TOL, run_cluster
from tests.test_torch_stage2 import _config, _dataset, _log, _tree

torch.set_num_threads(2)

CPU = torch.device("cpu")
PAIR = [CPU, CPU]


def _batch(b=4, d=4, h=32, w=32, seed=0):
    """JAX's test batch: image, LR / HR labels, uncertainty."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, d, h, w, 1)).astype(np.float32)
    lab_lr = (rng.normal(size=(b, d, h, w, 1)) > 0).astype(np.float32)
    lab_hr = (rng.normal(size=(b, d * 4, h, w, 1)) > 0).astype(np.float32)
    unc = rng.uniform(0.5, 1.0, size=(b, d, h, w, 1)).astype(np.float32)
    return img, lab_lr, lab_hr, unc


def _port_step(spatial, kd, seg_np):
    seg = SegModel(2, 4, arch=SMALL_ARCH)
    convert.load_flax_params(seg, seg_np)
    params, flavr = seg, None
    if kd:
        flavr = UNet3D(2, 4, 4)
        convert.load_flax_flavr_params(flavr, convert.random_flavr_params(1),
                                       False)
        dist = Distiller(16, 64)
        convert.load_flax_distiller_params(
            dist, convert.random_distiller_params(2, student_dim=16))
        params = {"seg": seg, "distiller": dist}
    state = TrainState(params, optim.nesterov_sgd(params),
                       optim.poly_epoch_schedule(1e-3, 10, 5))
    step = st.make_seg_train_step(
        seg, enable_uncertainty=True, enable_distillation=kd,
        flavr_model=flavr, spatial_devices=spatial)
    return seg, state, step


def _run(spatial, kd, arrays, seg_np):
    seg, state, step = _port_step(spatial, kd, seg_np)
    batch = st.SegBatch(*(torch.from_numpy(a) for a in arrays))
    if spatial is not None:
        mh.replicate_any(state, spatial)
        batch = mh.place_global(batch, spatial)
    sp.reset_record()
    state, m = step(state, batch)
    return seg, {k: float(v) for k, v in m.items()}, list(sp.RECORD)


def test_spatial_step_matches_unsharded_step():
    seg_np = convert.random_flax_params(SMALL_ARCH, 0)
    arrays = _batch()
    ref, ref_m, _ = _run(None, True, arrays, seg_np)
    got, got_m, rec = _run(PAIR, True, arrays, seg_np)
    assert any(len(rows) == 2 for _, rows in rec)
    assert set(got_m) == set(ref_m) == {"loss", "loss_lr", "loss_hr",
                                        "loss_kd"}
    for k in ref_m:
        assert got_m[k] == pytest.approx(ref_m[k], rel=1e-6, abs=1e-6), k
    for (k, a), (_, b) in zip(ref.state_dict().items(),
                              got.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    # an image that comes whole is split by the step itself
    seg, state, step = _port_step(PAIR, False, seg_np)
    sp.reset_record()
    step(state, st.SegBatch(*(torch.from_numpy(a) for a in arrays)))
    assert any(len(rows) == 2 for _, rows in sp.RECORD)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_spatial_step_matches_jax_sharded_step():
    assert len(jax.devices()) == 8
    seg_np = convert.random_flax_params(SMALL_ARCH, 0)
    arrays = _batch(b=2)
    jseg = JaxSegModel(num_classes=2, upscale=4, arch=SMALL_ARCH)
    tx = joptim.nesterov_sgd(joptim.poly_epoch_schedule(1e-3, 10, 5))
    step = jst.make_seg_train_step(jseg, tx, enable_uncertainty=True,
                                   enable_distillation=False, donate=False)
    mesh = jax_make_mesh(2, spatial=2)
    assert dict(mesh.shape) == {"data": 1, "spatial": 2}
    state = jmh.replicate_any(
        JaxTrainState.create(jax.tree.map(jnp.asarray, seg_np), tx), mesh)
    batch = jst.SegBatch(**jmh.place_global(
        dict(zip(("img", "label_lr", "label_hr", "uncertainty_lr"),
                 arrays)), mesh, P("data", None, "spatial")))
    state, jm = step(state, None, batch)
    want = convert.state_dict_from_flax(
        jax.tree.map(np.asarray, state.params), SMALL_ARCH, False)
    got, tm, _ = _run(PAIR, False, arrays, seg_np)
    for k in ("loss", "loss_lr", "loss_hr"):
        assert tm[k] == pytest.approx(float(jm[k]), rel=1e-4), k
    for k, v in got.state_dict().items():
        assert _rel(v.numpy(), want[k].numpy()) < 1e-4, k


def test_stage2_segsr_mesh_spatial_two_steps(tmp_path):
    seg_path = _tree(tmp_path)
    logs = {}
    for name, s in (("sharded", 2), ("whole", 1)):
        cfg = _config(Config, tmp_path, seg_path, name, 2, mesh_spatial=s,
                      device_augment=True)
        cfg.save_iters_segsr = 2
        sp.reset_record()
        # the sharded run names its group (spatial_devices=)
        _, state, best = pipeline.stage2_segsr(
            cfg, dataset=_dataset(), device="cpu",
            spatial_devices=PAIR if s == 2 else None)
        assert state.step == 2
        assert any(len(r) == 2 for _, r in sp.RECORD) == (s == 2)
        logs[name] = (_log(str(tmp_path / name)), best)
    (got, gbest), (want, wbest) = logs["sharded"], logs["whole"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        if "loss" in w:
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
    assert gbest == pytest.approx(wbest, rel=1e-3, abs=1e-3)


def test_spatial_group_and_deep_supervision_refusal():
    """``spatial_devices=`` must name mesh_spatial devices; deep
    supervision (the module's own forward) has no spatial form."""
    cfg = Config(extra={"mesh_spatial": 2})
    assert pipeline._spatial_group(cfg, CPU) == PAIR
    assert pipeline._spatial_group(cfg, CPU, [CPU, "cpu"]) == PAIR
    assert pipeline._spatial_group(Config(), CPU) is None
    with pytest.raises(ValueError, match="spatial_devices"):
        pipeline._spatial_group(cfg, CPU, [CPU])
    seg = SegModel(2, 4, arch=SMALL_ARCH, deep_supervision=True)
    with pytest.raises(ValueError, match="no spatial form"):
        st.make_seg_train_step(seg, enable_uncertainty=False,
                               enable_distillation=False,
                               deep_supervision=True, spatial_devices=PAIR)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_cluster("stage2_spatial",
                       tmp_path_factory.mktemp("stage2_spatial"))


@pytest.mark.parametrize("kind", ["plain", "kd"])
def test_dp_spatial_step_matches_one_process(ranks, kind):
    a, b = (res[kind] for res in ranks)
    assert a["digest"] == b["digest"]
    for res in (a, b):
        assert res["loss"] == pytest.approx(res["ref_loss"], rel=STEP_TOL)
        assert res["grad_err"] < STEP_TOL, res["grad_err"]
        assert res["param_err"] < STEP_TOL, res["param_err"]
