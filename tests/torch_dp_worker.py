"""One rank of the port's multi-process CPU tests (spawned by
tests/test_torch_multihost.py, tests/test_torch_stage2_dp.py and
tests/test_torch_spatial_train.py; pytest does not collect it):

    python tests/torch_dp_worker.py SCENARIO RANK WORLD PORT OUT_DIR

Each rank forms a gloo group on 127.0.0.1:PORT (one torch thread, a 120 s
collective timeout), runs SCENARIO and writes its results to
OUT_DIR/SCENARIO_rank{RANK}.pt. Imports the port only (no JAX)."""

import copy
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rehrseg_tpu_torch.models import convert  # noqa: E402
from rehrseg_tpu_torch.parallel import multihost as mh  # noqa: E402

WDSR_KW = dict(out_channel=2, n_resblocks=1, num_channels=8, scale=4.0)
SR_BATCH = 4            # WDSR's global batch
FLAVR_BATCH = 2         # FLAVR's global batch
SEG_BATCH = 4           # stage 2's global batch
SEG_ARCH = dict(
    n_stages=4, features_per_stage=(8, 16, 32, 32),
    kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_conv_per_stage=(2, 2, 2, 2), n_conv_per_stage_decoder=(2, 2, 2),
    conv_bias=True, norm_eps=1e-5, norm_affine=True, nonlin_slope=0.01)


def wdsr_batch():
    """The global WDSR batch: LR (4, 4, 16, 2), HR (4, 16, 16, 2), channel
    1 a label in {0, 1}."""
    rng = np.random.default_rng(11)
    lr = rng.uniform(size=(SR_BATCH, 4, 16, 2)).astype(np.float32)
    hr = rng.uniform(size=(SR_BATCH, 16, 16, 2)).astype(np.float32)
    hr[..., 1] = hr[..., 1] > 0.5
    return lr, hr


def flavr_batch():
    rng = np.random.default_rng(12)
    lr = rng.uniform(size=(FLAVR_BATCH, 4, 16, 16, 2)).astype(np.float32)
    hr = rng.uniform(size=(FLAVR_BATCH, 16, 16, 16, 2)).astype(np.float32)
    hr[..., 1] = hr[..., 1] > 0.5
    return lr, hr


def seg_batch():
    rng = np.random.default_rng(13)
    b, d, hw = SEG_BATCH, 4, 16
    img = rng.normal(size=(b, d, hw, hw, 1)).astype(np.float32)
    llr = (rng.normal(size=(b, d, hw, hw, 1)) > 0).astype(np.float32)
    lhr = (rng.normal(size=(b, 4 * d, hw, hw, 1)) > 0).astype(np.float32)
    unc = rng.uniform(0.5, 1.0, size=(b, d, hw, hw, 1)).astype(np.float32)
    return img, llr, lhr, unc


def local_rows(arrays, rank, world):
    per = arrays[0].shape[0] // world
    return [torch.from_numpy(a[rank * per:(rank + 1) * per]) for a in arrays]


def sr_model(kind):
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.models.wdsr import WDSR

    if kind == "wdsr":
        m = WDSR(**WDSR_KW)
        convert.load_flax_wdsr_params(m, convert.random_wdsr_params(
            0, **WDSR_KW))
    else:
        m = UNet3D(2, 4, 4)
        convert.load_flax_flavr_params(m, convert.random_flavr_params(0),
                                       False)
    return m


def sr_state(model, n_steps=2):
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.state import TrainState

    return TrainState(model, *optim.onecycle_adam(model, 1e-3, n_steps))


def grads_of(params):
    return {f"{i}.{k}": p.grad.detach().clone()
            for i, m in enumerate(mh._modules(params))
            for k, p in m.named_parameters() if p.grad is not None}


def weights_of(params):
    return {f"{i}.{k}": v.detach().clone()
            for i, m in enumerate(mh._modules(params))
            for k, v in m.state_dict().items()}


def rel_errors(got, want):
    """Per-leaf relative norm error, a leaf's norm taken at least as 1e-3
    of the whole tree's (tests/test_torch_train.py's rule)."""
    floor = 1e-3 * np.sqrt(sum(float((v.double() ** 2).sum())
                               for v in want.values()))
    out = {}
    for k, w in want.items():
        d = float((got[k].double() - w.double()).norm())
        out[k] = d / max(float(w.double().norm()), floor, 1e-30)
    return out


def sr_dp_step(kind, rank, world):
    """One data-parallel SR step on this rank's rows, and (on every rank,
    without the group's reductions) the 1-process step on the global
    batch from the same weights: the errors between them."""
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step

    lr, hr = wdsr_batch() if kind == "wdsr" else flavr_batch()
    ns = 1 if kind == "wdsr" else 4
    model = sr_model(kind)
    ref_model = copy.deepcopy(model)
    state = sr_state(model)
    step = make_sr_train_step(model, enable_uncertainty=False,
                              slice_separation=4, num_slices=ns)
    state, m = step(state, *local_rows((lr, hr), rank, world))
    grads, weights = grads_of(model), weights_of(model)
    # the 1-process step on the global batch: the loss without the
    # cross-process dice sum, no gradient all-reduce
    ref_state = sr_state(ref_model)
    ref_step = make_sr_train_step(ref_model, enable_uncertainty=False,
                                  slice_separation=4, num_slices=ns)
    loss = ref_step.loss_fn(torch.from_numpy(lr), torch.from_numpy(hr))
    loss.backward()
    ref_state.apply_gradients()
    return dict(loss=float(m["loss"]), ref_loss=float(loss),
                grad_err=max(rel_errors(grads, grads_of(ref_model)).values()),
                param_err=max(rel_errors(weights,
                                         weights_of(ref_model)).values()),
                grads=grads if kind == "wdsr" else None,
                weights=weights if kind == "wdsr" else None,
                digest=digest(weights))


def digest(tree):
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(tree[k].contiguous().numpy().tobytes())
    return h.hexdigest()


class Probe:
    def sample(self, i=None, rng=None):
        return (rng.normal(size=(3,)).astype(np.float32),)


def scenario_multihost(rank, world, out):
    from rehrseg_tpu_torch.data.datasets import BatchLoader
    from rehrseg_tpu_torch.data.device_aug import shard_rows
    from rehrseg_tpu_torch.train import checkpoint as ckpt
    from rehrseg_tpu_torch.utils.metrics import MetricsLogger

    res = dict(multihost=mh.is_multihost(), primary=mh.is_primary(),
               shard=mh.data_shard(),
               rows=shard_rows(torch.arange(8), mh.data_shard()).tolist())
    mh.barrier("start")
    res["broadcast"] = mh.broadcast_scalar(3.5 if rank == 0 else -1.0)
    res["any_one"] = mh.any_flag(rank == 1)
    res["any_none"] = mh.any_flag(False)
    try:
        mh.barrier(f"tag-of-rank-{rank}")
        res["mismatch"] = "passed"
    except RuntimeError as e:
        res["mismatch"] = str(e)
    loader = BatchLoader(Probe(), 8, seed=3, shard=mh.data_shard())
    res["loader"] = [loader.next()[0] for _ in range(2)]
    MetricsLogger(out).log(1, loss=0.5, rank=rank)
    mh.barrier("logged")
    res["wdsr"] = sr_dp_step("wdsr", rank, world)
    res["flavr"] = sr_dp_step("flavr", rank, world)

    # a checkpoint written once (the primary's torch.save) and restored
    # by both
    model = sr_model("wdsr")
    state = sr_state(model)
    saves = []
    real_save = torch.save

    def counting_save(*a, **k):
        saves.append(a[1])
        return real_save(*a, **k)

    torch.save = counting_save
    try:
        state.save(os.path.join(out, "ckpt"), step=1)
    finally:
        torch.save = real_save
    raw = ckpt.restore_checkpoint_raw(os.path.join(out, "ckpt"))
    res["saves"] = len(saves)
    res["restored_equal"] = all(
        torch.equal(raw["params"][k], v)
        for k, v in model.state_dict().items())
    res["loop"] = dp_loop(rank, world, out)
    return res


def wdsr_dataset():
    from rehrseg_tpu_torch.data.datasets import SRPatchDataset
    from rehrseg_tpu_torch.infer.sr_infer import postprocess_sr_volume

    rng = np.random.default_rng(5)
    vols = []
    for _ in range(2):
        img = rng.uniform(size=(24, 24, 12, 1)).astype(np.float32)
        lab = (img > 0.6).astype(np.uint8)
        fx, fy = postprocess_sr_volume(img, 3.87)
        vols.append((img, lab, fx, fy))
    return SRPatchDataset.from_volumes(vols, 4.0, 1.0, (16, 16), True)


def dp_loop(rank, world, out, n_steps=3):
    """``_train_sr_loop(dp_mesh=)`` over 3 WDSR steps of this rank's slice
    of the seeded global stream (BatchLoader(shard=)), a save every 2 and
    a log every step: the final weights."""
    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.data.datasets import BatchLoader, PrefetchLoader
    from rehrseg_tpu_torch.parallel.mesh import make_mesh
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step

    model = sr_model("wdsr")
    # rank 1's weights differ before the loop: its broadcast restores
    # the primary's
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    state = sr_state(model, n_steps)
    step = make_sr_train_step(model, enable_uncertainty=False,
                              slice_separation=4, num_slices=1)
    loader = PrefetchLoader(BatchLoader(wdsr_dataset(), SR_BATCH, seed=4,
                                        shard=mh.data_shard()))
    mesh = make_mesh(devices=[torch.device("cpu")] * world)
    pipeline._train_sr_loop(state, loader, step, n_steps, 2,
                            os.path.join(out, "loop"),
                            device=torch.device("cpu"), log_every=1,
                            dp_mesh=mesh)
    return weights_of(model)


def scenario_stage2(rank, world, out, spatial=None):
    """One data-parallel stage-2 step, plain and distilled (uncertainty
    on, fp32, packed, remat none), against the 1-process step on the
    global batch from the same weights (each rank computes that one
    without the group's reduction, unsharded). spatial: the rank's step
    runs H-sharded over these devices."""
    from rehrseg_tpu_torch.models.distiller import Distiller
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.models.segnet import SegModel
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train import seg_trainer as st
    from rehrseg_tpu_torch.train.state import TrainState

    res = {}
    batch = seg_batch()
    for kd in (False, True):
        seg = SegModel(2, 4, arch=SEG_ARCH)
        convert.load_flax_params(seg, convert.random_flax_params(SEG_ARCH,
                                                                 0))
        params, flavr = seg, None
        if kd:
            flavr = UNet3D(2, 4, 4)
            convert.load_flax_flavr_params(
                flavr, convert.random_flavr_params(1), False)
            dist = Distiller(SEG_ARCH["features_per_stage"][1], 64)
            convert.load_flax_distiller_params(
                dist, convert.random_distiller_params(
                    2, student_dim=SEG_ARCH["features_per_stage"][1]))
            params = {"seg": seg, "distiller": dist}
        ref_params = copy.deepcopy(params)
        sched = optim.poly_epoch_schedule(1e-2, 2, 2)

        def make(p):
            model = p["seg"] if kd else p
            state = TrainState(p, optim.nesterov_sgd(p), sched)
            step = st.make_seg_train_step(
                model, enable_uncertainty=True, enable_distillation=kd,
                flavr_model=flavr, remat=False,
                spatial_devices=spatial if p is params else None)
            return state, step

        state, step = make(params)
        local = st.SegBatch(*local_rows(batch, rank, world))
        if spatial is not None:
            local = mh.place_global(local, spatial)
        state, m = step(state, local)
        grads, weights = grads_of(params), weights_of(params)
        ref_state, ref_step = make(ref_params)
        loss, _ = ref_step.loss_fn(
            ref_params, st.SegBatch(*(torch.from_numpy(a) for a in batch)))
        loss.backward()
        ref_state.apply_gradients()
        res["kd" if kd else "plain"] = dict(
            loss=float(m["loss"]), ref_loss=float(loss),
            grad_err=max(rel_errors(grads, grads_of(ref_params)).values()),
            param_err=max(rel_errors(weights,
                                     weights_of(ref_params)).values()),
            digest=digest(weights))
    return res


def stage2_loop_config(root, ckpt_dir):
    """The stage-2 loop's config over the tree of tests/test_torch_stage2.py
    under ``root`` (validation NIfTIs, nnUNet splits and warm start):
    SEG_ARCH, fp32, device augmentation, remat auto, global batch 4, two
    steps with one validation and one save (at step 2)."""
    from rehrseg_tpu_torch.config import Config

    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in SEG_ARCH.items()}
    return Config(
        data_path=os.path.join(root, "imagesTr"),
        tmp_path=os.path.join(root, "tmp"),
        checkpoint_path=os.path.join(root, ckpt_dir),
        seg_path=os.path.join(root, "nnUNet_results", "DS", "trainer"),
        slice_thickness=4.0, target_thickness=1.0, random_flip=True,
        enable_uncertainty=True, batch_size_segsr=SEG_BATCH, lr_segsr=1e-2,
        epochs=2, save_iters_segsr=2, enable_distillation=False, fold=0,
        extra={"arch_override": arch, "patch_size_zyx": [4, 16, 16],
               "precision": "fp32", "device_augment": True,
               "eval_mirror": False})


def stage2_loop_dataset():
    """Two seeded (84, 84, 20) volumes with labels and uncertainty."""
    from rehrseg_tpu_torch.data.datasets import SegSRDataset

    rng = np.random.default_rng(1)
    vols = []
    for _ in range(2):
        img = rng.normal(size=(84, 84, 20)).astype(np.float32)
        vols.append((img, (img > 0.4).astype(np.float32),
                     rng.uniform(0, 255, size=img.shape).astype(np.float32)))
    return SegSRDataset.from_volumes(vols, 4.0, 1.0, (80, 80, 4),
                                     (16, 16, 4), random_flip=True,
                                     uncertainty=True, device_augment=True)


def stage2_loop_run(root, ckpt_dir):
    """``pipeline.stage2_segsr`` on the CPU with :func:`stage2_loop_config`
    and :func:`stage2_loop_dataset`, counting this process's torch.save
    calls: the final weights, the step, the best dice, the saves."""
    from rehrseg_tpu_torch import pipeline

    saves = []
    real_save = torch.save

    def counting_save(*a, **k):
        saves.append(a[1])
        return real_save(*a, **k)

    torch.save = counting_save
    try:
        seg, state, best = pipeline.stage2_segsr(
            stage2_loop_config(root, ckpt_dir),
            dataset=stage2_loop_dataset(), device="cpu")
    finally:
        torch.save = real_save
    weights = weights_of(seg)
    return dict(weights=weights, digest=digest(weights),
                step=int(state.step), best=float(best), saves=len(saves))


def scenario_stage2_loop(rank, world, out):
    """The data-parallel ``stage2_segsr`` (remat probed on the primary and
    broadcast, evaluation on the primary, the dice broadcast, checkpoints
    and metrics written by the primary, the stop flag agreed) over the
    tree the test wrote in ``out``."""
    return stage2_loop_run(out, "ckpt_dp")


def scenario_stage2_spatial(rank, world, out):
    """:func:`scenario_stage2` with each rank's step H-sharded over two
    names of the CPU (``extra.mesh_spatial: 2`` under two processes)."""
    cpu = torch.device("cpu")
    return scenario_stage2(rank, world, out, spatial=[cpu, cpu])


SCENARIOS = {"multihost": scenario_multihost, "stage2": scenario_stage2,
             "stage2_loop": scenario_stage2_loop,
             "stage2_spatial": scenario_stage2_spatial}


def main():
    scenario, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from rehrseg_tpu_torch.parallel.distributed import init_distributed

    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            backend="gloo", timeout_s=120.0)
    res = SCENARIOS[scenario](rank, world, out)
    torch.save(res, os.path.join(out, f"{scenario}_rank{rank}.pt"))
    mh.barrier("done")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
