"""Time the stage-2 step, unsharded and H-sharded, of two trees in turns on
one card.

    python -m rehrseg_tpu_torch.compare_spatial_step PARENT_DIR
                                                     [--order pccp]
                                                     [--out FILE]

``PARENT_DIR`` holds another checkout of the repo (for example ``git
archive <commit> | tar -x -C build/parent``); the change is the tree this
module was imported from. Each letter of ``--order`` runs :func:`step_times`
in a process of its own from that tree's root (p: parent, c: change;
``compare_k2.run_tree``), so the process imports that tree's package.
:func:`step_times` is also chip_smoke ``spatial_train``'s timing, with its
seeds. Both blocks of the sharded step run on the one card, so its time
over the unsharded step's is the blocks' overhead, not a scaling number;
the sharded step is paced by the host's launches, which is why the two
trees must run in one call. Prints one JSON line: the card, every run's ms
a step, each tree's sharded / unsharded ratio and the ratio change /
parent of the mean times. Exits with 1 if a run failed.
"""

from __future__ import annotations

import sys

from .compare_k2 import compare


def step_times(chain=8, rounds=2, kd=(False, True), seed=0, batch_seed=70,
               teacher_seeds=(8, 9), shape=(2, 16, 256, 320)):
    """The bf16 stage-2 step (DEFAULT_ARCH with the weights of ``seed``,
    B x (D, H, W) = ``shape``, a seeded normal image, its labels above 0.5,
    uncertainty, remat "hires") on cuda:0 and on a spatial group of cuda:0
    named twice, without and (``kd``) with distillation (the full-width
    UNet3D teacher and the Distiller of ``teacher_seeds``), each config
    timed over a chain of ``chain`` steps after 2 warm-up steps, in
    ``rounds`` rounds (every other one in reverse order). Returns {"card",
    config: {"ms": [one per round], "peak_mem_gb", "losses"}} with configs
    "single", "spatial2", "single_kd", "spatial2_kd". Imports inside, so
    that it runs as it is in another tree."""
    import torch
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.distiller import Distiller
    from rehrseg_tpu_torch.models.flavr import UNet3D
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH, SegModel
    from rehrseg_tpu_torch.parallel import multihost as mh
    from rehrseg_tpu_torch.train import optim
    from rehrseg_tpu_torch.train.seg_trainer import (SegBatch,
                                                     make_seg_train_step)
    from rehrseg_tpu_torch.train.state import TrainState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params = convert.random_flax_params(DEFAULT_ARCH, seed)
    g = torch.Generator(device=dev).manual_seed(batch_seed)
    img = torch.randn(*shape, 1, generator=g, device=dev)
    label = (img > 0.5).float()
    unc = 0.01 + 0.99 * torch.rand(img.shape, generator=g, device=dev)
    batch = SegBatch(img, label, label.repeat_interleave(4, dim=1), unc)
    out = {"card": torch.cuda.get_device_name(0)}
    configs = [(f"{name}{'_kd' if k else ''}", group, k) for k in kd
               for name, group in (("single", None),
                                   ("spatial2", [dev, dev]))]
    for r in range(rounds):
        for key, group, k in configs[::-1] if r % 2 else configs:
            seg = SegModel(2, 4, arch=DEFAULT_ARCH)
            convert.load_flax_params(seg, params)
            seg.to(dev)
            train_params, teacher = seg, None
            if k:
                teacher = UNet3D(2, 4, 4)
                convert.load_flax_flavr_params(
                    teacher, convert.random_flavr_params(teacher_seeds[0]),
                    False)
                dim = DEFAULT_ARCH["features_per_stage"][1]
                dist = Distiller(dim, 64)
                convert.load_flax_distiller_params(
                    dist, convert.random_distiller_params(
                        teacher_seeds[1], student_dim=dim))
                teacher.to(dev)
                train_params = {"seg": seg, "distiller": dist.to(dev)}
            state = TrainState(train_params,
                               optim.nesterov_sgd(train_params),
                               optim.poly_epoch_schedule(1e-2, 100, 1))
            step = make_seg_train_step(
                seg, enable_uncertainty=True, enable_distillation=k,
                flavr_model=teacher, remat="hires", precision="bf16",
                spatial_devices=group)
            b = batch if group is None else mh.place_global(batch, group)
            for _ in range(2):
                state, _ = step(state, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                state, m = step(state, b)
            end.record()
            torch.cuda.synchronize()
            rec = out.setdefault(key, {"ms": []})
            rec["ms"].append(start.elapsed_time(end) / chain)
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["losses"] = {n: float(v) for n, v in m.items()}
            del seg, state, step, train_params, teacher
            torch.cuda.empty_cache()
    return out


def _summary(runs) -> dict:
    def mean(tree, key):
        v = [ms for t, r in runs if t == tree for ms in r[key]["ms"]]
        return sum(v) / len(v) if v else None

    result = {"runs": [{"tree": t, **{k: v["ms"] for k, v in r.items()
                                      if k != "card"}} for t, r in runs]}
    for key in ("single", "spatial2", "single_kd", "spatial2_kd"):
        p, c = mean("p", key), mean("c", key)
        result[f"{key} change_over_parent"] = (c / p if p and c else None)
    for tree in "pc":
        for kd in ("", "_kd"):
            s, u = mean(tree, f"spatial2{kd}"), mean(tree, f"single{kd}")
            result[f"{tree} spatial2{kd}_over_single{kd}"] = (
                s / u if s and u else None)
    return result


def main(argv=None) -> int:
    return compare(step_times, _summary, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    sys.exit(main())
