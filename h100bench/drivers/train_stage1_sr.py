"""Driver ``train_stage1_sr``: stage-1b FLAVR training steps, by this
driver's own copy of the per-step body of the program's stage-1 loop
(``pipeline._train_sr_loop``), since that loop runs a fixed number of steps
and saves a checkpoint at its end. What the program's loop adds around the
body (upload, logging, saves, the preemption guard) is not measured here.

Each step: ``DeviceSRPatchSampler.next`` gathers a batch from subjects
resident on the card, ``augment_sr_hr_batch`` augments the HR image's
intensity, ``simulate_lr_batch`` makes the LR input, and the step of
``make_sr_train_step`` runs forward, backward and ``onecycle_adam``'s
update.

Traffic keys: ``batch``, ``subjects`` and ``subject_shape`` (X, Y, Z) of
the stage-1a stores made in set-up from the seed, ``precision``,
``max_lr``, ``total_steps``, ``sim_seed`` / ``aug_seed`` offsets of the
device generators from the run's seed.

Correctness: set-up drives the state through its first three steps by the
window's own call; the plain reference (``reference.sr_train``, fp32,
TF32 off) follows them from the same stores, weights and draws. Compared:
each step's loss, the first gradient (from Adam's first moment after step
one) and the parameters' change after step three, by the worst leaf.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import count
from ..reference import flavr as ref_flavr
from ..reference import lowp
from ..reference import sr_train
from ..weights import seeded_state, shapes_of

CHECK_STEPS = 3


def make_stores(seed: int, n: int, shape, device) -> list:
    """``n`` stage-1a stores (img (X, Y, Z), label, the image blurred
    along x, along y), in [0, 1], drawn on the device from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    x, y, z = shape
    coarse = torch.rand((n, 1, max(x // 12, 2), max(y // 12, 2),
                         max(z // 8, 2)), generator=gen, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(x, y, z),
                                          mode="trilinear",
                                          align_corners=False)
    img = img + 0.05 * torch.randn(img.shape, generator=gen, device=device)
    lo = img.amin((2, 3, 4), keepdim=True)
    img = (img - lo) / (img.amax((2, 3, 4), keepdim=True) - lo)
    label = (img > 0.55).float()
    k = torch.ones(1, 1, 5, 1, 1, device=device) / 5
    bx = torch.nn.functional.conv3d(img, k, padding=(2, 0, 0))
    by = torch.nn.functional.conv3d(img, k.transpose(2, 3), padding=(0, 2, 0))
    out = torch.stack([img, label, bx, by], 1)[:, :, 0]   # (n, 4, X, Y, Z)
    return [tuple(a for a in v) for v in out.cpu().numpy()]


def model_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = shapes_of(ref_flavr.UNet3D.from_config(cfg))
    return seeded_state(shapes, seed, device)


class TrainStage1SR:
    def __init__(self, cell, seed: int, device, clock):
        from rehrseg_tpu_torch.data.datasets import SRPatchDataset
        from rehrseg_tpu_torch.data.device_sampler import DeviceSRPatchSampler
        from rehrseg_tpu_torch.models.flavr import UNet3D
        from rehrseg_tpu_torch.train.optim import onecycle_adam
        from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step
        from rehrseg_tpu_torch.train.state import TrainState

        self.cell, self.seed, self.device = cell, int(seed), device
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.batch = int(tr["batch"])
        self.sep = float(cfg["slice_separation"])
        with torch.device("meta"):
            model = UNet3D(img_channels=cfg["img_channels"],
                           n_inputs=cfg["n_inputs"],
                           n_outputs=cfg["n_outputs"])
        model = model.to_empty(device=device)
        # strict: the program's widths are its own, and weights shaped by
        # the configuration's ``encoder_widths`` fail to load where they
        # differ
        model.load_state_dict(model_weights(cfg, seed, device))
        clock.mark("weights")
        opt, sched = onecycle_adam(model, float(tr["max_lr"]),
                                   int(tr["total_steps"]))
        self.state = TrainState(model, opt, sched)
        self.model = model
        self.step_fn = make_sr_train_step(
            model, enable_uncertainty=False, slice_separation=self.sep,
            num_slices=int(cfg["n_inputs"]), precision=tr["precision"])
        clock.mark("program")
        self.stores = make_stores(seed, int(tr["subjects"]),
                                  tuple(tr["subject_shape"]), device)
        self.patch = model.calc_out_patch_size(
            [cfg["n_inputs"], cfg["patch_size"], cfg["patch_size"]])
        vols = [(im[..., None], lab[..., None],
                 bx.transpose(2, 0, 1)[:, None],
                 by.transpose(2, 1, 0)[:, None])
                for im, lab, bx, by in self.stores]
        ds = SRPatchDataset.from_volumes(
            vols, cfg["slice_thickness"], cfg["target_thickness"],
            self.patch, bool(tr["random_flip"]), blur=True,
            nnunet_transform=False, device_lr_sim=True, channels=2)
        self.loader = DeviceSRPatchSampler(ds, self.batch, seed=self.seed,
                                           device=device)
        self.sim_gen = torch.Generator(device=device).manual_seed(
            self.seed + int(tr["sim_seed"]))
        self.aug_gen = torch.Generator(device=device).manual_seed(
            self.seed + int(tr["aug_seed"]))
        clock.mark("data")
        self.data_wait_s = 0.0
        self.losses, self.first_grad = [], {}
        for i in range(CHECK_STEPS):
            metrics = self.step()
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                # the gradient as the optimizer got it: Adam's first moment
                # after one step is (1 - beta1) g; none where no step ran
                b1 = opt.param_groups[0]["betas"][0]
                self.first_grad = {
                    n: float(opt.state[p]["exp_avg"].norm() / (1 - b1))
                    if "exp_avg" in opt.state.get(p, {}) else 0.0
                    for n, p in model.named_parameters()}
        p0 = model_weights(cfg, seed, device)
        self.change = {n: float((p.detach() - p0[n]).norm())
                       for n, p in model.named_parameters()}
        del p0
        self.sync()
        clock.mark("warmup")
        self.data_wait_s = 0.0
        self.steps_done = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        from rehrseg_tpu_torch.data.device_aug import augment_sr_hr_batch
        from rehrseg_tpu_torch.data.device_sr_sim import simulate_lr_batch

        t = time.perf_counter()
        with torch.profiler.record_function("h100bench.data_wait"):
            lr_b, hr_b = self.loader.next()
        self.data_wait_s += time.perf_counter() - t
        hr_b = augment_sr_hr_batch(self.aug_gen, hr_b)
        lr_b = simulate_lr_batch(self.sim_gen, lr_b, self.sep)
        self.state, metrics = self.step_fn(self.state, lr_b, hr_b)
        return metrics

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        with torch.profiler.record_function("h100bench.window"):
            while True:
                self.step()
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self.sync()
        self.window_s = time.perf_counter() - t0
        self.steps_done = n
        return dict(attempted=n, failed=0, window_s=self.window_s,
                    end_to_end={"train_samples_per_s":
                                n * self.batch / self.window_s})

    def info(self) -> dict:
        return dict(steps_done=self.steps_done, batch=self.batch,
                    data_wait_ms_per_step=1e3 * self.data_wait_s
                    / max(self.steps_done, 1),
                    check_losses=self.losses)

    # ------------------------------------------------------------ per layer

    def step_flops(self) -> int:
        c = self.cfg
        lr_shape = (self.batch, c["n_inputs"], c["patch_size"],
                    c["patch_size"], c["img_channels"])
        return 3 * 2 * count.conv_macs(ref_flavr.UNet3D.from_config(c),
                                       lr_shape)

    # ------------------------------------------------------------ check

    def release(self) -> None:
        self.loader.close()
        self.state = self.model = self.step_fn = self.loader = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, conv_hook=None):
        return sr_train.follow(
            self.cfg, self.tr, self.seed, self.stores,
            model_weights(self.cfg, self.seed, self.device), self.device,
            steps=CHECK_STEPS, conv_hook=conv_hook)

    def check(self) -> list:
        prog = dict(losses=self.losses, first_grad=self.first_grad,
                    change=self.change)
        return sr_train.compare(prog, self._reference())

    def control_check(self) -> list:
        """:meth:`check` of the reference with its convolutions in fp8 put
        in the program's place."""
        return sr_train.compare(self._reference(lowp.fp8_conv_hook),
                                self._reference())


def setup(cell, seed, device, clock):
    return TrainStage1SR(cell, seed, device, clock)
