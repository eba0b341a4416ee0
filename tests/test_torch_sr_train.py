"""The port's stage-1 SR training against the JAX package's on the same
numpy-made params and batches, on the CPU: the SR losses with both channel
counts (rtol 1e-6), ``crop_hr_target``, two steps each of WDSR (1 residual
block, 4 channels), FLAVR plain and FLAVR UASR against
``make_sr_train_step`` + ``onecycle_adam`` (the loss, every gradient
through the weight bridges and the parameters after each step, a relative
norm of 1e-4 per leaf, ``test_torch_train``'s NORM_TOL);
``_train_sr_loop``'s saves, logs, preemption and resume; the FLAVR / UASR / WDSR warm-start
importers against JAX's on one reference-keyed state dict. The bf16 steps
(against fp32, and their determinism on the CPU) are in
tests/test_torch_train_cpu_bf16.py."""

import copy
import functools
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu import losses as jlosses
from rehrseg_tpu.models import UNet3D as JaxUNet3D
from rehrseg_tpu.models import WDSR as JaxWDSR
from rehrseg_tpu.train import optim as joptim
from rehrseg_tpu.train import sr_trainer as jsr
from rehrseg_tpu.train import torch_import as jimport
from rehrseg_tpu.train.state import TrainState as JaxTrainState
from rehrseg_tpu_torch import losses, pipeline
from rehrseg_tpu_torch.data.datasets import BatchLoader, SRPatchDataset
from rehrseg_tpu_torch.infer.sr_infer import postprocess_sr_volume
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.wdsr import WDSR
from rehrseg_tpu_torch.parallel.mesh import make_mesh
from rehrseg_tpu_torch.train import checkpoint as ckpt
from rehrseg_tpu_torch.train import optim, sr_trainer, torch_import
from rehrseg_tpu_torch.train.state import TrainState
from rehrseg_tpu_torch.utils.preemption import TrainingPreempted
from tests.test_torch_train import NORM_TOL, _floor, _rel

torch.set_num_threads(2)

WDSR_KW = dict(out_channel=2, n_resblocks=1, num_channels=4, scale=4.0)


@pytest.mark.parametrize("channels", [1, 2])
def test_sr_losses_match_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (2, 4, 8, 8, channels)
    pred = rng.normal(size=shape).astype(np.float32)
    target = np.concatenate(
        [rng.uniform(size=shape[:-1] + (1,)),
         (rng.uniform(size=shape[:-1] + (channels - 1,)) > 0.5)],
        -1).astype(np.float32)
    unc = rng.uniform(0.05, 1.0, size=shape[:-1] + (1,)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (pred, target, unc)]
    j = [jnp.asarray(a) for a in (pred, target, unc)]
    pairs = [(losses.sr_loss(t[0], t[1]), jlosses.sr_loss(j[0], j[1])),
             (losses.sr_uncertainty_loss(t[0], t[2], t[1]),
              jlosses.sr_uncertainty_loss(j[0], j[2], j[1])),
             (losses.l1_loss(t[0], t[1]), jlosses.l1_loss(j[0], j[1]))]
    if channels == 2:
        lg, tg = t[0][..., 1:], t[1][..., 1:]
        pairs += [(losses.bce_dice_loss(lg, tg),
                   jlosses.bce_dice_loss(j[0][..., 1:], j[1][..., 1:])),
                  (losses.dice_loss_sigmoid(lg, tg),
                   jlosses.dice_loss_sigmoid(j[0][..., 1:], j[1][..., 1:])),
                  (losses.bce_with_logits(lg, tg),
                   jlosses.bce_with_logits(j[0][..., 1:], j[1][..., 1:]))]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    sr = rng.normal(size=(6, 8, 8))
    hr = sr + 0.1 * rng.normal(size=sr.shape)
    assert losses.calculate_psnr(sr, hr) == pytest.approx(
        jlosses.calculate_psnr(sr, hr), rel=1e-12)
    assert losses.calculate_psnr(hr, hr) == float("inf")


def test_crop_hr_target_matches_jax():
    hr = np.arange(2 * 16 * 3 * 3 * 2, dtype=np.float32).reshape(
        2, 16, 3, 3, 2)
    for sep, n in ((4, 4), (4, 1), (2, 6)):
        got = sr_trainer.crop_hr_target(torch.from_numpy(hr), sep, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsr.crop_hr_target(jnp.asarray(hr), sep,
                                                       n)))


@functools.lru_cache(maxsize=None)
def _module(kind):
    """A port module of ``kind`` (built once; callers take copies)."""
    if kind == "wdsr":
        return WDSR(**WDSR_KW)
    return UNet3D(2, 4, 4, use_uncertainty=kind == "uasr")


@functools.lru_cache(maxsize=None)
def _params(kind):
    """The seeded flax-layout params of ``kind`` (made once: full-width
    UNet3D trees take a second)."""
    if kind == "wdsr":
        return convert.random_wdsr_params(0, **WDSR_KW)
    return convert.random_flavr_params(0, use_uncertainty=kind == "uasr")


# each model's one-cycle schedule (max lr, total steps) and batch geometry
# are those of its stage on tests/test_pipeline_e2e.py's tiny config (1a
# and 1b: 2 steps, 1c: 1), so the JAX steps compiled here are the ones the
# stage tests' JAX pipeline runs
SCHEDULE = {"wdsr": (1e-3, 2), "flavr": (1e-3, 2), "uasr": (1e-3, 1)}


def _models(kind):
    """(JAX model, params numpy tree, port model, bridge, batch (lr, hr),
    uncertainty, num_slices)."""
    rng = np.random.default_rng(3)
    p_np = _params(kind)
    port = copy.deepcopy(_module(kind))
    if kind == "wdsr":

        def bridge(m, tree):
            convert.load_flax_wdsr_params(m, tree)

        lr = rng.uniform(size=(2, 4, 16, 2))
        hr = rng.uniform(size=(2, 16, 16, 2))
        return (JaxWDSR(**WDSR_KW), p_np, port, bridge, lr, hr, False, 1)
    unc = kind == "uasr"

    def bridge(m, tree):
        convert.load_flax_flavr_params(m, tree, unc)

    lr = rng.uniform(size=(2, 4, 16, 16, 2))
    hr = rng.uniform(size=(2, 16, 16, 16, 2))
    hr[..., 1] = hr[..., 1] > 0.5
    return (JaxUNet3D(img_channels=2, n_inputs=4, n_outputs=4,
                      use_uncertainty=unc), p_np, port, bridge, lr, hr, unc,
            4)


def _sd(model, bridge, tree):
    """A numpy flax tree as the port model's state dict."""
    m = copy.deepcopy(model)
    bridge(m, tree)
    return {k: v.clone() for k, v in m.state_dict().items()}


def _port_steps(kind, precision=None, n=2, batch=None):
    """The port's ``n`` steps of ``kind`` (on the first ``batch`` samples):
    a list of (loss, gradients, state dict) per step."""
    _, p_np, model, bridge, lr, hr, unc, ns = _models(kind)
    lr, hr = lr[:batch], hr[:batch]
    bridge(model, p_np)
    opt, sched = optim.onecycle_adam(model, *SCHEDULE[kind])
    state = TrainState(model, opt, sched)
    step = sr_trainer.make_sr_train_step(model, enable_uncertainty=unc,
                                         slice_separation=4, num_slices=ns,
                                         precision=precision)
    lr_t, hr_t = (torch.from_numpy(a.astype(np.float32)) for a in (lr, hr))
    run = []
    for _ in range(n):
        state, m = step(state, lr_t, hr_t)
        run.append((float(m["loss"]),
                    {k: p.grad.clone() for k, p in model.named_parameters()},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    assert state.step == n
    return run


@pytest.mark.parametrize("kind", ["wdsr", "flavr", "uasr"])
def test_sr_step_matches_jax(kind):
    """Each step's loss and gradient, and the parameters after the two.
    JAX's gradients are read back from Adam's first moment (mu_1 = 0.1 g_1,
    mu_2 = 0.9 mu_1 + 0.1 g_2, in fp64 from the fp32 moments), so the step
    is the pipeline's own, uninstrumented."""
    jmodel, p_np, model, bridge, lr, hr, unc, ns = _models(kind)
    tx, _ = joptim.onecycle_adam(*SCHEDULE[kind])
    params = jax.tree.map(jnp.asarray, p_np)
    # TrainState.create's optimizer init, compiled once instead of an
    # eager op per leaf; the same state the pipeline's step receives
    state = JaxTrainState(params=params, opt_state=jax.jit(tx.init)(params),
                          step=0)
    step = jsr.make_sr_train_step(jmodel, tx, enable_uncertainty=unc,
                                  slice_separation=4.0, num_slices=ns,
                                  precision="fp32")
    jax_run, mu_prev = [], None
    for _ in range(2):
        state, m = step(state, jnp.asarray(lr, jnp.float32),
                        jnp.asarray(hr, jnp.float32))
        mu = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          state.opt_state[0].mu)
        g = jax.tree.map(lambda a: a / 0.1, mu) if mu_prev is None else \
            jax.tree.map(lambda a, b: (a - 0.9 * b) / 0.1, mu, mu_prev)
        mu_prev = mu
        jax_run.append((float(m["loss"]), _sd(model, bridge, g)))
    jp = _sd(model, bridge, jax.tree.map(np.asarray, state.params))
    port_run = _port_steps(kind)
    for (jl, jg), (tl, tg, _) in zip(jax_run, port_run):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert set(jg) == set(tg)
        floor = _floor(jg)
        for k in jg:
            assert _rel(tg[k].numpy(), jg[k].numpy(), floor) < NORM_TOL, k
    tp = port_run[-1][2]
    assert set(jp) == set(tp)
    for k in jp:
        assert _rel(tp[k].numpy(), jp[k].numpy()) < NORM_TOL, k


def _wdsr_dataset(n=2):
    """A 2-channel WDSR dataset over seeded pseudo-HR volumes."""
    rng = np.random.default_rng(5)
    vols = []
    for _ in range(n):
        img = rng.uniform(size=(24, 24, 12, 1)).astype(np.float32)
        lab = (img > 0.6).astype(np.uint8)
        fx, fy = postprocess_sr_volume(img, 3.87)
        vols.append((img, lab, fx, fy))
    return SRPatchDataset.from_volumes(vols, 4.0, 1.0, (16, 16), True)


class _Signaling:
    """A loader whose k-th batch sends this process SIGTERM."""

    def __init__(self, loader, fire_at):
        self.loader, self.fire_at, self.n = loader, fire_at, 0
        self.closed = False

    def next(self):
        self.n += 1
        if self.n == self.fire_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.loader.next()

    def close(self):
        self.closed = True


def _loop(tmp_path, n_steps, loader, **kw):
    model = WDSR(**WDSR_KW)
    convert.load_flax_wdsr_params(model, convert.random_wdsr_params(
        0, **WDSR_KW))
    opt, sched = optim.onecycle_adam(model, 5e-4, n_steps)
    state = TrainState(model, opt, sched)
    d = str(tmp_path / "smore")
    if ckpt.has_checkpoint(d):
        state.restore(d)
    step = sr_trainer.make_sr_train_step(model, enable_uncertainty=False,
                                         slice_separation=4, num_slices=1)
    return pipeline._train_sr_loop(state, loader, step, n_steps, 2, d,
                                   device=torch.device("cpu"), log_every=1,
                                   **kw), d


def test_train_sr_loop_saves_logs_preempts_and_resumes(tmp_path):
    """Saves every 2 steps and at the end, a log line a step (loss, lr,
    step time), the loader closed; a SIGTERM saves and raises; the rerun
    resumes at the saved step and ends where the uninterrupted run does;
    ``dp_mesh`` in a single process (a mesh of one CPU) trains as without
    it (the 2-process loop is in tests/test_torch_multihost.py)."""
    ref_loader = _Signaling(BatchLoader(_wdsr_dataset(), 2), None)
    ref, ref_dir = _loop(tmp_path / "ref", 5, ref_loader)
    assert ref.step == 5 and ref_loader.closed
    assert sorted(os.listdir(ref_dir)) == ["3", "5", "metrics.jsonl"]
    with open(os.path.join(ref_dir, "metrics.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["lr"] > 0 for r in log)

    run = tmp_path / "run"
    loader = _Signaling(BatchLoader(_wdsr_dataset(), 2), 3)
    with pytest.raises(TrainingPreempted) as ei:
        _loop(run, 5, loader)
    assert ei.value.step == 3 and loader.closed
    assert ckpt.latest_step(str(run / "smore")) == 3
    state, _ = _loop(run, 5, BatchLoader(_wdsr_dataset(), 2))
    assert state.step == 5
    # the resumed run draws a fresh stream, so only the schedule's end is
    # shared: both finish at the same step with finite weights
    for v in state.params.state_dict().values():
        assert torch.isfinite(v).all()
    one, _ = _loop(tmp_path / "one", 2, BatchLoader(_wdsr_dataset(), 2))
    meshed, _ = _loop(tmp_path / "mesh", 2, BatchLoader(_wdsr_dataset(), 2),
                      dp_mesh=make_mesh(devices=["cpu"]))
    for k, v in meshed.params.state_dict().items():
        assert torch.equal(v, one.params.state_dict()[k]), k


def _reference_flavr_sd(seed):
    """A reference-keyed FLAVR state dict (``module.`` prefixed, one key
    no mapping consumes)."""
    m = UNet3D(2, 4, 4)
    convert.load_flax_flavr_params(m, convert.random_flavr_params(seed),
                                   False)
    sd = {"module." + k: v.clone() for k, v in m.state_dict().items()}
    sd["module.extra.weight"] = torch.ones(3, 3)
    return sd


@pytest.mark.parametrize("what", ["flavr", "uasr", "wdsr"])
def test_importers_match_jax(what):
    """One reference-keyed state dict through both importers lands the
    same weights, loads the same keys and reports the same match rate."""
    if what == "wdsr":
        kw = dict(out_channel=2, n_resblocks=2, num_channels=8, scale=4.0)
        src = WDSR(**kw)
        convert.load_flax_wdsr_params(src, convert.random_wdsr_params(5,
                                                                      **kw))
        sd = {"module." + k: v.clone() for k, v in src.state_dict().items()}
        del sd["module.body.1.body.0.bias"]
        j_np = convert.random_wdsr_params(9, **kw)
        jparams, jloaded, jrep = jimport.import_wdsr(
            j_np, {k: v.numpy() for k, v in sd.items()}, n_resblocks=2,
            verbose=False)
        model = WDSR(**kw)
        convert.load_flax_wdsr_params(model, j_np)
        rep = torch_import.import_wdsr(model, sd, verbose=False)
        want = WDSR(**kw)
        convert.load_flax_wdsr_params(want, jax.tree.map(np.asarray,
                                                         jparams))
    else:
        unc = what == "uasr"
        sd = _reference_flavr_sd(5)
        j_np = convert.random_flavr_params(9, use_uncertainty=unc)
        jparams, jloaded, jrep = jimport.import_flavr(
            j_np, {k: v.numpy() for k, v in sd.items()},
            use_uncertainty=unc, verbose=False)
        model = UNet3D(2, 4, 4, use_uncertainty=unc)
        convert.load_flax_flavr_params(model, j_np, unc)
        rep = torch_import.import_flavr(model, sd, verbose=False)
        want = UNet3D(2, 4, 4, use_uncertainty=unc)
        convert.load_flax_flavr_params(
            want, jax.tree.map(np.asarray, jparams), unc)
    assert sorted(rep.loaded_keys) == sorted(jloaded)
    assert sorted(rep.unconsumed) == sorted(jrep.unconsumed)
    assert rep.match_rate == pytest.approx(jrep.match_rate)
    assert sorted(rep) == sorted(jrep)
    got = model.state_dict()
    for k, v in want.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert torch_import.drop_keys({"a.outconv.1": 1, "b": 2},
                                  ("outconv",)) == {"b": 2}
