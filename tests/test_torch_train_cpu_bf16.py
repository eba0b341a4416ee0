"""The port's bf16 train steps on the CPU. The stage-1 SR step's bf16
policy against its fp32 step (loss, gradient and parameters within 5e-2,
tests/test_precision.py's tolerance; fp32 master weights). F6: oneDNN's
bf16 convolution backward races between threads on some CPUs (gradients
vary from run to run and are at times NaN), so the library runs a CPU bf16
step without oneDNN (``train.precision.step_guard``); one step run three
times from one state, with nothing around it here, gives finite gradients
equal bit for bit: the stage-2 seg step (uncertainty, remat "hires") and
the stage-1 FLAVR UASR step."""

import copy

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.train import optim, seg_trainer, sr_trainer
from rehrseg_tpu_torch.train.state import TrainState
from tests.test_models import SMALL_ARCH
from tests.test_torch_sr_train import _models, _port_steps
from tests.test_torch_train import _batch, _rel

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["wdsr", "flavr"])
def test_sr_bf16_close_to_fp32(kind):
    """The bf16 policy's loss, gradient and parameters after one step
    within 5e-2 of the fp32 step's; the master weights stay fp32."""
    (l32, g32, p32), = _port_steps(kind, n=1, batch=1)
    (l16, g16, p16), = _port_steps(kind, "bf16", n=1, batch=1)
    assert l16 == pytest.approx(l32, rel=5e-2)

    def flat(sd):
        return np.concatenate([v.numpy().ravel() for v in sd.values()])

    assert _rel(flat(g16), flat(g32)) < 5e-2
    assert _rel(flat(p16), flat(p32)) < 5e-2
    assert all(v.dtype == torch.float32 for v in p16.values())


def _grads_three_times(model, run_step):
    """Three runs of ``run_step()`` (one step from ``model``'s present
    weights) give finite gradients equal bit for bit."""
    start = copy.deepcopy(model.state_dict())
    grads = []
    for _ in range(3):
        model.load_state_dict(start)
        run_step()
        g = torch.cat([p.grad.ravel() for p in model.parameters()])
        assert torch.isfinite(g).all()
        grads.append(g)
    for g in grads[1:]:
        assert torch.equal(g, grads[0])


def test_cpu_bf16_seg_step_deterministic():
    """F6: three CPU bf16 seg steps (uncertainty, remat "hires") from one
    state give finite gradients equal bit for bit, with no wrapper here."""
    batch = seg_trainer.SegBatch(*(torch.from_numpy(a)
                                   for a in _batch(0, b=1)))
    seg = SegModel(2, 4, arch=SMALL_ARCH)
    convert.load_flax_params(seg, convert.random_flax_params(SMALL_ARCH, 0))
    step = seg_trainer.make_seg_train_step(
        seg, enable_uncertainty=True, enable_distillation=False,
        remat="hires", precision="bf16")
    _grads_three_times(seg, lambda: step(
        TrainState(seg, optim.nesterov_sgd(seg),
                   optim.poly_epoch_schedule(1e-2, 4, 1)), batch))


def test_cpu_bf16_sr_step_deterministic():
    """F6: three CPU bf16 FLAVR UASR steps from one state give finite
    gradients equal bit for bit, with no wrapper here."""
    _, p_np, model, bridge, lr, hr, _, _ = _models("uasr")
    bridge(model, p_np)
    step = sr_trainer.make_sr_train_step(
        model, enable_uncertainty=True, slice_separation=4, num_slices=4,
        precision="bf16")
    lr_t, hr_t = (torch.from_numpy(a[:1].astype(np.float32))
                  for a in (lr, hr))
    _grads_three_times(model, lambda: step(
        TrainState(model, *optim.onecycle_adam(model, 5e-4, 10)), lr_t,
        hr_t))
