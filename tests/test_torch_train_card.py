"""The stage-2 training slice on the card (``cuda``-marked; they skip
where PyTorch sees no card): one fp32 step (TF32 off) of the packed
forward against the unpacked SegModel's, losses and per-leaf gradients
within 2e-3 (a leaf's norm taken as at least 1e-3 of the whole
gradient's: a conv bias ahead of an instance norm has a true gradient of
zero); ``select_remat_mode`` measuring each candidate's peak on the card
without changing the state; and ``augment_seg_batch``'s apply half on the
card against the CPU at the same drawn parameters (data 1e-4, labels equal
on all but 1e-3 of the voxels). No JAX here: the card's machine has none,
so ``pytest --noconftest -m cuda`` runs this file there."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.data import device_aug as taug
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.train import optim, seg_trainer as tst
from rehrseg_tpu_torch.train.state import TrainState

SMALL_ARCH = dict(
    n_stages=4,
    features_per_stage=(8, 16, 32, 32),
    kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_conv_per_stage=(2, 2, 2, 2),
    n_conv_per_stage_decoder=(2, 2, 2),
    conv_bias=True, norm_eps=1e-5, norm_affine=True, nonlin_slope=0.01)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rel(a, b, floor=1e-30):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


def _batch(seed=0, b=2, d=4, hw=16, sep=4):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, d, hw, hw, 1)).astype(np.float32)
    llr = (rng.normal(size=(b, d, hw, hw, 1)) > 0).astype(np.float32)
    lhr = (rng.normal(size=(b, d * sep, hw, hw, 1)) > 0).astype(np.float32)
    unc = rng.uniform(0.5, 1.0, size=(b, d, hw, hw, 1)).astype(np.float32)
    return img, llr, lhr, unc


def _seg_batch(seed, b, z=2, sep=2, hw=(14, 12)):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, z, *hw, 1)).astype(np.float32)
    llr = (rng.uniform(size=(b, z, *hw, 1)) > 0.5).astype(np.float32)
    lhr = (rng.uniform(size=(b, z * sep, *hw, 1)) > 0.5).astype(np.float32)
    unc = rng.uniform(0.3, 1.0, size=(b, z, *hw, 1)).astype(np.float32)
    return img, llr, lhr, unc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_packed_step_matches_unpacked_on_card(cuda_device):
    """One fp32 step (TF32 off) of the packed forward against the unpacked
    SegModel's, on the card: losses and per-leaf gradients within 2e-3."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seg_np = convert.random_flax_params(SMALL_ARCH, 0)
    img, llr, lhr, unc = _batch()
    batch = tst.SegBatch(*(torch.from_numpy(a).to(cuda_device)
                           for a in (img, llr, lhr, unc)))
    out = {}
    for packed in (True, False):
        seg = SegModel(2, 4, arch=SMALL_ARCH).to(cuda_device)
        convert.load_flax_params(seg, seg_np)
        state = TrainState(seg, optim.nesterov_sgd(seg),
                           optim.poly_epoch_schedule(1e-2, 4, 1))
        step = tst.make_seg_train_step(
            seg, enable_uncertainty=True, enable_distillation=False,
            packed=packed, remat="hires")
        _, m = step(state, batch)
        out[packed] = ({k: float(v) for k, v in m.items()},
                       {k: p.grad.cpu() for k, p in seg.named_parameters()})
        assert state.step == 1
    (mp, gp), (mu, gu) = out[True], out[False]
    for k in mp:
        assert mp[k] == pytest.approx(mu[k], rel=2e-3), k
    floor = 1e-3 * np.sqrt(sum(float((g.double() ** 2).sum())
                               for g in gu.values()))
    for k in gp:
        assert _rel(gp[k].numpy(), gu[k].numpy(), floor) < 2e-3, k


@pytest.mark.cuda
def test_select_remat_mode_on_card(cuda_device):
    seg = SegModel(2, 4, arch=SMALL_ARCH).to(cuda_device)
    state = TrainState(seg, optim.nesterov_sgd(seg),
                       optim.poly_epoch_schedule(1e-2, 4, 1))
    img, llr, lhr, unc = _batch()
    batch = tst.SegBatch(*(torch.from_numpy(a).to(cuda_device)
                           for a in (img, llr, lhr, unc)))

    def build(mode):
        return tst.make_seg_train_step(seg, enable_uncertainty=False,
                                       enable_distillation=False,
                                       remat=mode)

    before = {k: v.clone() for k, v in seg.state_dict().items()}
    mode, why = tst.select_remat_mode(build, state, batch)
    assert mode is False and "fits" in why, why
    mode, why = tst.select_remat_mode(build, state, batch, bytes_limit=2,
                                      margin_bytes=1)
    assert mode is True and "exceeded" in why, why
    for k, v in seg.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in seg.parameters())



@pytest.mark.cuda
def test_augment_on_card_matches_cpu(cuda_device):
    """augment_seg_batch's apply half on the card against the CPU at the
    same drawn parameters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _seg_batch(7, b=8, hw=(48, 40))
    params = taug.draw_seg_aug_params(torch.Generator().manual_seed(1), 8,
                                      2, (32, 24))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    cpu = taug.apply_seg_aug(params, *map(torch.from_numpy, arrays),
                             patch_hw=(32, 24))
    card = taug.apply_seg_aug(
        to(params, cuda_device),
        *(torch.from_numpy(a).to(cuda_device) for a in arrays),
        patch_hw=(32, 24))
    for name, c, g in zip(("img", "label_lr", "label_hr", "unc"), cpu,
                          card):
        g = g.cpu()
        if name.startswith("label"):
            assert (g != c).float().mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(g.numpy(), c.numpy(), err_msg=name,
                                       **TOL)
