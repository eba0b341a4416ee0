"""The port's stage-2 train step against the JAX package's on the same
numpy-made params and batch, fp32, on the CPU: the loss terms, every
parameter's gradient carried through the weight bridge, and the parameters
after steps 1 and 2, for the plain step, uncertainty + distillation, deep
supervision (the unpacked SegModel), the grouped optimizer and each remat
mode; bf16 against fp32; the teacher features with and without
``window_chunk``; ``select_remat_mode`` on the CPU; the schedules and the
SGD / grouped SGD / Adam updates over 3 steps against optax.

Tolerances: losses rtol 1e-5; gradients and parameters a relative norm of
1e-4 per leaf (XLA's and PyTorch's fp32 summation orders differ), a
gradient's norm taken at least as 1e-3 of the whole gradient's (a conv
bias ahead of an instance norm has a true gradient of zero and holds
rounding noise only); bf16 against fp32 5e-2, as tests/test_precision.py.
The card's tests are in tests/test_torch_train_card.py. The kernel
wrappers refuse inputs that require grad in grad mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rehrseg_tpu.models import Distiller as JaxDistiller
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models import UNet3D as JaxUNet3D
from rehrseg_tpu.train import optim as joptim
from rehrseg_tpu.train import seg_trainer as jst
from rehrseg_tpu.train.state import TrainState as JaxTrainState
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.distiller import Distiller
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.train import optim, seg_trainer as tst
from rehrseg_tpu_torch.train.state import TrainState
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
NORM_TOL = 1e-4
STUDENT_DIM = SMALL_ARCH["features_per_stage"][1]


def _rel(a, b, floor=1e-30):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


def _floor(sd):
    """1e-3 of the whole tree's norm: a leaf whose true gradient is zero (a
    conv bias before an instance norm) holds rounding noise only, so its
    error is taken against this floor."""
    return 1e-3 * np.sqrt(sum(float((v.double() ** 2).sum())
                              for v in sd.values()))


def _batch(seed=0, b=2, d=4, hw=16, sep=4):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, d, hw, hw, 1)).astype(np.float32)
    llr = (rng.normal(size=(b, d, hw, hw, 1)) > 0).astype(np.float32)
    lhr = (rng.normal(size=(b, d * sep, hw, hw, 1)) > 0).astype(np.float32)
    unc = rng.uniform(0.5, 1.0, size=(b, d, hw, hw, 1)).astype(np.float32)
    return img, llr, lhr, unc


def _record():
    """An optax transform that keeps the incoming gradients as its state
    and passes them on: chained before the optimizer, it exposes the
    step's gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (g, g))


def _seg_sd(tree, ds=False):
    return convert.state_dict_from_flax(tree, SMALL_ARCH, ds)


def _distiller_sd(tree):
    m = Distiller(STUDENT_DIM, 64)
    convert.load_flax_distiller_params(m, tree)
    return m.state_dict()


CASES = {
    "plain": dict(unc=False, kd=False, ds=False, grouped=False, remat=False),
    "unc_kd": dict(unc=True, kd=True, ds=False, grouped=False,
                   remat="hires"),
    "ds": dict(unc=False, kd=False, ds=True, grouped=False, remat=False),
    "grouped": dict(unc=False, kd=False, ds=False, grouped=True,
                    remat=True),
    "plain_hires": dict(unc=False, kd=False, ds=False, grouped=False,
                        remat="hires"),
    "plain_all": dict(unc=False, kd=False, ds=False, grouped=False,
                      remat=True),
}


def _setup(case, precision=None, seed=0):
    """(JAX run, port run) of two steps of ``case``: each a list of
    (metrics, gradients as torch state dicts, params as torch state
    dicts) per step."""
    c = CASES[case]
    seg_np = convert.random_flax_params(SMALL_ARCH, seed,
                                        deep_supervision=c["ds"])
    img, llr, lhr, unc = _batch(seed)
    sched_j = joptim.poly_epoch_schedule(1e-2, 4, 1)
    sched_t = optim.poly_epoch_schedule(1e-2, 4, 1)

    # ---- JAX
    jseg = JaxSegModel(num_classes=2, upscale=4, arch=dict(SMALL_ARCH),
                       deep_supervision=c["ds"])
    params = jax.tree.map(jnp.asarray, seg_np)
    flavr_j = fparams = dist_j = None
    if c["kd"]:
        f_np = convert.random_flavr_params(seed + 1)
        d_np = convert.random_distiller_params(seed + 2,
                                               student_dim=STUDENT_DIM)
        flavr_j = JaxUNet3D(img_channels=2, n_inputs=4, n_outputs=4)
        fparams = jax.tree.map(jnp.asarray, f_np)
        dist_j = JaxDistiller(student_dim=STUDENT_DIM, teacher_dim=64)
        params = {"seg": params, "distiller": jax.tree.map(jnp.asarray,
                                                           d_np)}
    inner = (joptim.nesterov_sgd_grouped(1e-2, sched_j) if c["grouped"]
             else joptim.nesterov_sgd(sched_j))
    tx = optax.chain(_record(), inner)
    state = JaxTrainState.create(params, tx)
    step = jst.make_seg_train_step(
        jseg, tx, enable_uncertainty=c["unc"], enable_distillation=c["kd"],
        flavr_model=flavr_j, distiller=dist_j, deep_supervision=c["ds"],
        donate=False, remat=c["remat"], precision=precision)
    batch = jst.SegBatch(*(jnp.asarray(a) for a in (img, llr, lhr, unc)))
    jax_run = []
    for _ in range(2):
        state, m = step(state, fparams, batch)
        g, p = state.opt_state[0], state.params
        if c["kd"]:
            sd_g = {"seg": _seg_sd(g["seg"]),
                    "distiller": _distiller_sd(g["distiller"])}
            sd_p = {"seg": _seg_sd(p["seg"]),
                    "distiller": _distiller_sd(p["distiller"])}
        else:
            sd_g, sd_p = _seg_sd(g, c["ds"]), _seg_sd(p, c["ds"])
        jax_run.append(({k: float(v) for k, v in m.items()}, sd_g, sd_p))

    # ---- port
    seg = SegModel(2, 4, arch=SMALL_ARCH, deep_supervision=c["ds"])
    convert.load_flax_params(seg, seg_np)
    tparams, flavr = seg, None
    if c["kd"]:
        flavr = UNet3D(2, 4, 4)
        convert.load_flax_flavr_params(flavr, f_np, False)
        dist = Distiller(STUDENT_DIM, 64)
        convert.load_flax_distiller_params(dist, d_np)
        tparams = {"seg": seg, "distiller": dist}
    opt = (optim.nesterov_sgd_grouped(seg) if c["grouped"]
           else optim.nesterov_sgd(tparams))
    tstate = TrainState(tparams, opt, sched_t)
    tstep = tst.make_seg_train_step(
        seg, enable_uncertainty=c["unc"], enable_distillation=c["kd"],
        flavr_model=flavr, deep_supervision=c["ds"], remat=c["remat"],
        precision=precision)
    tbatch = tst.SegBatch(*(torch.from_numpy(a) for a in (img, llr, lhr,
                                                          unc)))
    port_run = []
    for _ in range(2):
        tstate, m = tstep(tstate, tbatch)

        def grads(mod):
            # no gradient (a deep-supervision head of weight 0) is JAX's
            # zero gradient
            return {k: torch.zeros_like(p) if p.grad is None
                    else p.grad.clone() for k, p in mod.named_parameters()}

        def values(mod):
            return {k: v.clone() for k, v in mod.state_dict().items()}

        if c["kd"]:
            sd_g = {k: grads(v) for k, v in tparams.items()}
            sd_p = {k: values(v) for k, v in tparams.items()}
        else:
            sd_g, sd_p = grads(seg), values(seg)
        port_run.append(({k: float(v) for k, v in m.items()}, sd_g, sd_p))
    assert tstate.step == 2
    return jax_run, port_run


def _flat(sd):
    if sd and isinstance(next(iter(sd.values())), dict):
        return {f"{k}/{kk}": vv for k, v in sd.items()
                for kk, vv in _flat(v).items()}
    return sd


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case):
    jax_run, port_run = _setup(case)
    for (jm, jg, jp), (tm, tg, tp) in zip(jax_run, port_run):
        assert set(jm) == set(tm)
        for k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=LOSS_RTOL), (k, tm, jm)
        jg, tg, jp, tp = _flat(jg), _flat(tg), _flat(jp), _flat(tp)
        assert set(jg) == set(tg) and set(jp) == set(tp)
        floor = _floor(jg)
        for k in jg:
            assert _rel(tg[k].numpy(), jg[k].numpy(), floor) < NORM_TOL, k
        for k in jp:
            assert _rel(tp[k].numpy(), jp[k].numpy()) < NORM_TOL, k


def test_bf16_close_to_fp32():
    """The bf16 policy's losses and parameters after one step within 5e-2
    of the fp32 step's (tests/test_precision.py's tolerance). The step
    itself runs a CPU bf16 step without oneDNN, whose bf16 convolution
    backward races between threads (``train.precision.step_guard``)."""
    _, p32 = _setup("unc_kd")
    _, p16 = _setup("unc_kd", precision="bf16")
    (m32, _, s32), (m16, _, s16) = p32[0], p16[0]
    for k in m32:
        assert m16[k] == pytest.approx(m32[k], rel=5e-2), k
    v32 = np.concatenate([t.numpy().ravel() for t in _flat(s32).values()])
    v16 = np.concatenate([t.numpy().ravel() for t in _flat(s16).values()])
    assert _rel(v16, v32) < 5e-2
    for t in _flat(s16).values():
        assert t.dtype == torch.float32


@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_teacher_features_match_jax(chunk):
    f_np = convert.random_flavr_params(3)
    img, llr, _, _ = _batch(1, d=5)
    jflavr = JaxUNet3D(img_channels=2, n_inputs=4, n_outputs=4)
    want = jst.flavr_teacher_features(
        jflavr, jax.tree.map(jnp.asarray, f_np), jnp.asarray(img),
        jnp.asarray(llr), window_chunk=chunk)
    flavr = UNet3D(2, 4, 4)
    convert.load_flax_flavr_params(flavr, f_np, False)
    got = tst.flavr_teacher_features(flavr, torch.from_numpy(img),
                                     torch.from_numpy(llr),
                                     window_chunk=chunk)
    assert got.shape == want.shape == (2, 5, 8, 8, 64)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_window_indices_and_ds_scales():
    np.testing.assert_array_equal(tst.flavr_window_indices(6),
                                  jst.flavr_window_indices(6))
    assert tst.ds_scales_from_arch(SMALL_ARCH) == \
        jst.ds_scales_from_arch(SMALL_ARCH)
    lab = np.arange(2 * 4 * 8 * 8).reshape(2, 4, 8, 8, 1).astype(np.float32)
    np.testing.assert_array_equal(
        tst.downsample_label(torch.from_numpy(lab), (2, 2, 4)).numpy(),
        np.asarray(jst.downsample_label(jnp.asarray(lab), (2, 2, 4))))
    assert tst.REMAT_WIRE == jst.REMAT_WIRE
    assert tst.REMAT_NAMES == jst.REMAT_NAMES


def test_select_remat_mode_cpu():
    """The CPU has no memory limit: remat=all at once, as JAX's probe on a
    device without bytes_limit, and no candidate runs."""
    seg = SegModel(2, 4, arch=SMALL_ARCH)
    state = TrainState(seg, optim.nesterov_sgd(seg),
                       optim.poly_epoch_schedule(1e-2, 4, 1))
    img, llr, lhr, unc = _batch()
    batch = tst.SegBatch(*(torch.from_numpy(a) for a in (img, llr, lhr,
                                                          unc)))
    built = []

    def build(mode):
        built.append(mode)
        return tst.make_seg_train_step(seg, enable_uncertainty=False,
                                       enable_distillation=False,
                                       remat=mode)

    for kw in ({}, {"bytes_limit": 1 << 40}):
        mode, why = tst.select_remat_mode(build, state, batch, **kw)
        assert mode is True and "bytes_limit" in why
    assert built == []


# ------------------------------------------------------------ optimizers

def test_schedules_match_optax():
    for total in (1, 2, 7, 100):
        j = joptim.cosine_onecycle_schedule(1e-3, total)
        t = optim.cosine_onecycle_schedule(1e-3, total)
        for c in range(total + 2):
            # JAX's cosine runs in fp32: 1e-7 of max_lr absolute
            assert t(c) == pytest.approx(float(j(c)), rel=1e-5, abs=1e-10)
    j = joptim.poly_epoch_schedule(1e-2, 5, 3)
    t = optim.poly_epoch_schedule(1e-2, 5, 3)
    for c in range(20):
        assert t(c) == pytest.approx(float(j(c)), rel=1e-6, abs=1e-12)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(3, 4)
        self.sr_head = torch.nn.Linear(4, 2)


@pytest.mark.parametrize("kind", ["sgd", "grouped", "adam"])
def test_optimizer_updates_match_optax(kind):
    rng = np.random.default_rng(7)
    toy = _Toy()
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)
                                     .astype(np.float32)))
    # flat trees keyed by the torch names: JAX's label function finds
    # "sr_head" in "sr_head.weight" as in a nested path
    jparams = {k: jnp.array(p.detach().numpy(), copy=True)
               for k, p in toy.named_parameters()}
    grads = [{k: rng.normal(size=jparams[k].shape).astype(np.float32)
              for k in jparams} for _ in range(3)]
    if kind == "adam":
        opt, sched = optim.onecycle_adam(toy, 1e-2, 10)
        tx, _ = joptim.onecycle_adam(1e-2, 10)
    elif kind == "grouped":
        sched = optim.poly_epoch_schedule(0.1, 3, 1)
        opt = optim.nesterov_sgd_grouped(toy)
        tx = joptim.nesterov_sgd_grouped(
            0.1, joptim.poly_epoch_schedule(0.1, 3, 1))
    else:
        sched = optim.poly_epoch_schedule(0.1, 3, 1)
        opt = optim.nesterov_sgd(toy)
        tx = joptim.nesterov_sgd(joptim.poly_epoch_schedule(0.1, 3, 1))
    state = TrainState(toy, opt, sched)
    jstate = tx.init(jparams)
    for g in grads:
        for k, p in toy.named_parameters():
            p.grad = torch.tensor(g[k])
        state.apply_gradients()
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6)
    assert state.step == 3


def test_grouped_optimizer_groups():
    seg = SegModel(2, 4, arch=SMALL_ARCH)
    opt = optim.nesterov_sgd_grouped(seg)
    head, other = opt.param_groups
    n_head = sum(1 for k, _ in seg.named_parameters() if "sr_head" in k)
    assert len(head["params"]) == n_head == 4
    assert len(other["params"]) == len(list(seg.parameters())) - n_head
    assert (head["lr_scale"], head["weight_decay"]) == (1.0, 3e-5)
    assert (other["lr_scale"], other["weight_decay"]) == (0.1, 0.0)
    optim.set_lr(opt, optim.poly_epoch_schedule(0.5, 2, 1), 0)
    assert (head["lr"], other["lr"]) == (0.5, pytest.approx(0.05))


# ------------------------------------------------------------ the guard

def _wrapper_calls():
    from rehrseg_tpu_torch.ops import conv2x2, pconv, tail

    r = torch.Generator().manual_seed(0)

    def t(*s):
        return torch.randn(*s, generator=r)

    return {
        "pconv_pad11_cat": lambda g: pconv.pconv_pad11_cat(
            t(1, 2, 8, 128).requires_grad_(g), t(1, 2, 8, 128),
            t(2, 2, 256, 128)),
        "pconv_pad11": lambda g: pconv.pconv_pad11(
            t(1, 2, 8, 128), t(2, 2, 128, 128).requires_grad_(g)),
        "pconv_valid": lambda g: pconv.pconv_valid(
            t(1, 3, 16, 128), t(2, 2, 128, 128), t(128).requires_grad_(g)),
        "pconv3_valid": lambda g: pconv.pconv3_valid(
            t(1, 2, 3, 16, 128), t(3, 2, 2, 128, 128),
            pre=(t(1, 8, 128).requires_grad_(g), t(1, 8, 128), 0.01)),
        "conv2x2_valid_bias": lambda g: conv2x2.conv2x2_valid_bias(
            t(1, 3, 9, 128).requires_grad_(g), t(2, 2, 128, 128)),
        "accumulate_tta_tile": lambda g: tail.accumulate_tta_tile(
            torch.zeros(2, 4, 6, 6), t(8, 2, 4, 6, 6).requires_grad_(g),
            torch.ones(4, 6, 6), (0, 0, 0, 1)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad(name):
    """The CUDA kernels have no backward: a wrapper reached in grad mode
    with an input that requires grad raises (on the CPU as on the card)
    instead of returning a tensor cut from the graph; under no_grad, or
    with no input that requires grad, it runs."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert call(False) is not None
    with torch.no_grad():
        assert call(True) is not None


def test_packed_training_forward_refuses_kernels():
    """Training through pallas_conv="cat" would meet K1 with params that
    require grad: it raises; pallas_conv=False trains."""
    from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed

    arch = dict(SMALL_ARCH, features_per_stage=(32, 32, 32, 32))
    seg = SegModel(2, 4, arch=arch)
    x = torch.randn(1, 4, 16, 16, 1)
    tree = convert.flax_tree_from_module(seg)
    with pytest.raises(RuntimeError, match="no backward"):
        segmodel_apply_packed(arch, tree, x, pack_max_channels=64,
                              pallas_conv="cat")
    out = segmodel_apply_packed(arch, tree, x, pack_max_channels=64)
    out.sum().backward()
    assert all(p.grad is not None for k, p in seg.named_parameters()
               if "sr_head" not in k)
