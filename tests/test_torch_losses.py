"""The port's segmentation losses, distiller and ``zscore_batch`` against
the JAX package's on the same seeded inputs, fp32, on the CPU: soft dice
(float and one-hot targets, batch dice, out-of-range labels), the
cross-entropy with and without uncertainty weights (float labels that
truncate, ``-inf`` logits kept finite as the masked select-sum keeps
them), the combined loss, the deep-supervision weights and factory; the
Distiller's terms and its loss with its gradient; the SegModel with deep
supervision. Values at rtol 1e-5 (gradients 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu import losses as jl
from rehrseg_tpu.data.normalize import zscore_batch as jzscore
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models import distiller as jd
from rehrseg_tpu_torch import losses as tl
from rehrseg_tpu_torch.data.normalize import zscore_batch
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models import distiller as td
from rehrseg_tpu_torch.models.segnet import SegModel
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

APPROX = dict(rel=1e-5, abs=1e-6)


def _inputs(seed=0, shape=(2, 3, 6, 5), c=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (c,)).astype(np.float32) * 2
    target = rng.integers(0, c, size=shape + (1,)).astype(np.float32)
    # fractional labels truncate toward zero, as astype(int32)
    target = target + rng.uniform(0, 0.99, size=target.shape).astype(
        np.float32)
    unc = rng.uniform(0.1, 1.0, size=shape + (1,)).astype(np.float32)
    return logits, target, unc


def _both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in arrays), **kw)
    return float(got), float(want)


@pytest.mark.parametrize("kw", [{}, {"do_bg": True}, {"batch_dice": True},
                                {"smooth": 1.0}])
def test_soft_dice(kw):
    logits, target, _ = _inputs()
    got, want = _both(tl.soft_dice_loss, jl.soft_dice_loss, logits, target,
                      **kw)
    assert got == pytest.approx(want, **APPROX)


def test_soft_dice_one_hot_and_out_of_range():
    logits, target, _ = _inputs(1)
    onehot = np.eye(3, dtype=np.float32)[target[..., 0].astype(int)]
    got, want = _both(tl.soft_dice_loss, jl.soft_dice_loss, logits, onehot)
    assert got == pytest.approx(want, **APPROX)
    bad = target.copy()
    bad[0, 0, 0, 0] = 7.0     # no class: a zero one-hot row
    bad[1, 1, 1, 1] = -1.0
    got, want = _both(tl.soft_dice_loss, jl.soft_dice_loss, logits, bad)
    assert got == pytest.approx(want, **APPROX)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy(weighted):
    logits, target, unc = _inputs(2)
    args = (logits, target, unc if weighted else None)
    got, want = _both(tl.robust_cross_entropy, jl.robust_cross_entropy,
                      *args)
    assert got == pytest.approx(want, **APPROX)
    # a (B, ...) label without the channel axis and an unsqueezed weight
    got, want = _both(tl.robust_cross_entropy, jl.robust_cross_entropy,
                      logits, target[..., 0], unc[..., 0])
    assert got == pytest.approx(want, **APPROX)


def test_cross_entropy_minus_inf_logits():
    """-inf in a class other than the label's stays out of the sum: the
    loss and its gradient are finite (a one-hot multiply gives NaN)."""
    logits, target, _ = _inputs(3, c=2)
    target = np.zeros_like(target)
    logits[..., 1] = -np.inf
    logits[0, 0, 0, 0, 1] = 0.5      # one finite logit in that class
    t = torch.from_numpy(logits).requires_grad_(True)
    loss = tl.robust_cross_entropy(t, torch.from_numpy(target))
    loss.backward()
    want = jl.robust_cross_entropy(jnp.asarray(logits), jnp.asarray(target))
    assert np.isfinite(float(loss))
    assert float(loss) == pytest.approx(float(want), **APPROX)
    assert torch.isfinite(t.grad).all()
    jgrad = jax.grad(jl.robust_cross_entropy)(jnp.asarray(logits),
                                              jnp.asarray(target))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 1.0, 0.5])
def test_dc_and_weighted_ce_and_its_gradient(wd):
    logits, target, unc = _inputs(4)
    t = torch.from_numpy(logits).requires_grad_(True)
    loss = tl.dc_and_weighted_ce(t, torch.from_numpy(target),
                                 torch.from_numpy(unc), weight_dice=wd)
    loss.backward()

    def jfn(lg):
        return jl.dc_and_weighted_ce(lg, jnp.asarray(target),
                                     jnp.asarray(unc), weight_dice=wd)

    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    assert float(loss) == pytest.approx(float(want), **APPROX)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_deep_supervision_weights(n):
    np.testing.assert_allclose(tl.deep_supervision_weights(n),
                               jl.deep_supervision_weights(n)
                               if n > 1 else [np.nan], equal_nan=True)


def test_build_seg_loss():
    rng = np.random.default_rng(5)
    shapes = [(2, 4, 8, 8), (2, 2, 4, 4), (2, 1, 2, 2)]
    lgs = [rng.normal(size=s + (2,)).astype(np.float32) for s in shapes]
    tgs = [(rng.uniform(size=s + (1,)) > 0.5).astype(np.float32)
           for s in shapes]
    for ds in (False, True):
        ft, fj = tl.build_seg_loss(ds), jl.build_seg_loss(ds)
        if ds:
            got = ft([torch.from_numpy(a) for a in lgs],
                     [torch.from_numpy(a) for a in tgs])
            want = fj([jnp.asarray(a) for a in lgs],
                      [jnp.asarray(a) for a in tgs])
        else:
            got = ft(torch.from_numpy(lgs[0]), torch.from_numpy(tgs[0]))
            want = fj(jnp.asarray(lgs[0]), jnp.asarray(tgs[0]))
        assert float(got) == pytest.approx(float(want), **APPROX)


def test_zscore_batch():
    x = np.random.default_rng(6).normal(3.0, 2.0, size=(3, 4, 5, 6, 2))
    x = x.astype(np.float32)
    np.testing.assert_allclose(zscore_batch(torch.from_numpy(x)).numpy(),
                               np.asarray(jzscore(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ distiller

def _feats(seed=7, b=2, s=3, h=6, w=5, cs=8, ct=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, w, cs)).astype(np.float32),
            rng.normal(size=(b, s, h, w, ct)).astype(np.float32))


def test_distiller_terms():
    fs, ft = _feats(cs=16)
    for fn_t, fn_j in ((td.pairwise_loss_after_pool,
                        jd.pairwise_loss_after_pool),
                       (td.cosine_distance_loss, jd.cosine_distance_loss),
                       (td.smooth_l1, jd.smooth_l1)):
        got, want = _both(fn_t, fn_j, fs, ft)
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), fn_t
    x = fs.reshape(6, 6, 5, 16)
    np.testing.assert_allclose(
        td._maxpool2d_ceil(torch.from_numpy(x), 4, 3).numpy(),
        np.asarray(jd._maxpool2d_ceil(jnp.asarray(x), 4, 3)))
    np.testing.assert_allclose(
        td.similarity(torch.from_numpy(x)).numpy(),
        np.asarray(jd.similarity(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lambdas", [(0.0, 1.0, 1.0), (0.5, 0.3, 2.0)])
def test_distiller_loss_and_gradients(lambdas):
    fs, ft = _feats()
    l1, cos, st = lambdas
    params = convert.random_distiller_params(8, student_dim=8,
                                             teacher_dim=16)
    jdist = jd.Distiller(student_dim=8, teacher_dim=16, lambda_l1=l1,
                         lambda_cosine=cos, lambda_structure=st)

    def jfn(p, s):
        return jdist.apply(p, s, jnp.asarray(ft))

    want, (gp, gs) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(fs))
    dist = td.Distiller(8, 16, lambda_l1=l1, lambda_cosine=cos,
                        lambda_structure=st)
    convert.load_flax_distiller_params(dist, params)
    s = torch.from_numpy(fs).requires_grad_(True)
    t = torch.from_numpy(ft).requires_grad_(True)
    loss = dist(s, t)
    loss.backward()
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert t.grad is None or not t.grad.any()     # the teacher is detached
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), rtol=1e-4,
                               atol=1e-7)
    wd = np.asarray(gp["params"]["distill"]["kernel"])
    np.testing.assert_allclose(
        dist.distill.weight.grad.numpy(),
        np.transpose(wd, (4, 3, 0, 1, 2)), rtol=1e-4, atol=1e-7)


def test_segmodel_deep_supervision_matches_jax():
    """SegModel(deep_supervision=True): every decoder stage's logits,
    highest resolution first, through the bridge with the extra heads;
    the non-DS key set is unchanged."""
    params = convert.random_flax_params(SMALL_ARCH, 0,
                                        deep_supervision=True)
    x = np.random.default_rng(9).normal(size=(1, 4, 16, 16, 1)).astype(
        np.float32)
    jm = JaxSegModel(num_classes=2, upscale=4, arch=dict(SMALL_ARCH),
                     deep_supervision=True)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jm.init(jax.random.key(0), jnp.asarray(x)))
    assert jshapes == convert.flax_param_shapes(SMALL_ARCH,
                                                deep_supervision=True)
    j_out, j_hr = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    model = SegModel(2, 4, arch=SMALL_ARCH, deep_supervision=True)
    convert.load_flax_params(model, params)
    with torch.no_grad():
        out, hr = model(torch.from_numpy(x))
    assert len(out) == len(j_out) == SMALL_ARCH["n_stages"] - 1
    for g, w in zip(out, j_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), rtol=1e-4,
                               atol=1e-4)
    plain = set(SegModel(2, 4, arch=SMALL_ARCH).state_dict())
    assert plain == set(convert.segmodel_mapping(SMALL_ARCH))
    assert plain < set(model.state_dict())
    assert set(model.state_dict()) - plain == {
        f"decoder.seg_layers.{s}.{k}" for s in range(2)
        for k in ("weight", "bias")}
