"""The port's packed SegModel forward against the JAX package's packed
forward and unpacked SegModel, on the same numpy-made params and input,
fp32, on the CPU. K1 engages at the decoder concat where the packed lanes
are 128-multiples (features (32, 32, 32, 32)); a spy on the port's K1
wrapper proves it (a silent fallback to the concat cannot pass). Under
pallas_conv=True spies on both packages' K1/K3/K4/K5 entry points show
that the port engages the same kernels at the same sites as JAX, and under
pallas_conv="fused" the same K6 forms (pre=/want_stats=) at the same
sites."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models.segnet_packed import (
    segmodel_apply_packed as jax_packed)
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.ops import pconv
from tests.test_packed_segmodel import ARCH_SMALL

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_CAT = dict(ARCH_SMALL, features_per_stage=(32, 32, 32, 32))
# pallas_conv=True: 128/256 packed lanes at the packed stages
ARCH_ALL = dict(ARCH_SMALL, features_per_stage=(32, 64, 64, 64))
# a 3-conv stage 0 ends offset: K4 engages there and at the last decoder
# stage, whose offset skip sends it down the unpacked concat
ARCH_ALL3 = dict(ARCH_ALL, n_conv_per_stage=(3, 2, 2, 2))
KERNELS = ("pconv_pad11_cat", "pconv_valid", "pconv_pad11", "pconv3_valid")


def _setup(arch, shape=(2, 8, 32, 48, 1), num_classes=2, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    params = convert.random_flax_params(arch, seed, num_classes=num_classes)
    return params, x


def _spy_kernels(monkeypatch, module):
    """Records (entry point, covered) for every call of the K1/K3/K4/K5
    entry points of ``module``."""
    calls = []
    for name in KERNELS:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            y = _orig(*a, **k)
            calls.append((_name, y is not None))
            return y

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture
def k1_spy(monkeypatch):
    """Records, per call of the port's K1 wrapper, whether it covered the
    shape (returned a tensor)."""
    engaged = []
    orig = pconv.pconv_pad11_cat

    def spy(*a, **k):
        y = orig(*a, **k)
        engaged.append(y is not None)
        return y

    monkeypatch.setattr(pconv, "pconv_pad11_cat", spy)
    return engaged


def _port(arch, params, x, **kw):
    with torch.no_grad():
        return segmodel_apply_packed(arch, convert.tree_to_torch(params),
                                     torch.from_numpy(x), **kw)


def _unpacked(arch, params, x, num_classes=2):
    model = SegModel(num_classes, 4, arch=arch)
    convert.load_flax_params(model, params)
    with torch.no_grad():
        return model(torch.from_numpy(x))


@pytest.mark.parametrize("pallas_conv", [False, "cat"])
def test_packed_dual_matches_jax(k1_spy, pallas_conv):
    """The serving configuration (pack_max_channels=64, dual) against JAX
    segmodel_apply_packed(pallas_conv="cat") and SegModel.apply."""
    params, x = _setup(ARCH_CAT)
    kw = dict(pack_max_channels=64, dual=True, upscale=4)
    j_lr, j_hr = jax.jit(lambda p, v: jax_packed(
        ARCH_CAT, p, v, pallas_conv="cat", **kw))(params, jnp.asarray(x))
    jm = JaxSegModel(num_classes=2, upscale=4, arch=dict(ARCH_CAT))
    r_lr, r_hr = jax.jit(jm.apply)(params, jnp.asarray(x))

    lr, hr = _port(ARCH_CAT, params, x, pallas_conv=pallas_conv, **kw)
    assert k1_spy == ([True] if pallas_conv else [])
    for got, want in ((lr, j_lr), (hr, j_hr), (lr, r_lr), (hr, r_hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_plane_out_matches_jax(k1_spy):
    """plane_out (the aligned engine's emission) with K1 engaged."""
    params, x = _setup(ARCH_CAT)
    kw = dict(pack_max_channels=64, dual=True, upscale=4, plane_out=True,
              pallas_conv="cat")
    j_lr, j_hr = jax.jit(lambda p, v: jax_packed(ARCH_CAT, p, v, **kw))(
        params, jnp.asarray(x))
    lr, hr = _port(ARCH_CAT, params, x, **kw)
    assert k1_spy == [True]
    assert lr.shape == (2, 2, 8, 32, 48) and hr.shape == (2, 2, 32, 32, 48)
    np.testing.assert_allclose(lr.numpy(), np.asarray(j_lr), **TOL)
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), **TOL)


@pytest.mark.parametrize("arch,counts", [
    (ARCH_ALL, dict(pconv_pad11_cat=1, pconv_valid=2, pconv3_valid=2)),
    (ARCH_ALL3, dict(pconv_pad11=2, pconv_valid=1, pconv3_valid=2)),
], ids=["two_convs", "three_convs_stage0"])
def test_pallas_all_matches_jax(monkeypatch, arch, counts):
    """pallas_conv=True (every covered stride-1 packed conv through a
    kernel, offset tensors 8-aligned wide) against JAX pallas_conv=True
    (Pallas in interpret mode) and SegModel.apply; both engage the same
    kernels in the same order."""
    from rehrseg_tpu.ops import pallas_pconv
    j_calls = _spy_kernels(monkeypatch, pallas_pconv)
    t_calls = _spy_kernels(monkeypatch, pconv)
    params, x = _setup(arch, shape=(2, 8, 32, 64, 1))
    kw = dict(pack_max_channels=64, dual=True, upscale=4, pallas_conv=True)
    j_lr, j_hr = jax.jit(lambda p, v: jax_packed(arch, p, v, **kw))(
        params, jnp.asarray(x))
    jm = JaxSegModel(num_classes=2, upscale=4, arch=dict(arch))
    r_lr, r_hr = jax.jit(jm.apply)(params, jnp.asarray(x))

    lr, hr = _port(arch, params, x, **kw)
    assert t_calls == j_calls
    assert all(covered for _, covered in t_calls)
    assert Counter(name for name, _ in t_calls) == counts
    for got, want in ((lr, j_lr), (hr, j_hr), (lr, r_lr), (hr, r_hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pallas_all_plane_out_matches_jax(monkeypatch):
    """pallas_conv=True with plane_out, the aligned engine's emission."""
    t_calls = _spy_kernels(monkeypatch, pconv)
    params, x = _setup(ARCH_ALL, shape=(1, 8, 32, 64, 1))
    kw = dict(pack_max_channels=64, dual=True, upscale=4, plane_out=True,
              pallas_conv=True)
    j_lr, j_hr = jax.jit(lambda p, v: jax_packed(ARCH_ALL, p, v, **kw))(
        params, jnp.asarray(x))
    lr, hr = _port(ARCH_ALL, params, x, **kw)
    assert len(t_calls) == 5 and all(c for _, c in t_calls)
    assert lr.shape == (1, 2, 8, 32, 64) and hr.shape == (1, 2, 32, 32, 64)
    np.testing.assert_allclose(lr.numpy(), np.asarray(j_lr), **TOL)
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), **TOL)


def _spy_fused(monkeypatch, module):
    """Records (entry point, covered, pre given, want_stats) for every call
    of the K1/K3/K5 entry points of ``module``."""
    calls = []
    for name in ("pconv_pad11_cat", "pconv_valid", "pconv3_valid"):
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            y = _orig(*a, **k)
            calls.append((_name, y is not None, k.get("pre") is not None,
                          bool(k.get("want_stats"))))
            return y

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("arch,shape,tol,engaged", [
    (ARCH_CAT, (2, 8, 32, 48, 1), TOL,
     [("pconv_valid", True, True, True),
      ("pconv_pad11_cat", True, False, True),
      ("pconv_valid", True, True, True)]),
    (ARCH_ALL, (2, 8, 32, 64, 1), dict(rtol=5e-4, atol=5e-4),
     [("pconv_valid", True, True, True),
      ("pconv3_valid", True, True, True),
      ("pconv3_valid", True, True, True),
      ("pconv_pad11_cat", True, False, True),
      ("pconv_valid", True, True, True)]),
], ids=["features32", "kd3"])
def test_fused_matches_jax(monkeypatch, arch, shape, tol, engaged):
    """pallas_conv="fused" (the deferred instance norm: K6a emits stats
    at the decoder concat, K6b/K6c apply the norm as they load and emit
    the aligned output's stats) against JAX's "fused" forward (Pallas in
    interpret mode) and SegModel.apply, at the JAX tests' tolerances
    (2e-4; 5e-4 through the kd=3 class). Spies on both packages show the
    same kernels with pre=/want_stats= at the same sites."""
    from rehrseg_tpu.ops import pallas_pconv
    j_calls = _spy_fused(monkeypatch, pallas_pconv)
    t_calls = _spy_fused(monkeypatch, pconv)
    params, x = _setup(arch, shape=shape)
    kw = dict(pack_max_channels=64, dual=True, upscale=4,
              pallas_conv="fused")
    j_lr, j_hr = jax.jit(lambda p, v: jax_packed(arch, p, v, **kw))(
        params, jnp.asarray(x))
    jm = JaxSegModel(num_classes=2, upscale=4, arch=dict(arch))
    r_lr, r_hr = jax.jit(jm.apply)(params, jnp.asarray(x))

    lr, hr = _port(arch, params, x, **kw)
    assert t_calls == j_calls == engaged
    for got, want in ((lr, j_lr), (hr, j_hr), (lr, r_lr), (hr, r_hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_fused_uncovered_arch_matches_packed(monkeypatch):
    """At 8/16 features no kernel covers a site: "fused" defers nothing
    and equals the port's own plain packed forward (2e-5, the JAX test's
    tolerance for fp reassociation)."""
    calls = _spy_fused(monkeypatch, pconv)
    params, x = _setup(ARCH_SMALL)
    base = _port(ARCH_SMALL, params, x, pack_max_channels=64)
    fused = _port(ARCH_SMALL, params, x, pack_max_channels=64,
                  pallas_conv="fused")
    assert not any(covered for _, covered, _, _ in calls)
    np.testing.assert_allclose(fused.numpy(), base.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_fused_plane_out_matches_jax(monkeypatch):
    """"fused" with plane_out (the aligned engine's emission) against
    JAX's "fused" planes and the port's channel-last packed logits."""
    calls = _spy_fused(monkeypatch, pconv)
    params, x = _setup(ARCH_CAT)
    kw = dict(pack_max_channels=64, plane_out=True, pallas_conv="fused")
    j_planes = jax.jit(lambda p, v: jax_packed(ARCH_CAT, p, v, **kw))(
        params, jnp.asarray(x))
    planes = _port(ARCH_CAT, params, x, **kw)
    base = _port(ARCH_CAT, params, x, pack_max_channels=64)
    assert len(calls) == 3 and all(c for _, c, _, _ in calls)
    assert planes.shape == (2, 2, 8, 32, 48)
    np.testing.assert_allclose(planes.numpy(), np.asarray(j_planes), **TOL)
    np.testing.assert_allclose(planes.numpy(),
                               torch.movedim(base, -1, 1).numpy(), **TOL)


def test_packed_uncovered_arch_concatenates(k1_spy):
    """At 8/16 features K1 never covers the concat: "cat" is exactly the
    plain packed path."""
    params, x = _setup(ARCH_SMALL)
    base = _port(ARCH_SMALL, params, x, pack_max_channels=64)
    cat = _port(ARCH_SMALL, params, x, pack_max_channels=64,
                pallas_conv="cat")
    assert not any(k1_spy)
    torch.testing.assert_close(cat, base, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["auto", "cell4", "legacy"])
def test_sr_head_forms_match_unpacked(form):
    params, x = _setup(ARCH_SMALL)
    lr, hr = _port(ARCH_SMALL, params, x, pack_max_channels=64, dual=True,
                   upscale=4, sr_head_form=form)
    r_lr, r_hr = _unpacked(ARCH_SMALL, params, x)
    torch.testing.assert_close(lr, r_lr, **TOL)
    torch.testing.assert_close(hr, r_hr, **TOL)


@pytest.mark.parametrize("pack_max", [0, 16, 64])
def test_pack_thresholds_match_unpacked(pack_max):
    params, x = _setup(ARCH_SMALL)
    lr = _port(ARCH_SMALL, params, x, pack_max_channels=pack_max)
    torch.testing.assert_close(lr, _unpacked(ARCH_SMALL, params, x)[0],
                               **TOL)


@pytest.mark.parametrize("case", ["three_convs", "odd_spatial",
                                  "unusual_strides", "three_classes"])
def test_packed_variants_match_unpacked(case):
    """The parity cycle u->o->a->o (stages ending OFFSET), odd in-plane
    dims falling back per stage, strides the packed dispatch routes to the
    standard path, and a 3-class head layout."""
    arch, shape, ncls = ARCH_SMALL, (1, 8, 32, 48, 1), 2
    if case == "three_convs":
        arch = dict(ARCH_SMALL, n_conv_per_stage=(3, 3, 3, 3),
                    n_conv_per_stage_decoder=(3, 3, 3))
    elif case == "odd_spatial":
        shape = (1, 8, 40, 56, 1)
    elif case == "unusual_strides":
        arch = dict(ARCH_SMALL,
                    kernel_sizes=((1, 3, 3), (1, 3, 3), (1, 3, 3),
                                  (3, 3, 3)),
                    strides=((1, 1, 1), (2, 1, 1), (2, 2, 2), (1, 2, 2)))
    else:
        ncls = 3
    params, x = _setup(arch, shape, num_classes=ncls)
    lr, hr = _port(arch, params, x, pack_max_channels=64, dual=True,
                   upscale=4)
    r_lr, r_hr = _unpacked(arch, params, x, num_classes=ncls)
    torch.testing.assert_close(lr, r_lr, **TOL)
    torch.testing.assert_close(hr, r_hr, **TOL)


def test_mixed_dtypes_promote():
    """A bf16 batch with fp32 params promotes to fp32, like flax."""
    params, x = _setup(ARCH_SMALL)
    with torch.no_grad():
        out = segmodel_apply_packed(
            ARCH_SMALL, convert.tree_to_torch(params),
            torch.from_numpy(x).to(torch.bfloat16), pack_max_channels=64)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("kw", [dict(remat=True), dict(return_skips=True)],
                         ids=["remat", "skips"])
def test_unported_options_raise(kw):
    """remat and return_skips, which raised NotImplementedError until the
    training slice, now run: the outputs (and the unpacked skips) equal
    JAX's packed forward under the same option."""
    params, x = _setup(ARCH_SMALL)
    kw = dict(kw, dual=True, pack_max_channels=64)
    got = _port(ARCH_SMALL, params, x, **kw)
    want = jax.jit(lambda p, v: jax_packed(ARCH_SMALL, p, v, **kw))(
        params, jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if kw.get("return_skips"):
        assert len(got[2]) == len(want[2]) == ARCH_SMALL["n_stages"]
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
