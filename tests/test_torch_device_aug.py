"""The port's device augmentation against the JAX package's, on the CPU:
the warp functions (prefilter matrix, cubic and linear sampling, the
rotate/scale mesh, the data and label warps), ``_blur3`` with its
symmetric padding, ``_lowres_matrices``, and the apply half at the very
parameters JAX's ``jax.random`` draws for a key (read back by repeating
its splits), so the whole ``augment_seg_batch`` and
``augment_sr_hr_batch`` are held against JAX's output; the draw half's
apply frequencies over a seeded run within 3 sigma of each p. Data at
rtol = atol = 1e-4 (fp32), labels equal on all but 1e-3 of the voxels (a
bilinear value at the 0.5 threshold may round either way). The card
against the CPU is in tests/test_torch_train_card.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.data import device_aug as jaug
from rehrseg_tpu.ops import warp as jwarp
from rehrseg_tpu_torch.data import device_aug as taug
from rehrseg_tpu_torch.ops import warp as twarp

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _img(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_prefilter_and_cubic_sampling():
    img = _img(0, (11, 9))
    np.testing.assert_array_equal(twarp.prefilter_matrix(11),
                                  jwarp.prefilter_matrix(11))
    np.testing.assert_allclose(twarp.prefilter_2d(torch.from_numpy(img)),
                               np.asarray(jwarp.prefilter_2d(
                                   jnp.asarray(img))), **TOL)
    # coordinates inside, outside (mirror) and on integer points
    coords = np.random.default_rng(1).uniform(-3, 13, size=(2, 7, 6))
    coords[:, 0, 0] = (4.0, 5.0)
    coords = coords.astype(np.float32)
    for fn_t, fn_j in ((twarp.map_coordinates_cubic_2d,
                        jwarp.map_coordinates_cubic_2d),
                       (twarp.map_coordinates_linear_2d,
                        jwarp.map_coordinates_linear_2d)):
        np.testing.assert_allclose(
            fn_t(torch.from_numpy(img), torch.from_numpy(coords)).numpy(),
            np.asarray(fn_j(jnp.asarray(img), jnp.asarray(coords))), **TOL)


@pytest.mark.parametrize("angle,scale", [(0.0, 1.0), (0.7, 1.0),
                                         (-2.5, 0.8), (1.9, 1.3)])
def test_rotate_scale_and_warps(angle, scale):
    in_shape, patch = (20, 18), (12, 10)
    jc, jm = jwarp.rotate_scale_coords(patch, jnp.float32(angle),
                                       jnp.float32(scale), in_shape)
    tc, tm = twarp.rotate_scale_coords(patch, torch.tensor(angle),
                                       torch.tensor(scale), in_shape)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    img = _img(2, in_shape)
    seg = (img > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        twarp.warp_data_2d(torch.from_numpy(img), tc, tm).numpy(),
        np.asarray(jwarp.warp_data_2d(jnp.asarray(img), jc, jm)), **TOL)
    got = twarp.warp_seg_2d(torch.from_numpy(seg), tc, tm).numpy()
    want = np.asarray(jwarp.warp_seg_2d(jnp.asarray(seg), jc, jm))
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("shape", [(5, 12, 9), (2, 8, 8), (1, 6, 3)])
def test_blur3(shape):
    x = _img(3, shape)
    for sigma in (0.5, 0.77, 1.0):
        want = jaug._blur3(jnp.asarray(x), jnp.float32(sigma))
        got = taug._blur3(torch.from_numpy(x)[None],
                          torch.tensor([sigma]))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 7, 16, 33])
def test_lowres_matrices(n):
    np.testing.assert_array_equal(taug._lowres_matrices(n),
                                  jaug._lowres_matrices(n))


# ------------------------------------------- JAX's draws, read back

def _u(key, lo=0.0, hi=1.0):
    return float(jax.random.uniform(key, minval=lo, maxval=hi))


def _jax_gamma(key, p):
    k0, k1, k2, k3 = jax.random.split(key, 4)
    return {"apply": _u(k0) < p,
            "gamma": _u(k2, 0.7, 1.0) if _u(k1) < 0.5 else _u(k3, 1.0, 1.5)}


def _jax_intensity(key, shape):
    """_intensity_one's draws for one sample (data shape (z, y, x))."""
    k = jax.random.split(key, 13)
    return {
        "noise": _u(k[0]) < 0.1, "noise_std": _u(k[1], 0.0, 0.1),
        "noise_field": np.asarray(jax.random.normal(k[2], shape)),
        "blur": (_u(k[3]) < 0.2) and (_u(k[5]) < 0.5),
        "sigma": _u(k[4], 0.5, 1.0),
        "bright": _u(k[6]) < 0.15, "mult": _u(k[7], 0.75, 1.25),
        "contrast": _u(k[8]) < 0.15, "factor": _u(k[9], 0.75, 1.25),
        "lowres": (_u(k[11]) < 0.25) and (_u(k[12]) < 0.5),
        "zoom_index": int(jax.random.randint(k[10], (), 0,
                                             len(jaug._ZOOM_FACTORS))),
    }


def _jax_spatial(key):
    kr, ks, ka, kc = jax.random.split(key, 4)
    k1, k2, k3 = jax.random.split(kc, 3)
    low = _u(k2, 0.7, 1.0) if _u(k1) < 0.5 else _u(k3, 1.0, 1.4)
    return {"angle": _u(ka, -math.pi, math.pi) if _u(kr) < 0.2 else 0.0,
            "scale": low if _u(ks) < 0.2 else 1.0}


def _stack(samples):
    """Per-sample dicts -> one dict of batched tensors."""
    out = {}
    for k, v in samples[0].items():
        if isinstance(v, dict):
            out[k] = _stack([s[k] for s in samples])
        else:
            a = np.stack([np.asarray(s[k]) for s in samples])
            out[k] = torch.as_tensor(a.astype(np.float32) if a.dtype.kind
                                     == "f" else a)
    return out


def _jax_seg_params(key, b, depth, patch_hw):
    keys = jax.random.split(key, b * 3).reshape(b, 3)
    sp, it = [], []
    for i in range(b):
        sp.append(_jax_spatial(keys[i, 0]))
        p = _jax_intensity(keys[i, 1], (depth, *patch_hw))
        kg1, kg2 = jax.random.split(keys[i, 2])
        p["gamma_invert"] = _jax_gamma(kg1, 0.1)
        p["gamma"] = _jax_gamma(kg2, 0.3)
        it.append(p)
    return {"spatial": _stack(sp), "intensity": _stack(it)}


def _fired(params):
    p = params["intensity"]
    return {"rot": bool((params["spatial"]["angle"] != 0).any()),
            "scale": bool((params["spatial"]["scale"] != 1).any()),
            **{k: bool(p[k].any()) for k in ("noise", "blur", "bright",
                                              "contrast", "lowres")},
            "gamma_invert": bool(p["gamma_invert"]["apply"].any()),
            "gamma": bool(p["gamma"]["apply"].any())}


def _seg_batch(seed, b=32, z=2, sep=2, hw=(14, 12)):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, z, *hw, 1)).astype(np.float32)
    llr = (rng.uniform(size=(b, z, *hw, 1)) > 0.5).astype(np.float32)
    lhr = (rng.uniform(size=(b, z * sep, *hw, 1)) > 0.5).astype(np.float32)
    unc = rng.uniform(0.3, 1.0, size=(b, z, *hw, 1)).astype(np.float32)
    return img, llr, lhr, unc


@pytest.mark.parametrize("enable_uncertainty", [True, False])
def test_augment_seg_batch_matches_jax(enable_uncertainty):
    """JAX's augment_seg_batch on a key against the port's apply half at
    the parameters that key draws; every branch fires in the batch."""
    arrays = _seg_batch(4)
    patch_hw = (8, 10)
    key = jax.random.key(11)
    want = jax.jit(lambda k, *a: jaug.augment_seg_batch(
        k, *a, patch_hw=patch_hw, enable_uncertainty=enable_uncertainty))(
        key, *map(jnp.asarray, arrays))
    params = _jax_seg_params(key, arrays[0].shape[0], arrays[0].shape[1],
                             patch_hw)
    assert all(_fired(params).values()), _fired(params)
    got = taug.apply_seg_aug(params, *map(torch.from_numpy, arrays),
                             patch_hw=patch_hw,
                             enable_uncertainty=enable_uncertainty)
    for name, g, w in zip(("img", "label_lr", "label_hr", "unc"), got,
                          want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name.startswith("label"):
            assert (g != w).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_augment_sr_hr_batch_matches_jax():
    hr = _img(5, (24, 3, 8, 8, 2))
    key = jax.random.key(12)
    want = jaug.augment_sr_hr_batch(key, jnp.asarray(hr))
    keys = jax.random.split(key, hr.shape[0])
    samples = []
    for k in keys:
        k0, k1, k2 = jax.random.split(k, 3)
        p = _jax_intensity(k0, hr.shape[1:4])
        p["gamma_invert"] = _jax_gamma(k1, 0.1)
        p["gamma"] = _jax_gamma(k2, 0.3)
        samples.append(p)
    params = _stack(samples)
    got = taug._intensity(params, torch.from_numpy(hr[..., 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[..., 0]), **TOL)
    np.testing.assert_array_equal(np.asarray(want[..., 1]), hr[..., 1])
    out = taug.augment_sr_hr_batch(torch.Generator().manual_seed(0),
                                   torch.from_numpy(hr))
    assert out.shape == hr.shape
    np.testing.assert_array_equal(out[..., 1].numpy(), hr[..., 1])


def test_apply_frequencies():
    """Each branch's share over 20000 seeded draws within 3 sigma of its
    p; the uniform parameters inside their ranges."""
    n = 20000
    p = taug.draw_seg_aug_params(torch.Generator().manual_seed(0), n, 1,
                                 (1, 1))
    sp, it = p["spatial"], p["intensity"]
    shares = {"rot": ((sp["angle"] != 0).float().mean(), 0.2),
              "scale": ((sp["scale"] != 1).float().mean(), 0.2),
              "noise": (it["noise"].float().mean(), 0.1),
              "blur": (it["blur"].float().mean(), 0.1),
              "bright": (it["bright"].float().mean(), 0.15),
              "contrast": (it["contrast"].float().mean(), 0.15),
              "lowres": (it["lowres"].float().mean(), 0.125),
              "gamma_invert": (it["gamma_invert"]["apply"].float().mean(),
                               0.1),
              "gamma": (it["gamma"]["apply"].float().mean(), 0.3)}
    for name, (share, prob) in shares.items():
        sigma = math.sqrt(prob * (1 - prob) / n)
        assert abs(float(share) - prob) <= 3 * sigma, (name, float(share))
    assert float(sp["angle"].abs().max()) <= math.pi
    s = sp["scale"][sp["scale"] != 1]
    assert 0.7 <= float(s.min()) and float(s.max()) <= 1.4
    low = (s < 1).float().mean()
    assert abs(float(low) - 0.5) <= 3 * math.sqrt(0.25 / len(s))
    assert set(it["zoom_index"].unique().tolist()) == set(range(6))
    g = it["gamma"]["gamma"]
    assert 0.7 <= float(g.min()) and float(g.max()) <= 1.5


def test_augment_seg_batch_draws_from_the_generator():
    arrays = [torch.from_numpy(a) for a in _seg_batch(6, b=4)]
    a = taug.augment_seg_batch(torch.Generator().manual_seed(3), *arrays,
                               patch_hw=(8, 10))
    b = taug.augment_seg_batch(torch.Generator().manual_seed(3), *arrays,
                               patch_hw=(8, 10))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].shape == (4, 2, 8, 10, 1) and a[2].shape == (4, 4, 8, 10, 1)
