"""K1 (pconv_pad11_cat): the port's plain PyTorch version against the JAX
Pallas kernel in interpret mode, on the same numpy inputs; and, on a
machine with a card, the CUDA kernel against the plain version.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops.pack2d import (space_to_depth_hw,
                                          pack_conv_weights, pack_bias)
from rehrseg_tpu_torch.ops.pconv import (pconv_pad11_cat,
                                         pconv_pad11_cat_plain)

torch.set_num_threads(2)


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops.pallas_pconv import pconv_pad11_cat as jax_cat
    return jnp, jax_cat


def _inputs(n=2, d=2, h=16, w=32, ca_u=32, cb_u=32, co=32, seed=0):
    """Packed decoder-concat operands, as tests/test_pallas_pconv.py
    builds them: (n*d, h/2, w/2, 4*c) pairs and in_splits weights, as
    numpy arrays."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale,
                            dtype=torch.float32)

    up = space_to_depth_hw(t((n, d, h, w, ca_u)))
    sk = space_to_depth_hw(t((n, d, h, w, cb_u)))
    w3 = t((1, 3, 3, ca_u + cb_u, co), 0.2)
    b = t((co,), 0.1)
    wpk = pack_conv_weights(w3, in_splits=[ca_u, cb_u])[0]
    xa = up.reshape(n * d, h // 2, w // 2, -1).numpy()
    xb = sk.reshape(n * d, h // 2, w // 2, -1).numpy()
    return xa, xb, wpk.numpy(), pack_bias(b).numpy()


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def test_plain_matches_pallas_fp32():
    jnp, jax_cat = _jax()
    xa, xb, w, b = _inputs()
    want = np.asarray(jax_cat(jnp.asarray(xa), jnp.asarray(xb),
                              jnp.asarray(w), jnp.asarray(b),
                              interpret=True))
    got = pconv_pad11_cat(_t(xa), _t(xb), _t(w), _t(b))
    assert got.shape == want.shape == (4, 9, 24, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.all(got[:, :, 17:] == 0)      # columns > w: exact zeros


def test_plain_matches_pallas_bf16():
    jnp, jax_cat = _jax()
    xa, xb, w, _ = _inputs(n=1, h=8, w=16)
    bf = jnp.bfloat16
    want = np.asarray(jax_cat(jnp.asarray(xa, bf), jnp.asarray(xb, bf),
                              jnp.asarray(w, bf), None, interpret=True),
                      np.float32)
    got = pconv_pad11_cat(_t(xa, torch.bfloat16), _t(xb, torch.bfloat16),
                          _t(w, torch.bfloat16), None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.04,
                               atol=0.04)


@pytest.mark.parametrize("kw", [
    dict(n=1, h=8, w=16, ca_u=32, cb_u=64),          # Ca != Cb
    dict(n=1, h=8, w=16, co=96),                     # Co = 384
    dict(n=1, d=1, h=12, w=16, cb_u=64, co=64),      # h = 6, Co = 256, N = 1
], ids=["ca_ne_cb", "co_384", "h6_co256_batch1"])
def test_plain_matches_pallas_shapes(kw):
    """Shapes the Hopper kernel must take as well: unequal inputs, several
    blocks of output channels, a height that is no multiple of a tile's."""
    jnp, jax_cat = _jax()
    xa, xb, w, b = _inputs(**kw)
    want = np.asarray(jax_cat(jnp.asarray(xa), jnp.asarray(xb),
                              jnp.asarray(w), jnp.asarray(b),
                              interpret=True))
    got = pconv_pad11_cat(_t(xa), _t(xb), _t(w), _t(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.all(got[:, :, xa.shape[2] + 1:] == 0)


def _uncovered(xa, xb, w):
    """Operand variants the kernel does not cover."""
    return {
        "spatial_mismatch": (xa, xb[:, :-1], w),
        "ca_not_128": (xa[..., :64], xb, w[:, :, :192]),
        "co_not_128": (xa, xb, w[..., :64]),
        "w_not_8": (xa[:, :, :4], xb[:, :, :4], w),
        "w_channels_mismatch": (xa, xb, w[:, :, :128]),
    }


@pytest.mark.parametrize("case", ["spatial_mismatch", "ca_not_128",
                                  "co_not_128", "w_not_8",
                                  "w_channels_mismatch"])
def test_none_where_jax_returns_none(case):
    """The coverage predicate is JAX's: both return None on the same
    shapes, so the packed forward concatenates at the same sites."""
    jnp, jax_cat = _jax()
    xa, xb, w, _ = _inputs(n=1, h=8, w=16)
    a, b, ww = _uncovered(xa, xb, w)[case]
    assert jax_cat(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ww), None,
                   interpret=True) is None
    assert pconv_pad11_cat(_t(a), _t(b), _t(ww), None) is None


def test_dtype_mismatch_is_uncovered():
    jnp, jax_cat = _jax()
    xa, xb, w, _ = _inputs(n=1, h=8, w=16)
    assert jax_cat(jnp.asarray(xa), jnp.asarray(xb, jnp.bfloat16),
                   jnp.asarray(w), None, interpret=True) is None
    assert pconv_pad11_cat(_t(xa), _t(xb, torch.bfloat16), _t(w),
                           None) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.04)])
def test_kernel_matches_plain(cuda_device, dtype, tol, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    xa, xb, w, b = (_t(a, dtype).to(cuda_device) for a in _inputs())
    before = pconv_pad11_cat.launches
    got = pconv_pad11_cat(xa, xb, w, b)
    torch.cuda.synchronize()
    assert pconv_pad11_cat.launches == before + 1
    want = pconv_pad11_cat_plain(xa.float(), xb.float(), w.float(),
                                 b.float())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# (n, h, w, Ca, Cb, Co): an odd height and one and a half 16-wide tiles;
# Ca != Cb with Co = 256; Co = 384; an image smaller than one tile with a
# batch of one; the shapes of _inputs()
SM90_SHAPES = [(2, 13, 24, 128, 128, 128), (3, 7, 24, 128, 256, 256),
               (2, 16, 32, 256, 128, 384), (1, 3, 8, 128, 128, 128),
               (4, 8, 16, 128, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_SHAPES,
                         ids=["odd_h_ragged_w", "ca_ne_cb_co256", "co384",
                              "below_one_tile_batch1", "aligned"])
def test_sm90_kernel_matches_plain(cuda_device, shape, monkeypatch):
    """The bf16 wgmma / TMA kernel against the plain version on fp32
    copies (TF32 off), at ragged shapes; columns > w exact zeros."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, h, w, ca, cb, co = shape
    rng = np.random.default_rng(3)
    xa, xb, wt, b = (
        _t(a, torch.bfloat16).to(cuda_device) for a in (
            rng.normal(size=(n, h, w, ca)), rng.normal(size=(n, h, w, cb)),
            rng.normal(size=(2, 2, ca + cb, co)) / np.sqrt(4 * (ca + cb)),
            0.1 * rng.normal(size=(co,))))
    before = pconv_pad11_cat.launches
    got = pconv_pad11_cat(xa, xb, wt, b)
    torch.cuda.synchronize()
    assert pconv_pad11_cat.launches == before + 1
    want = pconv_pad11_cat_plain(xa.float(), xb.float(), wt.float(),
                                 b.float())
    torch.testing.assert_close(got.float(), want, rtol=0.04, atol=0.04)
    assert torch.all(got[:, :, w + 1:] == 0)
