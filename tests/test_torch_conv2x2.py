"""K7 (conv2x2_valid_bias, the VALID 2x2 packed conv on exact widths): the
port's plain PyTorch version against the JAX Pallas kernel in interpret
mode on tests/test_pallas_conv.py's shapes; and, on a machine with a card,
the CUDA kernel against its plain version.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops.conv2x2 import (conv2x2_valid_bias,
                                           conv2x2_valid_bias_plain)

torch.set_num_threads(2)

C = 128


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pallas_conv
    return jnp, pallas_conv


def _inputs(n, h, w, seed=0, c_out=C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h + 1, w + 1, C)).astype(np.float32)
    wk = (rng.normal(size=(2, 2, C, c_out)) * 0.05).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    return x, wk, b


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("n,h,w", [(2, 8, 12), (1, 16, 8)])
def test_plain_matches_pallas(n, h, w):
    """The JAX test's shapes and tolerance (fp32, 1e-4); the output width
    w is not a multiple of 8 in the first."""
    jnp, pc = _jax()
    x, wk, b = _inputs(n, h, w)
    want = pc.conv2x2_valid_bias(jnp.asarray(x), jnp.asarray(wk),
                                 jnp.asarray(b), interpret=True)
    got = conv2x2_valid_bias(_t(x), _t(wk), _t(b))
    assert got.shape == (n, h, w, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_plain_matches_pallas_bf16():
    jnp, pc = _jax()
    x, wk, _ = _inputs(1, 8, 13)
    bf = jnp.bfloat16
    want = pc.conv2x2_valid_bias(jnp.asarray(x, bf), jnp.asarray(wk, bf),
                                 None, interpret=True)
    got = conv2x2_valid_bias(_t(x, torch.bfloat16), _t(wk, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.04,
                               atol=0.04)


@pytest.mark.parametrize("case", ["ci_not_128", "co_not_128"])
def test_none_where_jax_returns_none(case):
    """JAX's channel predicate: None on the same shapes. (JAX's other
    refusal, a height with no block divisor, is a TPU block choice the
    port drops.)"""
    jnp, pc = _jax()
    if case == "ci_not_128":
        x, wk = np.zeros((1, 8, 9, 64)), np.zeros((2, 2, 64, 64))
    else:
        x, wk = np.zeros((1, 8, 9, C)), np.zeros((2, 2, C, 64))
    assert pc.conv2x2_valid_bias(jnp.asarray(x), jnp.asarray(wk)) is None
    assert conv2x2_valid_bias(_t(x), _t(wk)) is None


@pytest.mark.parametrize("n,h,w,c_out", [(1, 8, 21, 2 * C), (2, 2, 5, C)],
                         ids=["one_and_a_half_tiles_co256",
                              "below_one_tile"])
def test_plain_matches_pallas_bf16_odd_widths(n, h, w, c_out):
    """bf16 at odd output widths, as K3's Hopper kernel serves them on the
    card (the stored width w + 1 needs no alignment)."""
    jnp, pc = _jax()
    x, wk, b = _inputs(n, h, w, seed=2, c_out=c_out)
    bf = jnp.bfloat16
    want = pc.conv2x2_valid_bias(jnp.asarray(x, bf), jnp.asarray(wk, bf),
                                 jnp.asarray(b, bf), interpret=True)
    got = conv2x2_valid_bias(_t(x, torch.bfloat16), _t(wk, torch.bfloat16),
                             _t(b, torch.bfloat16))
    assert got.shape == (n, h, w, c_out) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.04,
                               atol=0.04)


def test_height_without_block_divisor_is_covered():
    """h = 3 (JAX refuses it for its TPU block choice): the port computes
    it, equal to a plain VALID conv."""
    x, wk, b = _inputs(1, 3, 8)
    got = conv2x2_valid_bias(_t(x), _t(wk), _t(b))
    want = conv2x2_valid_bias_plain(_t(x), _t(wk), _t(b))
    assert got.shape == (1, 3, 8, C)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.04)])
@pytest.mark.parametrize("n,h,w", [(2, 8, 12), (3, 17, 33), (1, 13, 24),
                                   (2, 1, 5)])
def test_kernel_matches_plain(cuda_device, n, h, w, dtype, tol,
                              monkeypatch):
    """The kernel on odd exact widths against its plain version in fp32
    (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, wk, b = (_t(a, dtype).to(cuda_device) for a in _inputs(n, h, w))
    before = conv2x2_valid_bias.launches
    got = conv2x2_valid_bias(x, wk, b)
    torch.cuda.synchronize()
    assert conv2x2_valid_bias.launches == before + 1
    want = conv2x2_valid_bias_plain(x.float(), wk.float(), b.float())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
