"""K6, the deferred-norm forms of K1/K3/K5 (``pconv_pad11_cat(want_stats=
True)``, ``pconv_valid(pre=, want_stats=, wide=)``, ``pconv3_valid(pre=,
want_stats=)``): the port's plain PyTorch versions against the JAX Pallas
kernels in interpret mode, on the same numpy inputs; and, on a machine
with a card, each CUDA kernel against its plain version.

The outputs are compared elementwise; the statistics only as their two
half-sums (rows 0:8, the sum, and rows 8:16, the sum of squares), which
are the contract. JAX is imported inside the tests that compare with it:
the card's machine has no JAX, and runs the ``cuda``-marked tests of this
file with ``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops import pconv

torch.set_num_threads(2)

C = 128     # the smallest covered packed channel count
SLOPE = 0.01

# y: the outputs' tolerance (JAX's pconv tests: fp32 2e-5, bf16 0.04).
# Sums of squares: relative (no cancellation). Sums: relative, plus an
# absolute part of y's tolerance times the root of the pixel count, since
# a sum of signed values may cancel to near zero while each of its terms
# carries y's error.
DTYPES = {"fp32": (torch.float32, "float32", 2e-5),
          "bf16": (torch.bfloat16, "bfloat16", 0.04)}
STATS_RTOL = {"fp32": 1e-4, "bf16": 2e-2}


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pallas_pconv
    return jnp, pallas_pconv


def _rng(seed):
    return np.random.default_rng(seed)


def _offset(lead, hp, wp8, w_out, seed=0):
    """A raw offset tensor stored wp8 wide: a nonzero rim (the consumer's
    rim mask must zero it) and garbage in the pad columns (> w_out), which
    must never be read."""
    x = _rng(seed).normal(size=(*lead, hp, wp8, C)).astype(np.float32)
    x[..., w_out + 1:, :] = 1e3 * _rng(seed + 1).normal(
        size=x[..., w_out + 1:, :].shape)
    return x


def _pre(n, seed=5):
    """Per-image scale and shift (n, 8, C), 8 equal rows, scale > 0."""
    sa = np.abs(_rng(seed).normal(size=(n, 1, C))) + 0.5
    ta = 0.5 * _rng(seed + 1).normal(size=(n, 1, C))
    return (np.repeat(sa, 8, 1).astype(np.float32),
            np.repeat(ta, 8, 1).astype(np.float32))


def _weights(kd, seed=1, c_in=C, c_out=C):
    shape = (2, 2, c_in, c_out) if kd == 1 else (3, 2, 2, c_in, c_out)
    w = _rng(seed).normal(size=shape) / np.sqrt(4 * kd * c_in)
    b = 0.1 * _rng(seed + 1).normal(size=(c_out,))
    return w.astype(np.float32), b.astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _half_sums(stats):
    s = np.asarray(stats, np.float32)
    return s[:, :8].sum(1), s[:, 8:].sum(1)


def check_stats(got, want, y, dt):
    """got/want (N, 16, Co) partials of y (N, ..., Co): half-sums within
    the tolerances stated above."""
    tol = DTYPES[dt][2]
    rtol = STATS_RTOL[dt]
    npix = np.prod(y.shape[1:-1]) if y.ndim > 2 else 1
    (gs, gq), (ws, wq) = _half_sums(got), _half_sums(want)
    np.testing.assert_allclose(gq, wq, rtol=rtol, atol=tol)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=tol * np.sqrt(npix))


def _run_both(name, dt, x, w, b, pre=None, **kw):
    """The same call on both packages; returns the port's result."""
    jnp, pp = _jax()
    tdt, jdt, tol = DTYPES[dt]
    jkw, tkw = dict(kw), dict(kw)
    if pre is not None:
        sa, ta = pre
        jkw["pre"] = (jnp.asarray(sa, jdt), jnp.asarray(ta, jdt), SLOPE)
        tkw["pre"] = (_t(sa, tdt), _t(ta, tdt), SLOPE)
    want = getattr(pp, name)(*(jnp.asarray(a, jdt) for a in (x, w, b)),
                             interpret=True, **jkw)
    got = getattr(pconv, name)(*(_t(a, tdt) for a in (x, w, b)), **tkw)
    stats = kw.get("want_stats", False)
    gy, wy = (got[0], want[0]) if stats else (got, want)
    assert gy.dtype == tdt
    wy = np.asarray(wy, np.float32)
    assert tuple(gy.shape) == wy.shape
    np.testing.assert_allclose(gy.float().numpy(), wy, rtol=tol, atol=tol)
    if stats:
        assert got[1].dtype == torch.float32
        assert tuple(got[1].shape) == tuple(want[1].shape)
        check_stats(got[1].numpy(), want[1], wy, dt)
    return got


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("pre,want_stats", [(True, True), (True, False),
                                            (False, True)],
                         ids=["pre_stats", "pre_only", "stats_only"])
def test_k6b_plain_matches_pallas(dt, pre, want_stats):
    """pconv_valid(pre=, want_stats=) on a raw offset input with a nonzero
    rim and garbage pad columns."""
    x = _offset((3,), 9, 32, 24)
    w, b = _weights(1)
    got = _run_both("pconv_valid", dt, x, w, b, pre=_pre(3) if pre else None,
                    w_out=24, want_stats=want_stats)
    y = got[0] if want_stats else got
    assert y.shape == (3, 8, 24, C)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_k6c_plain_matches_pallas(dt, d):
    """pconv3_valid(pre=, want_stats=): per-batch scale and shift, z taps
    outside [0, D) zero after the transform (D = 1, 2 and 4 cover both
    z gates and the interior), stats per (b, z) image."""
    x = _offset((2, d), 9, 32, 24)
    w, b = _weights(3, c_out=2 * C)
    y, stats = _run_both("pconv3_valid", dt, x, w, b, pre=_pre(2),
                         w_out=24, want_stats=True)
    assert y.shape == (2, d, 8, 24, 2 * C)
    assert stats.shape == (2 * d, 16, 2 * C)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_k6a_plain_matches_pallas(dt):
    """pconv_pad11_cat(want_stats=True): the full offset rim mask on the
    output, its statistics."""
    rng = _rng(0)
    xa = rng.normal(size=(3, 8, 16, C)).astype(np.float32)
    xb = rng.normal(size=(3, 8, 16, C)).astype(np.float32)
    w, b = _weights(1, c_in=2 * C)
    jnp, pp = _jax()
    tdt, jdt, tol = DTYPES[dt]
    want = pp.pconv_pad11_cat(*(jnp.asarray(a, jdt) for a in (xa, xb, w, b)),
                              interpret=True, want_stats=True)
    y, stats = pconv.pconv_pad11_cat(*(_t(a, tdt) for a in (xa, xb, w, b)),
                                     want_stats=True)
    wy = np.asarray(want[0], np.float32)
    assert y.shape == (3, 9, 24, C) and y.dtype == tdt
    np.testing.assert_allclose(y.float().numpy(), wy, rtol=tol, atol=tol)
    check_stats(stats.numpy(), want[1], wy, dt)
    # the rim: row 0 keeps only dy = 1 groups, columns > w are zeros
    assert torch.all(y[:, 0, :, :2 * C // 4] == 0)
    assert torch.all(y[:, :, 17:] == 0)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_wide_matches_pallas(fused):
    """pconv_valid(wide=True), the TPU kernel's doubled-N dot structure:
    the same function, fp32."""
    x = _offset((2,), 9, 32, 24)
    w, b = _weights(1)
    kw = dict(pre=_pre(2), want_stats=True) if fused else {}
    _run_both("pconv_valid", "fp32", x, w, b, w_out=24, wide=True, **kw)


@pytest.mark.parametrize("name", ["pconv_valid", "pconv3_valid"])
def test_fused_none_where_jax_returns_none(name):
    """The shape predicates hold with pre/want_stats too (w_out % 8)."""
    jnp, pp = _jax()
    kd = 1 if name == "pconv_valid" else 3
    x = _offset((1,) if kd == 1 else (1, 2), 5, 24, 12)
    w, _ = _weights(kd)
    sa, ta = _pre(1)
    assert getattr(pp, name)(jnp.asarray(x), jnp.asarray(w), None,
                             w_out=12, interpret=True, want_stats=True,
                             pre=(jnp.asarray(sa), jnp.asarray(ta),
                                  SLOPE)) is None
    assert getattr(pconv, name)(_t(x), _t(w), None, w_out=12,
                                want_stats=True,
                                pre=(_t(sa), _t(ta), SLOPE)) is None


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _case(name, dev, dtype):
    """(wrapper, its args as card tensors, kwargs, reference) of one K6
    check at a small shape with several images per block. The reference
    is the plain version with its conv in fp32 (TF32 off) and its pre
    transform in the working dtype, as the kernel's."""
    rng = _rng(0)
    if name == "k6a":
        xa = rng.normal(size=(4, 16, 32, C))
        xb = rng.normal(size=(4, 16, 32, C))
        w, b = _weights(1, c_in=2 * C)
        args = [_t(a, dtype).to(dev) for a in (xa, xb, w, b)]
        return (pconv.pconv_pad11_cat, args, dict(want_stats=True),
                lambda: pconv.pconv_pad11_cat_plain(
                    *(a.float() for a in args), want_stats=True))
    if name == "k6b":
        x = _offset((4,), 17, 40, 32)
        w, b = _weights(1)
        sa, ta = _pre(4)
        fn, plain = pconv.pconv_valid, pconv.pconv_valid_plain
    else:
        x = _offset((2, 3), 9, 40, 32)
        w, b = _weights(3, c_out=2 * C)
        sa, ta = _pre(2)
        fn, plain = pconv.pconv3_valid, pconv.pconv3_valid_plain
    args = [_t(a, dtype).to(dev) for a in (x, w, b)]
    pre = (_t(sa, dtype).to(dev), _t(ta, dtype).to(dev), SLOPE)

    def ref():
        xt = pconv.pre_plain(args[0][..., :33, :], *pre).float()
        return plain(xt, args[1].float(), args[2].float(), 32,
                     want_stats=True)
    return fn, args, dict(w_out=32, pre=pre, want_stats=True), ref


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["k6a", "k6b", "k6c"])
def test_kernel_matches_plain(cuda_device, name, dt, monkeypatch):
    """Each K6 kernel against its plain version on the same card tensors,
    garbage in the VALID kernels' pad columns; stats as half-sums. Atomic
    accumulation order varies from run to run: the stats tolerances above
    cover it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    dtype, _, tol = DTYPES[dt]
    fn, args, kw, ref = _case(name, cuda_device, dtype)
    before = fn.fused_launches
    y, stats = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.fused_launches == before + 1
    ry, rstats = ref()
    torch.testing.assert_close(y.float(), ry, rtol=tol, atol=tol)
    check_stats(stats.cpu().numpy(), rstats.cpu().numpy(), ry.cpu(), dt)
