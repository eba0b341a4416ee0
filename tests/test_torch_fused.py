"""K6, the deferred-norm forms of K1/K3/K5 (``pconv_pad11_cat(want_stats=
True)``, ``pconv_valid(pre=, want_stats=, wide=)``, ``pconv3_valid(pre=,
want_stats=)``): the port's plain PyTorch versions against the JAX Pallas
kernels in interpret mode, on the same numpy inputs; and, on a machine
with a card, each CUDA kernel against its plain version (bf16 K6a, K6b and
K6c, the forms of the Hopper kernels, also at shapes that reach their
tiling's edges, K6b also in each of its kernel's timed variants).

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


def _offset(lead, hp, wp8, w_out, seed=0, c=C):
    """A raw offset tensor stored wp8 wide: a nonzero rim (the consumer's
    rim mask must zero it) and garbage in the pad columns (> w_out), which
    must never be read."""
    x = _rng(seed).normal(size=(*lead, hp, wp8, c)).astype(np.float32)
    x[..., w_out + 1:, :] = 1e3 * _rng(seed + 1).normal(
        size=x[..., w_out + 1:, :].shape)
    return x


def _pre(n, seed=5, c=C):
    """Per-image scale and shift (n, 8, c), 8 equal rows, scale > 0, every
    channel and image its own."""
    sa = np.abs(_rng(seed).normal(size=(n, 1, c))) + 0.5
    ta = 0.5 * _rng(seed + 1).normal(size=(n, 1, c))
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


# Shapes that reach the edges of the Hopper forms' tiling (128-pixel tiles 8,
# 16 or 32 wide) among those the TPU kernel's block choice takes. K6a (n, h,
# w, Ca, Cb, Co): h + 1 and w + 1 no multiple of a tile, w = 8, Ca != Cb, Co
# = 256 and 384. K6c (B, D, hp, wp8, Ci, Co, w_out): w_out = 8, Ci = 256, an
# image smaller than a tile, one and a half and two and a half tiles wide.
# K6b (n, hp, wp8, Ci, Co, w_out): w_out = 8 with Co = 256 on hp - 1 = 10;
# Ci = 256 on hp - 1 = 12, w_out = 32 (hp - 1 must have a small divisor: the
# TPU kernel's block choice).
K6B_EDGE = {"w_out8_co256": (2, 11, 16, C, 2 * C, 8),
            "ci256": (1, 13, 40, 2 * C, C, 32)}
K6A_EDGE = {"w8_co256": (2, 10, 8, C, C, 2 * C),
            "ca_ne_cb": (2, 12, 24, C, 2 * C, 2 * C),
            "co384": (2, 6, 8, C, C, 3 * C)}
K6C_EDGE = {"w_out8": (2, 2, 9, 16, C, C, 8),
            "ci256_small": (2, 3, 5, 16, 2 * C, C, 8),
            "wide": (1, 2, 17, 40, C, C, 32),
            "mid": (2, 2, 13, 24, C, C, 16)}
K6C_FORMS = {"pre_stats": (True, True), "pre_only": (True, False),
             "stats_only": (False, True)}


def _k6a_edge_operands(case):
    n, h, w_in, ca, cb, co = K6A_EDGE[case]
    rng = _rng(3)
    xa = rng.normal(size=(n, h, w_in, ca)).astype(np.float32)
    xb = rng.normal(size=(n, h, w_in, cb)).astype(np.float32)
    return (xa, xb, *_weights(1, c_in=ca + cb, c_out=co))


def _k6c_edge_operands(case):
    b, d, hp, wp8, ci, co, w_out = K6C_EDGE[case]
    return (_offset((b, d), hp, wp8, w_out, c=ci),
            *_weights(3, c_in=ci, c_out=co), _pre(b, c=ci), w_out)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K6A_EDGE))
def test_k6a_plain_matches_pallas_edge_shapes(dt, case):
    jnp, pp = _jax()
    tdt, jdt, tol = DTYPES[dt]
    ops = _k6a_edge_operands(case)
    want = pp.pconv_pad11_cat(*(jnp.asarray(a, jdt) for a in ops),
                              interpret=True, want_stats=True)
    y, stats = pconv.pconv_pad11_cat(*(_t(a, tdt) for a in ops),
                                     want_stats=True)
    wy = np.asarray(want[0], np.float32)
    assert tuple(y.shape) == wy.shape and y.dtype == tdt
    np.testing.assert_allclose(y.float().numpy(), wy, rtol=tol, atol=tol)
    check_stats(stats.numpy(), want[1], wy, dt)
    assert torch.all(y[:, :, K6A_EDGE[case][2] + 1:] == 0)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("form", list(K6C_FORMS))
@pytest.mark.parametrize("case", list(K6C_EDGE))
def test_k6c_plain_matches_pallas_edge_shapes(dt, case, form):
    x, w, b, pre, w_out = _k6c_edge_operands(case)
    use_pre, want_stats = K6C_FORMS[form]
    _run_both("pconv3_valid", dt, x, w, b, pre=pre if use_pre else None,
              w_out=w_out, want_stats=want_stats)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("form", list(K6C_FORMS))
@pytest.mark.parametrize("case", list(K6B_EDGE))
def test_k6b_plain_matches_pallas_edge_shapes(dt, case, form):
    n, hp, wp8, ci, co, w_out = K6B_EDGE[case]
    use_pre, want_stats = K6C_FORMS[form]
    got = _run_both("pconv_valid", dt, _offset((n,), hp, wp8, w_out, c=ci),
                    *_weights(1, c_in=ci, c_out=co),
                    pre=_pre(n, c=ci) if use_pre else None, w_out=w_out,
                    want_stats=want_stats)
    y = got[0] if want_stats else got
    assert y.shape == (n, hp - 1, w_out, co)


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


# The Hopper forms (bf16 K6a and K6c) at shapes that reach their tiling's
# edges. K6a (n, h, w, Ca, Cb, Co): odd h + 1, one and a half tiles wide, Ca
# != Cb, Co = 256; Co = 384 on an image smaller than a tile, w = 8; Ca = 256;
# enough tiles that every block goes round its ring several times.
K6A_CARD = {"odd_cb256": (2, 13, 24, C, 2 * C, 2 * C),
            "small_co384": (1, 3, 8, C, C, 3 * C),
            "ca256": (3, 7, 24, 2 * C, C, C),
            "ring_rounds": (40, 33, 64, C, C, C)}
# K6c (B, D, hp, wp8, Ci, Co), w_out = wp8 - 8: D = 1, 2 and 4, an even hp - 1
# and an odd one, Ci = 128 and 256, w_out = 8, several ring rounds a block
K6C_CARD = {"d1": (2, 1, 14, 32, C, C),
            "d2_co384": (1, 2, 10, 32, C, 3 * C),
            "d4_ci256": (2, 4, 17, 40, 2 * C, C),
            "w_out8": (2, 2, 9, 16, C, 2 * C),
            "ring_rounds": (3, 4, 33, 72, 2 * C, 2 * C)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K6A_CARD))
def test_k6a_hopper_matches_plain(cuda_device, case, monkeypatch):
    """bf16 K6a on the wgmma / TMA kernel: y, its exact zeros (rim slots
    and columns > w) and the stats' half-sums against the plain version in
    fp32 on the same operands."""
    from rehrseg_tpu_torch.ops import pack2d
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, h, w_in, ca, cb, co = K6A_CARD[case]
    rng = _rng(7)
    xa = rng.normal(size=(n, h, w_in, ca))
    xb = rng.normal(size=(n, h, w_in, cb))
    args = [_t(a, torch.bfloat16).to(cuda_device)
            for a in (xa, xb, *_weights(1, c_in=ca + cb, c_out=co))]
    before = pconv.pconv_pad11_cat.fused_launches
    y, stats = pconv.pconv_pad11_cat(*args, want_stats=True)
    torch.cuda.synchronize()
    assert pconv.pconv_pad11_cat.fused_launches == before + 1
    ry, rstats = pconv.pconv_pad11_cat_plain(*(a.float() for a in args),
                                             want_stats=True)
    torch.testing.assert_close(y.float(), ry, rtol=0.04, atol=0.04)
    check_stats(stats.cpu().numpy(), rstats.cpu().numpy(), ry.cpu(), "bf16")
    mask = pack2d.offset_rim_mask(h + 1, y.shape[2], co // 4, torch.bool,
                                  cuda_device, true_w=w_in + 1)
    assert torch.all(y[:, ~mask] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(K6C_FORMS))
@pytest.mark.parametrize("case", list(K6C_CARD))
def test_k6c_hopper_matches_plain(cuda_device, case, form, monkeypatch):
    """bf16 K6c on the wgmma / TMA kernel with pre, want_stats or both
    (scale and shift differ per channel and per batch element, the input's
    rim is nonzero, its pad columns garbage) against the plain version: pre
    in bf16, as the kernel's, then the conv in fp32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, d, hp, wp8, ci, co = K6C_CARD[case]
    w_out = wp8 - 8
    use_pre, want_stats = K6C_FORMS[form]
    x, wt, bias = [_t(a, torch.bfloat16).to(cuda_device) for a in (
        _offset((b, d), hp, wp8, w_out, c=ci),
        *_weights(3, c_in=ci, c_out=co))]
    pre = None
    if use_pre:
        sa, ta = _pre(b, c=ci)
        pre = (_t(sa, torch.bfloat16).to(cuda_device),
               _t(ta, torch.bfloat16).to(cuda_device), SLOPE)
    before = pconv.pconv3_valid.fused_launches
    got = pconv.pconv3_valid(x, wt, bias, w_out=w_out, pre=pre,
                             want_stats=want_stats)
    torch.cuda.synchronize()
    assert pconv.pconv3_valid.fused_launches == before + 1
    xt = x[..., :w_out + 1, :]
    if use_pre:
        xt = pconv.pre_plain(xt, *pre)
    want = pconv.pconv3_valid_plain(xt.float(), wt.float(), bias.float(),
                                    w_out, want_stats=want_stats)
    y, ry = (got[0], want[0]) if want_stats else (got, want)
    assert y.shape == (b, d, hp - 1, w_out, co) and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), ry, rtol=0.04, atol=0.04)
    if want_stats:
        check_stats(got[1].cpu().numpy(), want[1].cpu().numpy(), ry.cpu(),
                    "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("slope", [1.5, -0.25])
def test_k6c_hopper_slope_outside_unit_interval(cuda_device, slope,
                                                monkeypatch):
    """A leaky slope outside [0, 1] takes the kernel's select-by-sign form
    of the pre transform (inside it leaky is one max): against the plain
    version."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, d, hp, wp8, ci, co = K6C_CARD["d4_ci256"]
    w_out = wp8 - 8
    x, wt, bias = [_t(a, torch.bfloat16).to(cuda_device) for a in (
        _offset((b, d), hp, wp8, w_out, c=ci),
        *_weights(3, c_in=ci, c_out=co))]
    sa, ta = _pre(b, c=ci)
    pre = (_t(sa, torch.bfloat16).to(cuda_device),
           _t(ta, torch.bfloat16).to(cuda_device), slope)
    y = pconv.pconv3_valid(x, wt, bias, w_out=w_out, pre=pre)
    torch.cuda.synchronize()
    xt = pconv.pre_plain(x[..., :w_out + 1, :], *pre)
    want = pconv.pconv3_valid_plain(xt.float(), wt.float(), bias.float(),
                                    w_out)
    torch.testing.assert_close(y.float(), want, rtol=0.04, atol=0.04)


# K6b (n, hp, wp8, Ci, Co), w_out = wp8 - 8, on the weights-resident kernel
# (Ci = 128) and the streamed one (Ci = 256): hp - 1 and w_out no multiple
# of a tile; w_out = 8 with Co = 384 on an image smaller than a tile; Co =
# 256; 40 images of 20 tiles, so that every block goes round its ring
# several times and, in the timed variant without the overlapped store
# (mode 1), blocks with an odd tile count compute a tile past the last.
K6B_CARD = {"odd": (2, 14, 32, C, C),
            "w_out8_co384": (1, 10, 16, C, 3 * C),
            "co256": (3, 9, 40, C, 2 * C),
            "ci256": (3, 9, 40, 2 * C, C),
            "ci256_co256": (2, 19, 40, 2 * C, 2 * C),
            "ring_rounds": (40, 34, 72, C, C)}
# (measure, mode, stages, log2 tile width): mode 0 the streamed kernel, 1
# resident in step (a tile past the last where a block's count is odd), 2
# resident with the overlapped store, at 2-5 stages and each tile width
K6B_VARIANTS = {"streamed": (0, 0, 3, -1), "in_step": (0, 1, 3, -1),
                "in_step_w32": (0, 1, 4, 5), "stages2": (0, 2, 2, -1),
                "stages5_w8": (0, 2, 5, 3)}


def _k6b_card(shape, dev, use_pre=True, slope=SLOPE, seed=0):
    """bf16 card tensors of one K6b check: x, w, b and pre (None without
    use_pre), then the reference: pre in bf16, as the kernel's, then the
    plain conv in fp32."""
    n, hp, wp8, ci, co = shape
    w_out = wp8 - 8
    x, w, b = [_t(a, torch.bfloat16).to(dev) for a in (
        _offset((n,), hp, wp8, w_out, seed=seed, c=ci),
        *_weights(1, c_in=ci, c_out=co))]
    pre = None
    if use_pre:
        sa, ta = _pre(n, c=ci)
        pre = (_t(sa, torch.bfloat16).to(dev),
               _t(ta, torch.bfloat16).to(dev), slope)

    def ref(want_stats):
        xt = x[..., :w_out + 1, :]
        if use_pre:
            xt = pconv.pre_plain(xt, *pre)
        return pconv.pconv_valid_plain(xt.float(), w.float(), b.float(),
                                       w_out, want_stats=want_stats)
    return x, w, b, pre, w_out, ref


def _check_k6b(got, want, want_stats, shape):
    y, ry = (got[0], want[0]) if want_stats else (got, want)
    n, hp, _, _, co = shape
    assert y.shape == (n, hp - 1, shape[2] - 8, co)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), ry, rtol=0.04, atol=0.04)
    if want_stats:
        check_stats(got[1].cpu().numpy(), want[1].cpu().numpy(), ry.cpu(),
                    "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(K6C_FORMS))
@pytest.mark.parametrize("case", list(K6B_CARD))
def test_k6b_hopper_matches_plain(cuda_device, case, form, monkeypatch):
    """bf16 K6b on the wgmma / TMA kernels with pre, want_stats or both
    (scale and shift differ per channel and per image, the input's rim is
    nonzero, its pad columns hold 1e3) against the plain version."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    use_pre, want_stats = K6C_FORMS[form]
    x, w, b, pre, w_out, ref = _k6b_card(K6B_CARD[case], cuda_device,
                                         use_pre)
    before = pconv.pconv_valid.fused_launches
    got = pconv.pconv_valid(x, w, b, w_out=w_out, pre=pre,
                            want_stats=want_stats)
    torch.cuda.synchronize()
    assert pconv.pconv_valid.fused_launches == before + 1
    _check_k6b(got, ref(want_stats), want_stats, K6B_CARD[case])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(K6B_VARIANTS))
def test_k6b_hopper_variants_match_plain(cuda_device, variant, monkeypatch):
    """Each timed variant of bf16 K6b (pre and stats) at the shape with the
    most tiles, mode 1's tile past the last included: it must neither
    store nor add to the statistics."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    shape = K6B_CARD["ring_rounds"]
    x, w, b, pre, w_out, ref = _k6b_card(shape, cuda_device)
    got = pconv._launch_valid(pconv.pconv_valid, x, w, b, w_out, pre=pre,
                              want_stats=True,
                              variant=K6B_VARIANTS[variant])
    torch.cuda.synchronize()
    _check_k6b(got, ref(True), True, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [C, 2 * C], ids=["resident", "streamed"])
@pytest.mark.parametrize("slope", [1.5, -0.25])
def test_k6b_hopper_slope_outside_unit_interval(cuda_device, slope, ci,
                                                monkeypatch):
    """A leaky slope outside [0, 1] takes the select-by-sign form of the
    pre transform: against the plain version."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    shape = (3, 9, 40, ci, C)
    x, w, b, pre, w_out, ref = _k6b_card(shape, cuda_device, slope=slope)
    got = pconv.pconv_valid(x, w, b, w_out=w_out, pre=pre, want_stats=True)
    torch.cuda.synchronize()
    _check_k6b(got, ref(True), True, shape)


def test_profile_classes_tell_the_k6_forms_from_the_plain_kernels():
    """The profiler's kernel classes: a deferred-norm form's name holds its
    plain form's (K6bValid2 holds Valid2), so the K6 forms match first."""
    from rehrseg_tpu_torch.profile_serve import _classify
    want = {
        "void conv_resident_kernel<K6bValid2<3>>(...)": "k6b_pconv_valid_fused",
        "void conv_wgmma_kernel<K6bValid2<1>, 1, 3>(...)":
            "k6b_pconv_valid_fused",
        "void conv_resident_kernel<Valid2>(...)": "k3_pconv_valid",
        "void conv_wgmma_kernel<K6cValid3<3>, 1, 3>(...)":
            "k6c_pconv3_valid_fused",
        "void conv_wgmma_kernel<Valid3, 1, 3>(...)": "k5_pconv3_valid",
        "void conv_wgmma_kernel<K6aPad11Cat<6>, 1, 3>(...)":
            "k6a_pconv_pad11_cat_stats",
        "void conv_wgmma_kernel<Pad11Cat, 1, 3>(...)": "k1_pconv_pad11_cat",
        "void conv_resident_kernel<Pad11>(...)": "k4_pconv_pad11",
        "void conv_wgmma_kernel<K6bValid2F32<3>, 1, 2>(...)":
            "k6b_pconv_valid_fused",
    }
    assert {name: _classify(name) for name in want} == want


def test_launchers_make_the_tensor_device_current(monkeypatch):
    """The conv launchers run with their first tensor's device current (the
    build at first use, the allocations and the launch go there), whatever
    device the caller has current."""
    import contextlib
    seen = []

    @contextlib.contextmanager
    def device(dev):
        seen.append(("enter", dev))
        yield
        seen.append(("exit", dev))

    monkeypatch.setattr(torch.cuda, "device", device)
    x = torch.zeros(1)
    launch = pconv._on_device(
        lambda counter, t, k=0: (seen.append(("launch", counter, k)), t)[1])
    assert launch("counter", x, k=3) is x
    assert seen == [("enter", x.device), ("launch", "counter", 3),
                    ("exit", x.device)]
    for fn in (pconv._launch_pad11, pconv._launch_valid):
        assert fn.__wrapped__.__name__ == fn.__name__
