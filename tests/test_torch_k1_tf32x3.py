"""fp32 K1 (pconv_pad11_cat), K4 (pconv_pad11) and K6a (want_stats) by
3xTF32, the arithmetic of their Hopper kernel: each fp32 operand split into
two TF32 values (``split_tf32``), three TF32 products summed small terms
first. On the CPU: the split against numpy's bit operations, the weights'
layout (``tf32x3_weights``), and the kernel's arithmetic emulated in fp64
through the plain versions, against the JAX Pallas kernels in interpret
mode at fp32. On a machine with a card, the kernel against its plain
version at 2e-5.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops import pconv

torch.set_num_threads(2)

C = 128     # the smallest covered packed channel count
TOL = 2e-5  # fp32 against fp32, as the kernel is held on the card


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pallas_pconv
    return jnp, pallas_pconv


def _np_round_tf32(a):
    """Round to nearest TF32, ties away from zero, on the bits."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _floats(seed, n=4096):
    """fp32 values over many binades, both signs."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 2.0 ** rng.integers(-60, 60, size=n)
            ).astype(np.float32)


# ------------------------------------------------------------ the split

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_matches_numpy_bits(seed):
    x = _floats(seed)
    hi, lo = pconv.split_tf32(torch.from_numpy(x))
    want_hi = _np_round_tf32(x)
    want_lo = _np_round_tf32(x - want_hi)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  want_lo.view(np.uint32))
    for part in (hi, lo):   # TF32: 10 mantissa bits, the low 13 clear
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_sums_back_within_2_pow_21(seed):
    x = torch.from_numpy(_floats(seed))
    hi, lo = pconv.split_tf32(x)
    x = x.double()
    assert bool(((hi.double() + lo.double() - x).abs()
                 <= 2.0 ** -21 * x.abs()).all())
    # hi alone is TF32's three decimal digits, not fp32's
    assert bool(((hi.double() - x).abs() <= 2.0 ** -11 * x.abs()).all())


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["pos", "neg"])
def test_ties_round_away_from_zero(sign):
    """Low 13 bits 0x1000 (a tie) round the magnitude up; 0x0fff down;
    0x1001 up. The sign never changes the magnitude's rounding."""
    base = np.array([1.0, 3.5, 1e-3, 6e4], np.float32).view(np.uint32)
    for low, up in ((0x1000, True), (0x0FFF, False), (0x1001, True)):
        x = ((base & np.uint32(0xFFFFE000)) | np.uint32(low)).view(
            np.float32) * np.float32(sign)
        hi = pconv.round_tf32(torch.from_numpy(x)).numpy()
        mag = np.abs(x).view(np.uint32) & np.uint32(0xFFFFE000)
        want = (mag + np.uint32(0x2000 if up else 0)).view(np.float32)
        np.testing.assert_array_equal(np.abs(hi), want)
        assert (np.sign(hi) == sign).all()


def test_zero_subnormal_and_sign_cases():
    x = np.array([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 2.0 ** -126,
                  -(2.0 ** -126), 3e38, -3e38], np.float32)
    hi, lo = pconv.split_tf32(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    # zeros keep their sign, with a zero low part
    assert hi[0] == 0 and not np.signbit(hi[0]) and lo[0] == 0
    assert hi[1] == 0 and np.signbit(hi[1]) and lo[1] == 0
    # subnormals round on the same bits (TF32 keeps fewer of their digits)
    np.testing.assert_array_equal(hi.view(np.uint32),
                                  _np_round_tf32(x).view(np.uint32))
    np.testing.assert_array_equal(
        lo.view(np.uint32), _np_round_tf32(x - _np_round_tf32(x)).view(
            np.uint32))
    # the split is odd: split(-x) = -split(x)
    nhi, nlo = pconv.split_tf32(torch.from_numpy(-x))
    np.testing.assert_array_equal(nhi.numpy(), -hi)
    np.testing.assert_array_equal(nlo.numpy(), -lo)
    assert np.isfinite(hi).all() and np.isfinite(lo).all()


@pytest.mark.parametrize("ci,co", [(C, C), (2 * C, 3 * C)])
def test_weights_layout(ci, co):
    """tf32x3_weights: (2, Co, 4 Ci), W_hi then W_lo K-major (k = tap * Ci
    + c), each 32-channel chunk in the kernel's fragment order: channel 8 a
    + 4 b + kk at position 8 kk + 4 b + a."""
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.normal(size=(2, 2, ci, co)), dtype=torch.float32)
    ws = pconv.tf32x3_weights(w)
    assert ws.shape == (2, co, 4 * ci) and ws.is_contiguous()
    k = np.arange(4 * ci)
    chunk, p = k // 32, k % 32
    kk, b, a = p // 8, (p // 4) % 2, p % 4
    chan = chunk * 32 + 8 * a + 4 * b + kk       # column k holds this channel
    assert sorted(chan) == list(range(4 * ci))
    wk = w.reshape(4 * ci, co).t()              # (Co, taps * Ci)
    hi, lo = pconv.split_tf32(wk.contiguous())
    np.testing.assert_array_equal(ws[0].numpy(), hi[:, chan].numpy())
    np.testing.assert_array_equal(ws[1].numpy(), lo[:, chan].numpy())


# ------------------------------------------------------------ the arithmetic

def _tf32x3(plain, xs, w, b):
    """The kernel's products, emulated in fp64 through a plain version: A
    and W split, then A_hi * W_lo + A_lo * W_hi, then + A_hi * W_hi and the
    bias. ``plain(xs, w, b)`` takes a list of inputs."""
    parts = [pconv.split_tf32(x) for x in xs]
    x_hi = [p[0].double() for p in parts]
    x_lo = [p[1].double() for p in parts]
    w_hi, w_lo = (t.double() for t in pconv.split_tf32(w))
    zero = torch.zeros_like(b, dtype=torch.float64)
    small = plain(x_hi, w_lo, zero) + plain(x_lo, w_hi, zero)
    return small + plain(x_hi, w_hi, b.double())


def _k1_plain(xs, w, b):
    return pconv.pconv_pad11_cat_plain(xs[0], xs[1], w, b)


def _k4_plain(xs, w, b):
    return pconv.pconv_pad11_plain(xs[0], w, b)


def _operands(shape, seed=0):
    """(n, h, w, ca, cb, co) -> xa, xb (cb > 0), w, b as numpy fp32, the
    weights scaled as a conv's init."""
    n, h, w, ca, cb, co = shape
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(n, h, w, ca)).astype(np.float32)
    xb = rng.normal(size=(n, h, w, cb)).astype(np.float32) if cb else None
    wt = (rng.normal(size=(2, 2, ca + cb, co)) / np.sqrt(4 * (ca + cb))
          ).astype(np.float32)
    b = (0.1 * rng.normal(size=co)).astype(np.float32)
    return xa, xb, wt, b


# (n, h, w, ca, cb, co): the served shape's widths on a small image, w = 8
# on a height no multiple of 4, Ca != Cb with Co = 256 (heights the TPU
# kernel's block choice takes)
K1_SHAPES = {"c128": (2, 8, 16, C, C, C), "w8": (1, 10, 8, C, C, C),
             "ca_ne_cb": (1, 6, 8, C, 2 * C, 2 * C)}


@pytest.mark.parametrize("case", sorted(K1_SHAPES))
def test_k1_tf32x3_matches_pallas(case):
    jnp, pp = _jax()
    xa, xb, w, b = _operands(K1_SHAPES[case])
    want = np.asarray(pp.pconv_pad11_cat(
        *(jnp.asarray(a) for a in (xa, xb, w, b)), interpret=True))
    got = _tf32x3(_k1_plain, [torch.from_numpy(xa), torch.from_numpy(xb)],
                  torch.from_numpy(w), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.all(got[:, :, xa.shape[2] + 1:] == 0)


@pytest.mark.parametrize("ci", [C, 2 * C])
def test_k4_tf32x3_matches_pallas(ci):
    """K4 is the kernel with Cb = 0: every K step reads xa."""
    jnp, pp = _jax()
    x, _, w, b = _operands((2, 8, 16, ci, 0, C), seed=1)
    want = np.asarray(pp.pconv_pad11(*(jnp.asarray(a) for a in (x, w, b)),
                                     interpret=True))
    got = _tf32x3(_k4_plain, [torch.from_numpy(x)], torch.from_numpy(w),
                  torch.from_numpy(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _exact(plain, xs, w, b):
    """K6a's products (those of the forms with moment sums, as
    tests/test_torch_valid_tf32x3.py emulates them), through a plain
    version: A_hi * W_hi + A_lo * W_hi + A * W_lo + bf16 A * W's third
    part, then the bias."""
    from test_torch_valid_tf32x3 import _exact_parts, _grid_split
    parts = [[t.double() for t in _grid_split(x)] for x in xs]
    w_hi, w_lo, w_3 = _exact_parts(w)
    zero = torch.zeros_like(b, dtype=torch.float64)
    x_hi, x_lo, x_32, x_bf = ([p[i] for p in parts] for i in range(4))
    return (plain(x_hi, w_hi, zero) + plain(x_lo, w_hi, zero)
            + plain(x_32, w_lo, zero) + plain(x_bf, w_3, b.double()))


def test_k6a_tf32x3_matches_pallas():
    """K6a: the products of the forms with moment sums, the full offset
    rim mask, and the moment half-sums of the stored value."""
    jnp, pp = _jax()
    xa, xb, w, b = _operands((2, 8, 16, C, C, C), seed=2)
    want_y, want_stats = pp.pconv_pad11_cat(
        *(jnp.asarray(a) for a in (xa, xb, w, b)), interpret=True,
        want_stats=True)
    y = _exact(_k1_plain, [torch.from_numpy(xa), torch.from_numpy(xb)],
               torch.from_numpy(w), torch.from_numpy(b))
    hp, wp8, co = y.shape[1:]
    y = y * pconv.offset_rim_mask(hp, wp8, co // 4, y.dtype, y.device,
                                  true_w=xa.shape[2] + 1)
    stats = pconv.stats16_plain(y.float())
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
    want_stats = np.asarray(want_stats)
    for rows in (slice(0, 8), slice(8, 16)):
        np.testing.assert_allclose(stats[:, rows].sum(1).numpy(),
                                   want_stats[:, rows].sum(1), rtol=1e-4,
                                   atol=TOL * np.sqrt(hp * wp8))


def test_tf32x3_is_fp32_accurate_where_one_pass_is_not():
    """The three products keep fp32's digits (the dropped lo * lo term is
    below 2^-22 of each product); one TF32 pass does not meet 2e-5."""
    xa, xb, w, b = _operands((1, 8, 16, C, C, C), seed=4)
    xs = [torch.from_numpy(xa), torch.from_numpy(xb)]
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    exact = _k1_plain([x.double() for x in xs], wt.double(), bt.double())
    three = _tf32x3(_k1_plain, xs, wt, bt)
    one = _k1_plain([pconv.round_tf32(x).double() for x in xs],
                    pconv.round_tf32(wt).double(), bt.double())
    assert float((three - exact).abs().max()) < 1e-6
    assert float((one - exact).abs().max()) > 10 * TOL


def _rz32(a):
    """fp64 -> fp32 rounded toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _rz_accumulate(xh, xl, wh, wl, flush):
    """The kernel's accumulation modelled as the tensor cores do it: each
    wgmma adds its 8 exact products to the fp32 accumulator and truncates
    (round toward zero); the small terms first, then hi * hi. With
    ``flush``, the accumulator is added to fp32 sums (rounded to nearest)
    every ``flush`` slices of 8, and starts again at zero."""
    acc = np.zeros(xh.shape[0], np.float32)
    sums = np.zeros(xh.shape[0], np.float32)
    for k0 in range(0, xh.shape[1], 8):
        sl = slice(k0, k0 + 8)
        for a, b in ((xh, wl), (xl, wh), (xh, wh)):
            acc = _rz32(acc + (a[:, sl].astype(np.float64) * b[:, sl]).sum(1))
        if flush and (k0 // 8 + 1) % flush == 0:
            sums, acc = sums + acc, np.zeros_like(acc)
    return sums + acc


def test_truncating_accumulation_needs_the_flush():
    """Why the kernel flushes its accumulators into fp32 sums every K step
    (64 k, 8 slices of 8): summed over K = 1024 in one truncating fp32
    accumulator, 3xTF32 loses more than the 2e-5 the kernel is held to;
    flushed every K step, it keeps to a fraction of it."""
    rng = np.random.default_rng(5)
    k = 1024
    x = rng.normal(size=(4000, k)).astype(np.float32)
    w = (rng.normal(size=(4000, k)) / np.sqrt(k)).astype(np.float32)
    xh, xl = (t.numpy() for t in pconv.split_tf32(torch.from_numpy(x)))
    wh, wl = (t.numpy() for t in pconv.split_tf32(torch.from_numpy(w)))
    exact = (x.astype(np.float64) * w).sum(1)
    once = np.abs(_rz_accumulate(xh, xl, wh, wl, 0) - exact)
    flushed = np.abs(_rz_accumulate(xh, xl, wh, wl, 8) - exact)
    assert once.max() > TOL
    assert flushed.max() < TOL / 4


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


# (n, h, w, ca, cb, co): the ragged edges of the tiling, Ca != Cb, Co = 384,
# an image smaller than a tile, enough tiles for several rounds of the ring
CARD_SHAPES = ((2, 13, 24, C, C, C), (3, 7, 24, C, 2 * C, 3 * C),
               (1, 3, 8, 2 * C, C, C), (40, 33, 64, C, C, C))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_k1_kernel_matches_plain(cuda_device, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    xa, xb, w, b = _on(cuda_device, *_operands(shape))
    before = pconv.pconv_pad11_cat.launches
    y = pconv.pconv_pad11_cat(xa, xb, w, b)
    torch.cuda.synchronize()
    assert pconv.pconv_pad11_cat.launches == before + 1
    want = pconv.pconv_pad11_cat_plain(xa, xb, w, b)
    torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)
    assert torch.all(y[:, :, shape[2] + 1:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 13, 24, C, 0, C),
                                   (3, 3, 8, 2 * C, 0, 3 * C)])
def test_k4_kernel_matches_plain(cuda_device, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, _, w, b = _on(cuda_device, *_operands(shape, seed=1))
    y = pconv.pconv_pad11(x, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, pconv.pconv_pad11_plain(x, w, b),
                               rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_k6a_kernel_matches_plain(cuda_device, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    xa, xb, w, b = _on(cuda_device, *_operands(shape, seed=2))
    y, stats = pconv.pconv_pad11_cat(xa, xb, w, b, want_stats=True)
    torch.cuda.synchronize()
    want_y, want_stats = pconv.pconv_pad11_cat_plain(xa, xb, w, b, True)
    torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
    npix = want_y.shape[1] * want_y.shape[2]
    for rows in (slice(0, 8), slice(8, 16)):
        torch.testing.assert_close(stats[:, rows].sum(1),
                                   want_stats[:, rows].sum(1), rtol=1e-4,
                                   atol=TOL * npix ** 0.5)
