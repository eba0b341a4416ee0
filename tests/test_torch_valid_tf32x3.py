"""fp32 K3 (pconv_valid), K5 (pconv3_valid), their deferred-norm forms K6b
and K6c, and K7 (conv2x2_valid_bias) by 3xTF32, the arithmetic of their
Hopper kernels (``csrc/pconv2d_sm90.cu``, ``csrc/pconv3_valid_sm90.cu``):
each fp32 operand split into two TF32 values, three TF32 products summed
small terms first, and for K6b / K6c the ``pre`` transform applied to the
input in registers before the split; the forms with moment sums make
their large product exact and their weights whole (grid-rounded high
parts, a third, bf16, part of the weights: ``tf32x3_exact_weights``). On the CPU: the weights' layouts
(``tf32x3_weights`` for kd = 3, ``tf32x3_exact_weights``), the
transform's roundings against ``pre_plain``, the kernels' arithmetic
emulated in fp64 through the plain versions against the JAX Pallas kernels
in interpret mode at fp32, and the truncating accumulation modelled at K5's
depth and, on mostly positive inputs, over an image's sum. On a machine
with a card, each kernel against its plain version at 2e-5.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops import pconv
from rehrseg_tpu_torch.ops.conv2x2 import (conv2x2_valid_bias,
                                           conv2x2_valid_bias_plain)

torch.set_num_threads(2)

C = 128     # the smallest covered packed channel count
TOL = 2e-5  # fp32 against fp32, as the kernels are held on the card
STATS_RTOL = 1e-4
SLOPE = 0.01


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pallas_conv, pallas_pconv
    return jnp, pallas_pconv, pallas_conv


def _rng(seed):
    return np.random.default_rng(seed)


def _offset(lead, hp, wp8, w_out, seed=0, c=C):
    """A raw offset input stored wp8 wide: garbage in the pad columns (>
    w_out), which the kernels never read."""
    x = _rng(seed).normal(size=(*lead, hp, wp8, c)).astype(np.float32)
    x[..., w_out + 1:, :] = 1e3
    return x


def _weights(kd, seed=1, c_in=C, c_out=C):
    shape = (2, 2, c_in, c_out) if kd == 1 else (3, 2, 2, c_in, c_out)
    w = _rng(seed).normal(size=shape) / np.sqrt(4 * kd * c_in)
    b = 0.1 * _rng(seed + 1).normal(size=(c_out,))
    return w.astype(np.float32), b.astype(np.float32)


def _pre(n, seed=5, c=C):
    """Scale and shift (n, 8, c), 8 equal rows, every channel its own."""
    sa = np.abs(_rng(seed).normal(size=(n, 1, c))) + 0.5
    ta = 0.5 * _rng(seed + 1).normal(size=(n, 1, c))
    return (np.repeat(sa, 8, 1).astype(np.float32),
            np.repeat(ta, 8, 1).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("ci,co", [(C, C), (2 * C, 3 * C)])
def test_weights_layout_kd3(ci, co):
    """tf32x3_weights of (3, 2, 2, Ci, Co): (2, Co, 12 Ci), column k of
    tap (u * 2 + s) * 2 + t (Valid3's w_row) and channel c, each 32-channel
    chunk in the kernel's fragment order (channel 8 a + 4 b + kk at
    position 8 kk + 4 b + a)."""
    w = torch.tensor(_rng(3).normal(size=(3, 2, 2, ci, co)),
                     dtype=torch.float32)
    ws = pconv.tf32x3_weights(w)
    assert ws.shape == (2, co, 12 * ci) and ws.is_contiguous()
    hi, lo = pconv.split_tf32(w)
    for u, s, t in ((0, 0, 0), (1, 0, 1), (2, 1, 0), (2, 1, 1)):
        tap = (u * 2 + s) * 2 + t
        for c in (0, 1, 8, 13, 31, 32, 8 * 3 + 4 + 2, ci - 1):
            chunk, r = divmod(c, 32)
            a, b, kk = r // 8, (r // 4) % 2, r % 4
            k = tap * ci + chunk * 32 + 8 * kk + 4 * b + a
            np.testing.assert_array_equal(ws[0, :, k].numpy(),
                                          hi[u, s, t, c].numpy())
            np.testing.assert_array_equal(ws[1, :, k].numpy(),
                                          lo[u, s, t, c].numpy())


def test_weights_layout_kd1_unchanged():
    """For (2, 2, Ci, Co) the general layout is K1's: the kd = 3 weights'
    middle z tap laid out alone gives the columns of taps 4..7."""
    w3 = torch.tensor(_rng(4).normal(size=(3, 2, 2, C, C)),
                      dtype=torch.float32)
    np.testing.assert_array_equal(
        pconv.tf32x3_weights(w3)[:, :, 4 * C:8 * C].numpy(),
        pconv.tf32x3_weights(w3[1].contiguous()).numpy())


@pytest.mark.parametrize("kd", [1, 3])
def test_exact_weights_parts(kd):
    """tf32x3_exact_weights: W_hi on the grid of its column's 32-channel
    chunk, rounded to nearest even, at most 2^9 steps of 2^-8 of the power
    of two of the chunk's largest magnitude; W_lo the rest rounded to TF32
    to nearest even; the bf16 third part what is left. The three add up to
    w exactly for weights within 2^-4 of their chunk's largest, the rest
    within 2^-30 of it."""
    shape = (2, 2, C, 2 * C) if kd == 1 else (3, 2, 2, C, C)
    w = torch.tensor(_rng(17).normal(size=shape)
                     * np.exp(2 * _rng(18).normal(size=shape)),
                     dtype=torch.float32)
    ws, w3 = pconv.tf32x3_exact_weights(w)
    k = 4 * kd * C
    assert ws.shape == (2, shape[-1], k) and ws.dtype == torch.float32
    assert w3.shape == (k, shape[-1]) and w3.dtype == torch.bfloat16
    hi, lo, third = _exact_parts(w)
    wn = w.double().numpy().reshape(-1, C // 32, 32, shape[-1])
    top = np.abs(wn).max(2, keepdims=True)
    step = np.exp2(np.floor(np.log2(top)) - 8)
    steps = hi.numpy().reshape(wn.shape) / step
    np.testing.assert_array_equal(steps, np.round(wn / step))
    assert np.abs(steps).max() <= 2 ** 9
    rest = (w.double() - hi).numpy()
    ulp = np.exp2(np.floor(np.log2(np.abs(rest) + 1e-300)) - 10)
    np.testing.assert_array_equal(lo.numpy(), np.round(rest / ulp) * ulp)
    err = np.abs((hi + lo + third - w.double()).numpy()).reshape(wn.shape)
    assert err.max() <= 2.0 ** -30 * top.max()
    assert np.all(err[np.abs(wn) >= top * 2.0 ** -4] == 0)


# ------------------------------------------------------------ the transform

def _pre_f32(x, s, t, slope, keep):
    """The kernel's PreF32 in numpy fp32: a rounding after the multiply,
    the add and the leaky product, then the rim mask as a select."""
    v = (x * s).astype(np.float32) + t
    v = np.where(v >= 0, v, (v * np.float32(slope)).astype(np.float32))
    return np.where(keep, v, np.float32(0)).astype(np.float32)


@pytest.mark.parametrize("slope", [SLOPE, 1.5, -0.25])
def test_pre_roundings_match_pre_plain(slope):
    """pre_plain at fp32 is the kernel's transform bit for bit: two
    roundings before the leaky product (never one fused multiply-add), the
    rim mask zeroing what lies outside the image."""
    hp, tw = 6, 9
    x = _rng(6).normal(size=(2, hp, tw, C)).astype(np.float32) * 3
    sa, ta = _pre(2, seed=7)
    got = pconv.pre_plain(*_t(x, sa, ta), slope).numpy()
    mask = pconv.offset_rim_mask(hp, tw, C // 4, torch.bool).numpy()
    want = _pre_f32(x, sa[:, :1, None], ta[:, :1, None], slope, mask)
    np.testing.assert_array_equal(got, want)   # zeros of either sign
    fused = x.astype(np.float64) * sa[:, :1, None] + ta[:, :1, None]
    assert np.any(fused.astype(np.float32) != (x * sa[:, :1, None]
                                               + ta[:, :1, None]))


# ------------------------------------------------------------ the arithmetic

def _tf32x3(plain, x, w, b):
    """The kernels' products, emulated in fp64 through a plain version
    ``plain(x, w, b)``: x and w split, then x_hi * w_lo + x_lo * w_hi, then
    + x_hi * w_hi and the bias."""
    x_hi, x_lo = (t.double() for t in pconv.split_tf32(x))
    w_hi, w_lo = (t.double() for t in pconv.split_tf32(w))
    zero = torch.zeros_like(b, dtype=torch.float64)
    small = plain(x_hi, w_lo, zero) + plain(x_lo, w_hi, zero)
    return small + plain(x_hi, w_hi, b.double())


def _check_stats(got_y, want_stats):
    """The moment half-sums of the emulated output as stored (fp32) against
    the Pallas kernel's."""
    stats = pconv.stats16_plain(got_y.float()).numpy()
    want = np.asarray(want_stats)
    npix = np.prod(got_y.shape[-3:-1])
    for rows, atol in ((slice(0, 8), TOL * np.sqrt(npix)),
                       (slice(8, 16), TOL)):
        np.testing.assert_allclose(stats[:, rows].sum(1),
                                   want[:, rows].sum(1), rtol=STATS_RTOL,
                                   atol=atol)


def _grid_split(x):
    """The split of the forms with stats (tf32x3_exact_step), in fp32: per
    pixel and 32-channel chunk, A_hi is x rounded to 2^-9 of the power of
    two of the chunk's largest magnitude by adding and taking away 1.5 x
    2^23 of those steps, A_lo the rest rounded to TF32; and x itself in
    TF32 and in bf16."""
    g = x.reshape(*x.shape[:-1], x.shape[-1] // 32, 32)
    top = g.abs().amax(-1, keepdim=True).view(torch.int32) & 0x7f800000
    magic = ((top + (14 << 23)) | 0x400000).view(torch.float32)
    hi = ((g + magic) - magic).reshape(x.shape)
    return hi, pconv.round_tf32(x - hi), pconv.round_tf32(x), x.bfloat16()


def _exact_parts(w):
    """tf32x3_exact_weights' W_hi, W_lo and third part in w's own layout
    (taps..., Ci, Co), fp64."""
    ws, w3 = pconv.tf32x3_exact_weights(w)
    co = w.shape[-1]
    k = w.numel() // co
    base = torch.arange(0, k, 32)[:, None]
    # a chunk's channel at each position of the split (the A fragments'
    # order) and at each row of the third part (the bf16 fragments' k)
    tf32_order = [8 * a + 4 * b + kk for kk in range(4) for b in range(2)
                  for a in range(4)]
    bf16_order = [8 * q + 4 * t + 2 * h + j for t in range(2)
                  for h in range(2) for q in range(4) for j in range(2)]
    cols = (base + torch.tensor(tf32_order)).reshape(-1)
    rows = (base + torch.tensor(bf16_order)).reshape(-1)
    parts = torch.empty(3, co, k, dtype=torch.float64)
    parts[:2, :, cols] = ws.double()
    parts[2][:, rows] = w3.double().t()
    return [p.t().reshape(w.shape) for p in parts]


def _exact(plain, x, w, b):
    """The products of the forms with stats in fp64 through a plain
    version: A_hi * W_hi + A_lo * W_hi + A * W_lo + bf16 A * W's third
    part, then the bias."""
    x_hi, x_lo, x_32, x_bf = (t.double() for t in _grid_split(x))
    w_hi, w_lo, w_3 = _exact_parts(w)
    zero = torch.zeros_like(b, dtype=torch.float64)
    return (plain(x_hi, w_hi, zero) + plain(x_lo, w_hi, zero)
            + plain(x_32, w_lo, zero) + plain(x_bf, w_3, b.double()))


def _emulate_valid(kd, x, w, b, w_out, pre=None, stats=False):
    """K3 / K5 (K6b / K6c with ``pre``): the transform in fp32 on the true
    columns, as the kernels apply it before the split, then the products,
    the exact ones for a form with stats."""
    xs = x[..., :w_out + 1, :]
    if pre is not None:
        xs = pconv.pre_plain(xs, *pre, SLOPE)
    plain = pconv.pconv_valid_plain if kd == 1 else pconv.pconv3_valid_plain
    return (_exact if stats else _tf32x3)(
        lambda xx, ww, bb: plain(xx, ww, bb, w_out), xs, w, b)


# (n, hp, wp8, ci, co, w_out): the main path's Ci = Co on a small image,
# Ci = 256 with Co = 256 and w_out below the default
K3_SHAPES = {"c128": (2, 9, 32, C, C, 24), "ci256": (1, 9, 24, 2 * C, 2 * C,
                                                     8)}


@pytest.mark.parametrize("case", sorted(K3_SHAPES))
def test_k3_tf32x3_matches_pallas(case):
    jnp, pp, _ = _jax()
    n, hp, wp8, ci, co, w_out = K3_SHAPES[case]
    x = _offset((n,), hp, wp8, w_out, c=ci)
    w, b = _weights(1, c_in=ci, c_out=co)
    want = np.asarray(pp.pconv_valid(*(jnp.asarray(a) for a in (x, w, b)),
                                     w_out=w_out, interpret=True))
    got = _emulate_valid(1, *_t(x, w, b), w_out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [1, 3])
def test_k5_tf32x3_matches_pallas(d):
    """D = 1 runs only the middle z tap; D = 3 both z edges and the
    interior."""
    jnp, pp, _ = _jax()
    x = _offset((2, d), 9, 16, 8)
    w, b = _weights(3)
    want = np.asarray(pp.pconv3_valid(*(jnp.asarray(a) for a in (x, w, b)),
                                      w_out=8, interpret=True))
    got = _emulate_valid(3, *_t(x, w, b), 8)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_k6b_tf32x3_matches_pallas():
    """K6b: the transform in fp32, then the exact products; the moment
    half-sums of the stored output."""
    jnp, pp, _ = _jax()
    x = _offset((3,), 9, 32, 24)
    w, b = _weights(1)
    sa, ta = _pre(3)
    want_y, want_stats = pp.pconv_valid(
        *(jnp.asarray(a) for a in (x, w, b)), w_out=24, interpret=True,
        pre=(jnp.asarray(sa), jnp.asarray(ta), SLOPE), want_stats=True)
    got = _emulate_valid(1, *_t(x, w, b), 24, pre=_t(sa, ta), stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), rtol=TOL,
                               atol=TOL)
    _check_stats(got, want_stats)


@pytest.mark.parametrize("d", [1, 3])
def test_k6c_tf32x3_matches_pallas(d):
    """K6c: per-batch scale and shift, z taps outside [0, D) zero after the
    transform, stats per (b, z) image."""
    jnp, pp, _ = _jax()
    x = _offset((2, d), 9, 16, 8, seed=2)
    w, b = _weights(3, seed=3, c_out=2 * C)
    sa, ta = _pre(2, seed=8)
    want_y, want_stats = pp.pconv3_valid(
        *(jnp.asarray(a) for a in (x, w, b)), w_out=8, interpret=True,
        pre=(jnp.asarray(sa), jnp.asarray(ta), SLOPE), want_stats=True)
    got = _emulate_valid(3, *_t(x, w, b), 8, pre=_t(sa, ta), stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), rtol=TOL,
                               atol=TOL)
    _check_stats(got, want_stats)


def test_k7_tf32x3_matches_pallas():
    """K7: K3's products on an exact odd width."""
    jnp, _, pc = _jax()
    x = _rng(9).normal(size=(2, 9, 17, C)).astype(np.float32)
    w, b = _weights(1, seed=10)
    want = np.asarray(pc.conv2x2_valid_bias(
        *(jnp.asarray(a) for a in (x, w, b)), interpret=True))
    got = _tf32x3(conv2x2_valid_bias_plain, *_t(x, w, b))
    assert tuple(got.shape) == want.shape == (2, 8, 16, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _rz32(a):
    """fp64 -> fp32 rounded toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _rz_accumulate(xh, xl, wh, wl, flush):
    """The kernels' accumulation modelled as the tensor cores do it: each
    wgmma adds its 8 exact products to the fp32 accumulator and truncates
    (round toward zero), the small terms first, then hi * hi; every
    ``flush`` slices of 8 the accumulator is added to fp32 sums (rounded to
    nearest) and starts again at zero (0: never)."""
    acc = np.zeros(xh.shape[0], np.float32)
    sums = np.zeros(xh.shape[0], np.float32)
    for k0 in range(0, xh.shape[1], 8):
        sl = slice(k0, k0 + 8)
        for a, b in ((xh, wl), (xl, wh), (xh, wh)):
            acc = _rz32(acc + (a[:, sl].astype(np.float64) * b[:, sl]).sum(1))
        if flush and (k0 // 8 + 1) % flush == 0:
            sums, acc = sums + acc, np.zeros_like(acc)
    return sums + acc


def test_truncating_accumulation_at_k5_depth():
    """K5 at the path's shape is K = 12 * 256 = 3072 deep, three times
    K1's. Flushed every K step (64 k: 32 channels under both row taps,
    8 slices of 8) the truncation stays within half the 2e-5 the kernel is
    held to, with operands scaled as the path's (normal inputs, weights of
    a conv's init); one accumulator over all of K misses it by far."""
    rng = _rng(11)
    k = 3072
    x = rng.normal(size=(2000, k)).astype(np.float32)
    w = (rng.normal(size=(2000, k)) / np.sqrt(k)).astype(np.float32)
    xh, xl = (t.numpy() for t in pconv.split_tf32(torch.from_numpy(x)))
    wh, wl = (t.numpy() for t in pconv.split_tf32(torch.from_numpy(w)))
    exact = (x.astype(np.float64) * w).sum(1)
    once = np.abs(_rz_accumulate(xh, xl, wh, wl, 0) - exact)
    flushed = np.abs(_rz_accumulate(xh, xl, wh, wl, 8) - exact)
    assert once.max() > 2 * TOL
    assert flushed.max() < TOL / 2


def test_grid_split_rounds_to_nearest_even():
    """_grid_split's A_hi, made as the kernel makes it (adding and taking
    away 1.5 x 2^23 grid steps in fp32), is x rounded to nearest even on
    its chunk's grid of 2^-9 of the power of two of the largest magnitude:
    at most 2^10 steps, a TF32 value; A_lo is what is left in TF32, A_hi +
    A_lo within 2^-22 of the chunk's largest."""
    x = torch.tensor(_rng(19).normal(size=(64, 4 * 32))
                     * np.exp(3 * _rng(20).normal(size=(64, 4 * 32))),
                     dtype=torch.float32)
    x[0, :32] = 0.0                    # a chunk of zeros stays zero
    hi, lo, _, _ = _grid_split(x)
    g = x.double().numpy().reshape(64, 4, 32)
    top = np.abs(g).max(-1, keepdims=True)
    step = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1))) - 9)
    steps = hi.double().numpy().reshape(g.shape) / step
    np.testing.assert_array_equal(steps, np.round(g / step))
    assert np.abs(steps).max() <= 2 ** 10
    assert torch.equal(pconv.round_tf32(hi), hi)
    assert not hi[0, :32].any() and not lo[0, :32].any()
    err = np.abs((hi.double() + lo.double()).numpy().reshape(g.shape) - g)
    assert np.all(err <= 2.0 ** -22 * top)


def test_exact_hi_products_sum_exactly():
    """A row tap's 32 products A_hi * W_hi, both on their grids, sum to a
    value fp32 holds exactly, so the tensor cores' truncation has nothing to
    cut; the plain split's high parts do not, over 8."""
    a = _rng(21).normal(size=(256, 64)) * np.exp(_rng(22).normal(
        size=(256, 64)))
    a = torch.tensor(np.where(a > 0, a, SLOPE * a), dtype=torch.float32)
    w = torch.tensor(_rng(23).normal(size=(64, 32)) / 8, dtype=torch.float32)
    a_hi = _grid_split(a)[0].double().numpy()
    w_hi = _exact_parts(w)[0].numpy()
    p_hi = pconv.split_tf32(a)[0].double().numpy()
    q_hi = pconv.split_tf32(w)[0].double().numpy()
    for c0 in (0, 32):
        s = a_hi[:, c0:c0 + 32] @ w_hi[c0:c0 + 32]
        np.testing.assert_array_equal(s.astype(np.float32), s)
    s = p_hi[:, :8] @ q_hi[:8]
    assert np.any(s.astype(np.float32) != s)


def _rz_matmul(acc, a, b):
    """acc + a @ b, the products exact, truncated to fp32 (one wgmma)."""
    return _rz32(acc.astype(np.float64) + a.astype(np.float64) @ b)


def _model_plain(a, w):
    """The plain forms' arithmetic (K3, K5): 3xTF32, each wgmma
    truncating, the accumulator added to the sums every K step (8 slices)."""
    ah, al = (t.double().numpy() for t in pconv.split_tf32(a))
    wh, wl = (t.double().numpy() for t in pconv.split_tf32(w))
    acc = sums = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for i in range(a.shape[1] // 8):
        sl = slice(8 * i, 8 * i + 8)
        for x, y in ((ah, wl), (al, wh), (ah, wh)):
            acc = _rz_matmul(acc, x[:, sl], y[sl])
        if i % 8 == 7:
            sums, acc = sums + acc, np.zeros_like(acc)
    return sums


def _model_exact(a, w):
    """tf32x3_exact_step's arithmetic, a 32-channel row tap at a time:
    A_lo * W_hi, A * W_lo and the bf16 third part truncated into one
    accumulator, added to the sums, then the row tap's A_hi * W_hi, exact
    in the accumulator, added."""
    ah, al, a32, ab = (t.double().numpy() for t in _grid_split(a))
    wh, wl, w3 = (t.numpy() for t in _exact_parts(w))
    sums = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], 32):
        acc = np.zeros_like(sums)
        slices = [np.arange(c0 + kk, c0 + 32, 4) for kk in range(4)]
        for sl in slices:
            acc = _rz_matmul(acc, al[:, sl], wh[sl])
            acc = _rz_matmul(acc, a32[:, sl], wl[sl])
        for t in range(2):
            sl = [c0 + 8 * q + 4 * t + j for q in range(4) for j in range(4)]
            acc = _rz_matmul(acc, ab[:, sl], w3[sl])
        sums, acc = sums + acc, np.zeros_like(acc)
        for sl in slices:
            hh = acc + ah[:, sl] @ wh[sl]
            acc = _rz_matmul(acc, ah[:, sl], wh[sl])
            assert np.array_equal(acc, hh)
        sums = sums + acc
    return sums


@pytest.mark.parametrize("model", ["plain", "exact"])
def test_truncation_in_an_images_sums(model):
    """K6b's path shape: K = 512 over an image of 30,720 pixels, its inputs
    mostly positive (leaky(x * sa + ta)). Each output of the plain
    arithmetic stays well within 2e-5, but its truncation shortens a
    channel's outputs alike in every pixel, and the image's sum carries
    it past the absolute part of the sums' limit (2e-5 x sqrt(pixels), the
    spread of independent errors) several times; the exact arithmetic's
    sums stay within half of it."""
    npix, k = 30720, 512
    rng = _rng(24)
    v = (rng.normal(size=(npix, k)) * (np.abs(rng.normal(size=k)) + 0.5)
         + 0.5 * rng.normal(size=k))
    a = torch.tensor(np.where(v >= 0, v, SLOPE * v), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(k, 8)) / np.sqrt(k),
                     dtype=torch.float32)
    exact = a.double().numpy() @ w.double().numpy()
    y = (_model_plain if model == "plain" else _model_exact)(a, w)
    assert np.abs(y - exact).max() < TOL / 2
    sum_err = np.abs((y - exact).sum(0))
    limit = TOL * np.sqrt(npix)
    if model == "plain":
        assert sum_err.max() > 3 * limit
    else:
        assert sum_err.max() < limit / 2


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _close_stats(got, want, y):
    npix = y.shape[-3] * y.shape[-2]
    for rows, atol in ((slice(0, 8), TOL * npix ** 0.5), (slice(8, 16), TOL)):
        torch.testing.assert_close(got[:, rows].sum(1), want[:, rows].sum(1),
                                   rtol=STATS_RTOL, atol=atol)


# K3 / K6b (n, hp, wp8, ci, co, w_out): an odd height one and a half tiles
# wide, Co = 384 with a batch of one, Ci = 256 on an image smaller than a
# tile, w_out = 8 below the default, 40 images (several ring rounds a block)
K3_CARD = ((2, 14, 32, C, C, 24), (1, 10, 32, C, 3 * C, 24),
           (3, 4, 16, 2 * C, C, 8), (2, 11, 16, C, 2 * C, 8),
           (40, 34, 72, C, C, 64))
# K5 / K6c (b, d, hp, wp8, ci, co, w_out): D = 1, 2, 3 and 4, an odd hp,
# Ci = 256, Co = 384, several ring rounds a block
K5_CARD = ((2, 1, 14, 32, C, C, 24), (1, 2, 10, 32, C, 3 * C, 24),
           (2, 3, 5, 16, 2 * C, C, 8), (3, 4, 33, 72, 2 * C, 2 * C, 64))
FORMS = {"pre_stats": (True, True), "pre_only": (True, False),
         "stats_only": (False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_CARD)
def test_k3_kernel_matches_plain(cuda_device, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, hp, wp8, ci, co, w_out = shape
    x, w, b = _on(cuda_device, _offset((n,), hp, wp8, w_out, c=ci),
                  *_weights(1, c_in=ci, c_out=co))
    before = pconv.pconv_valid.launches
    y = pconv.pconv_valid(x, w, b, w_out=w_out)
    torch.cuda.synchronize()
    assert pconv.pconv_valid.launches == before + 1
    _close(y, pconv.pconv_valid_plain(x, w, b, w_out))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K5_CARD)
def test_k5_kernel_matches_plain(cuda_device, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    bsz, d, hp, wp8, ci, co, w_out = shape
    x, w, b = _on(cuda_device, _offset((bsz, d), hp, wp8, w_out, c=ci),
                  *_weights(3, c_in=ci, c_out=co))
    before = pconv.pconv3_valid.launches
    y = pconv.pconv3_valid(x, w, b, w_out=w_out)
    torch.cuda.synchronize()
    assert pconv.pconv3_valid.launches == before + 1
    _close(y, pconv.pconv3_valid_plain(x, w, b, w_out))


def _k6_card(kd, shape, dev, pre, want_stats):
    """The fp32 K6b / K6c call and its plain version's result (the same
    fp32 pre transform, then the plain conv)."""
    lead = shape[:kd // 3 + 1]
    hp, wp8, ci, co, w_out = shape[len(lead):]
    x, w, b = _on(dev, _offset(lead, hp, wp8, w_out, seed=3, c=ci),
                  *_weights(kd, seed=4, c_in=ci, c_out=co))
    sa, ta = _on(dev, *_pre(lead[0], seed=6, c=ci))
    p = (sa, ta, SLOPE) if pre else None
    fn = pconv.pconv_valid if kd == 1 else pconv.pconv3_valid
    plain = pconv.pconv_valid_plain if kd == 1 else pconv.pconv3_valid_plain
    before = fn.fused_launches
    got = fn(x, w, b, w_out=w_out, pre=p, want_stats=want_stats)
    torch.cuda.synchronize()
    assert fn.fused_launches == before + 1
    return got, plain(x, w, b, w_out, pre=p, want_stats=want_stats)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", K3_CARD)
def test_k6b_kernel_matches_plain(cuda_device, shape, form, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    pre, want_stats = FORMS[form]
    got, want = _k6_card(1, shape, cuda_device, pre, want_stats)
    if want_stats:
        _close(got[0], want[0])
        _close_stats(got[1], want[1], want[0])
    else:
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", K5_CARD)
def test_k6c_kernel_matches_plain(cuda_device, shape, form, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    pre, want_stats = FORMS[form]
    got, want = _k6_card(3, shape, cuda_device, pre, want_stats)
    if want_stats:
        _close(got[0], want[0])
        _close_stats(got[1], want[1], want[0])
    else:
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("slope", [1.5, -0.25])
def test_k6b_kernel_slope_outside_unit_interval(cuda_device, slope,
                                                monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, b = _on(cuda_device, _offset((3,), 9, 40, 32), *_weights(1))
    sa, ta = _on(cuda_device, *_pre(3))
    y, stats = pconv.pconv_valid(x, w, b, w_out=32, pre=(sa, ta, slope),
                                 want_stats=True)
    torch.cuda.synchronize()
    want_y, want_stats = pconv.pconv_valid_plain(x, w, b, 32,
                                                 pre=(sa, ta, slope),
                                                 want_stats=True)
    _close(y, want_y)
    _close_stats(stats, want_stats, want_y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 14, 25, C, C), (1, 6, 12, C, 2 * C),
                                   (3, 9, 17, 2 * C, C)])
def test_k7_kernel_matches_plain(cuda_device, shape, monkeypatch):
    """An exact odd width: the tensor map reads only the true columns."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, hp, wp, ci, co = shape
    x = _rng(12).normal(size=(n, hp, wp, ci)).astype(np.float32)
    x, w, b = _on(cuda_device, x, *_weights(1, seed=13, c_in=ci, c_out=co))
    before = conv2x2_valid_bias.launches
    y = conv2x2_valid_bias(x, w, b)
    torch.cuda.synchronize()
    assert conv2x2_valid_bias.launches == before + 1
    _close(y, conv2x2_valid_bias_plain(x, w, b))
