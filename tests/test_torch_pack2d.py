"""The port's packed layout ops (ops/pack2d.py) against the JAX package's,
on the same numpy inputs, fp32, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.ops import pack2d as jp
from rehrseg_tpu_torch.ops import pack2d as tp

torch.set_num_threads(2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", ["space_to_depth_hw", "offset_pack_hw"])
def test_layout_ops(name):
    x = _x((2, 3, 8, 12, 5))
    _close(getattr(tp, name)(torch.from_numpy(x)),
           getattr(jp, name)(jnp.asarray(x)), 0)


@pytest.mark.parametrize("name", ["depth_to_space_hw",
                                  "offset_to_unpacked_hw",
                                  "aligned_to_offset_hw"])
def test_inverse_layout_ops(name):
    x = _x((2, 3, 4, 6, 20))
    _close(getattr(tp, name)(torch.from_numpy(x)),
           getattr(jp, name)(jnp.asarray(x)), 0)


@pytest.mark.parametrize("kw", [
    dict(), dict(in_splits=[3, 5]), dict(packed_out=False),
    dict(packed_out=False, aligned_in_strided=True),
], ids=["packed", "splits", "strided", "strided_aligned"])
def test_pack_conv_weights(kw):
    w = _x((3, 3, 3, 8, 6))
    _close(tp.pack_conv_weights(torch.from_numpy(w), **kw),
           jp.pack_conv_weights(jnp.asarray(w), **kw), 0)


@pytest.mark.parametrize("name,shape", [
    ("pack_conv_weights", (1, 5, 5, 4, 3)),
    ("pack_conv_weights_cell4", (1, 5, 5, 4, 3)),
    ("pack_conv_weights_cell4z2", (5, 5, 5, 4, 3)),
    ("pack_conv_weights_from_unpacked", (3, 3, 3, 4, 3)),
    ("pack_transpconv_weights", (2, 2, 2, 3, 4)),
])
def test_other_weight_packs(name, shape):
    w = _x(shape)
    _close(getattr(tp, name)(torch.from_numpy(w)),
           getattr(jp, name)(jnp.asarray(w)), 0)


def test_pointwise_weights():
    w = _x((6, 2))
    _close(tp.pack_pointwise_weights(torch.from_numpy(w)),
           jp.pack_pointwise_weights(jnp.asarray(w)), 0)


@pytest.mark.parametrize("true_w", [None, 5])
def test_offset_rim_mask(true_w):
    got = tp.offset_rim_mask(5, 8, 3, torch.float32, true_w=true_w)
    _close(got, jp.offset_rim_mask(5, 8, 3, jnp.float32, true_w=true_w), 0)


@pytest.mark.parametrize("hw_pad,kd,in_w", [
    ("pad11", 1, None), ("pad11", 3, None), ("valid", 1, None),
    ("valid", 3, 5), ("pad10", 3, None),
])
def test_conv_packed(hw_pad, kd, in_w):
    """The packed conv classes, including the widened offset input read
    through its true width (negative right padding in JAX)."""
    x = _x((2, 4, 6, 8, 12))
    w = _x((kd, 2, 2, 12, 8), 1) * 0.3
    b = _x((8,), 2)
    kw = dict(hw_pad=hw_pad, in_w=in_w)
    d_stride = 2 if hw_pad == "pad10" else 1
    _close(tp.conv_packed(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), d_stride=d_stride, **kw),
           jp.conv_packed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          d_stride=d_stride, **kw))


@pytest.mark.parametrize("kd,offset_out", [(1, False), (1, True), (3, True)])
def test_conv_packing(kd, offset_out):
    x = _x((1, 4, 8, 10, 3))
    w4 = _x((kd, 4, 4, 3, 8), 1) * 0.3
    _close(tp.conv_packing(torch.from_numpy(x), torch.from_numpy(w4), None,
                           offset_out=offset_out),
           jp.conv_packing(jnp.asarray(x), jnp.asarray(w4), None,
                           offset_out=offset_out))


@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_out_w(kd):
    """The widened offset emission: extra columns of zero input, which
    hold the bias (pallas_conv=True's unpacked -> offset convs)."""
    x = _x((1, 4, 8, 10, 3))
    w4 = _x((kd, 4, 4, 3, 8), 1) * 0.3
    b = _x((8,), 2)
    got = tp.conv_packing(torch.from_numpy(x), torch.from_numpy(w4),
                          torch.from_numpy(b), offset_out=True, out_w=8)
    assert got.shape == (1, 4, 5, 8, 8)
    _close(got, jp.conv_packing(jnp.asarray(x), jnp.asarray(w4),
                                jnp.asarray(b), offset_out=True, out_w=8))
    _close(got[:, :, :, 6:], np.broadcast_to(b, (1, 4, 5, 2, 8)))


@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packed_pad11_out_w(kd):
    """The widened pad11 emission (an aligned -> offset conv K4 does not
    cover), against JAX's one-sided pad."""
    x = _x((2, 4, 6, 5, 12))
    w = _x((kd, 2, 2, 12, 8), 1) * 0.3
    b = _x((8,), 2)
    got = tp.conv_packed(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), hw_pad="pad11", out_w=8)
    assert got.shape == (2, 4, 7, 8, 8)
    _close(got, jp.conv_packed(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), hw_pad="pad11", out_w=8))


@pytest.mark.parametrize("kd", [1, 2])
def test_pointwise_packed_transpconv(kd):
    x = _x((1, 3, 4, 5, 6))
    w = _x((kd, 6, 8), 1)
    b = _x((8,), 2)
    _close(tp.pointwise_packed_transpconv(torch.from_numpy(x),
                                          torch.from_numpy(w),
                                          torch.from_numpy(b)),
           jp.pointwise_packed_transpconv(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b)))


@pytest.mark.parametrize("offset_parity,true_w", [(False, None),
                                                  (True, None), (True, 6)])
def test_instance_norm_packed(offset_parity, true_w):
    x = _x((2, 3, 5, 8, 12))
    if offset_parity:
        m = np.asarray(jp.offset_rim_mask(5, 8, 3, jnp.float32,
                                          true_w=true_w))
        x = x * m
    s, b = _x((3,), 1), _x((3,), 2)
    _close(tp.instance_norm_packed(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b), 1e-5,
                                   offset_parity=offset_parity,
                                   true_w=true_w),
           jp.instance_norm_packed(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b), 1e-5,
                                   offset_parity=offset_parity,
                                   true_w=true_w), 1e-4)


def test_fused_upsample_conv1_and_cell4z2_head():
    """The dual SR head's two packed pieces: fused z-upsample + conv1, and
    the z-paired stride-2 cell4 conv2 with its unpacking."""
    feats = _x((1, 4, 4, 6, 8))
    w1, b1 = _x((3, 3, 3, 2, 3), 1) * 0.3, _x((3,), 2)
    h1_t = tp.fused_upsample_conv1(torch.from_numpy(feats),
                                   torch.from_numpy(w1), torch.from_numpy(b1),
                                   4)
    h1_j = jp.fused_upsample_conv1(jnp.asarray(feats), jnp.asarray(w1),
                                   jnp.asarray(b1), 4)
    _close(h1_t, h1_j)
    w2, b2 = _x((5, 5, 5, 3, 2), 3) * 0.3, _x((2,), 4)
    o_t = tp.conv_packed_s2_cell4z2(h1_t, tp.pack_conv_weights_cell4z2(
        torch.from_numpy(w2)), tp.pack_bias_cell4z2(torch.from_numpy(b2)))
    o_j = jp.conv_packed_s2_cell4z2(h1_j, jp.pack_conv_weights_cell4z2(
        jnp.asarray(w2)), jp.pack_bias_cell4z2(jnp.asarray(b2)))
    _close(o_t, o_j, 1e-4)
    for a, b in zip(tp.unpack_cell4z2(o_t, 2), jp.unpack_cell4z2(o_j, 2)):
        _close(a, b, 1e-4)


# ------------------------------------------- deferred (fused) norm glue

def _stats(n, c4, seed):
    """(n, 16, c4) moment partials of a plausible tensor: sums anywhere,
    sums of squares large enough for a positive variance."""
    s = _x((n, 16, c4), seed)
    s[:, 8:] = np.abs(s[:, 8:]) * 20 + 10
    return s


@pytest.mark.parametrize("affine", [True, False])
def test_norm_scale_shift_from_stats(affine):
    stats = _stats(6, 12, 0)
    scale = torch.from_numpy(_x((3,), 1)) if affine else None
    bias = torch.from_numpy(_x((3,), 2)) if affine else None
    got = tp.norm_scale_shift_from_stats(
        torch.from_numpy(stats), 2, 3, 40, scale, bias, 1e-5, torch.float32)
    want = jp.norm_scale_shift_from_stats(
        jnp.asarray(stats), 2, 3, 40,
        None if scale is None else jnp.asarray(scale.numpy()),
        None if bias is None else jnp.asarray(bias.numpy()), 1e-5,
        jnp.float32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (6, 8, 12)
        _close(g, w, 1e-5)


def test_norm_scale_shift_equals_instance_norm():
    """x * sA + tA from the offset statistics is instance_norm_packed of
    the rim-masked tensor."""
    x = _x((2, 3, 5, 8, 12)) * np.asarray(jp.offset_rim_mask(
        5, 8, 3, jnp.float32))
    s, b = torch.from_numpy(_x((3,), 1)), torch.from_numpy(_x((3,), 2))
    xt = torch.from_numpy(x)
    sa, ta = tp.norm_scale_shift_from_stats(
        tp.offset_stats_xla(xt), 2, 3, 3 * 4 * 7, s, b, 1e-5, torch.float32)
    got = xt * sa[:, 0].reshape(2, 3, 1, 1, 12) + ta[:, 0].reshape(
        2, 3, 1, 1, 12)
    want = tp.instance_norm_packed(xt, s, b, 1e-5, offset_parity=True)
    got = got * tp.offset_rim_mask(5, 8, 3, torch.float32)
    want = want * tp.offset_rim_mask(5, 8, 3, torch.float32)
    _close(got, want.numpy(), 1e-4)


@pytest.mark.parametrize("true_w", [None, 6])
def test_offset_stats_xla(true_w):
    y = _x((2, 3, 5, 8, 12))
    got = tp.offset_stats_xla(torch.from_numpy(y), true_w=true_w)
    want = jp.offset_stats_xla(jnp.asarray(y), true_w=true_w)
    assert tuple(got.shape) == (6, 16, 12) and got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_aligned_stats_xla():
    y = _x((2, 3, 4, 8, 12))
    _close(tp.aligned_stats_xla(torch.from_numpy(y)),
           jp.aligned_stats_xla(jnp.asarray(y)), 1e-5)


@pytest.mark.parametrize("dt,offset_parity,true_w", [
    ("float32", False, None), ("float32", True, 6), ("bfloat16", True, None),
])
def test_apply_norm_act_packed(dt, offset_parity, true_w):
    """The one-pass materialize, in fp32 and in bf16 (its rounding after
    the multiply, the add and the leaky product is JAX's)."""
    y = _x((2, 3, 5, 8, 12))
    sa, ta = (np.abs(_x((6, 8, 12), 1)) + 0.5), _x((6, 8, 12), 2)
    tdt = getattr(torch, dt)
    got = tp.apply_norm_act_packed(
        torch.from_numpy(y).to(tdt), torch.from_numpy(sa).to(tdt),
        torch.from_numpy(ta).to(tdt), 0.01, offset_parity=offset_parity,
        true_w=true_w)
    jdt = getattr(jnp, dt)
    want = jp.apply_norm_act_packed(
        jnp.asarray(y, jdt), jnp.asarray(sa, jdt), jnp.asarray(ta, jdt),
        0.01, offset_parity=offset_parity, true_w=true_w)
    assert got.dtype == tdt
    _close(got.float(), np.asarray(want, np.float32), 0 if dt == "bfloat16"
           else 1e-6)


# ------------------------------------------- conv_packing as a cell conv

BF16_TOL = 2e-2


def _strided_packing(x, w4, b, *, offset_out=False, out_w=None):
    """conv_packing's definition: the (kd, 4, 4) stride-(1, 2, 2) conv
    itself, H and W padded 2 (offset output) or 1 (aligned), out_w's
    extra columns as more right padding."""
    kd = w4.shape[0]
    p = 2 if offset_out else 1
    extra = 0 if out_w is None else out_w - (x.shape[3] // 2 + 1)
    y = tp.conv_general(x, w4, (1, 2, 2),
                        ((kd // 2, kd // 2), (p, p), (p, p + 2 * extra)))
    return y + b if b is not None else y


@pytest.mark.parametrize("ci", [1, 3])
@pytest.mark.parametrize("form", ["aligned", "offset", "offset_out_w"])
@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_bf16(kd, form, ci):
    """bf16 conv_packing (a stride-1 conv over 2x2 cells) against the
    strided conv it stands for, computed in fp32 from the same bf16
    operands, and against JAX's conv_packing on those operands."""
    kw = dict(offset_out=form != "aligned",
              out_w=8 if form == "offset_out_w" else None)
    x = torch.from_numpy(_x((2, 4, 8, 10, ci))).to(torch.bfloat16)
    w4 = torch.from_numpy(_x((kd, 4, 4, ci, 8), 1) * 0.3).to(torch.bfloat16)
    b = torch.from_numpy(_x((8,), 2)).to(torch.bfloat16)
    got = tp.conv_packing(x, w4, b, **kw)
    assert got.dtype == torch.bfloat16
    want = _strided_packing(x.float(), w4.float(), b.float(), **kw)
    assert got.shape == want.shape
    _close(got.float(), want.numpy(), BF16_TOL)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = jnp.asarray(w4.float().numpy(), jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), jnp.bfloat16)
    _close(got.float(), np.asarray(jp.conv_packing(jx, jw, jb, **kw),
                                   np.float32), BF16_TOL)


@pytest.mark.parametrize("offset_out", [False, True])
@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_odd_rows(kd, offset_out):
    """An H block of a sharded input with an odd row count: the cell form
    pads one zero row and drops its output, so it equals the strided conv
    (fp64, to rounding)."""
    x = torch.from_numpy(_x((1, 4, 7, 10, 3))).double()
    w4 = torch.from_numpy(_x((kd, 4, 4, 3, 8), 1)).double()
    got = tp.conv_packing(x, w4, None, offset_out=offset_out)
    want = _strided_packing(x, w4, None, offset_out=offset_out)
    assert got.shape == want.shape
    _close(got, want.numpy(), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_runs_one_stride1_cell_conv(monkeypatch, kd, dtype):
    """In every dtype conv_packing makes one library conv, of stride 1
    and a (2, 2) in-plane kernel over 4 Ci channels: no strided (4, 4)
    conv, the class cuDNN ran without tensor cores."""
    calls = []
    for name in ("conv2d", "conv3d"):
        orig = getattr(torch.nn.functional, name)

        def spy(x, w, *a, _orig=orig, **k):
            calls.append((tuple(w.shape), tuple(k.get("stride", (1,)))))
            return _orig(x, w, *a, **k)

        monkeypatch.setattr(torch.nn.functional, name, spy)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_x((1, 4, 8, 10, 3))).to(tdt)
    w4 = torch.from_numpy(_x((kd, 4, 4, 3, 8), 1)).to(tdt)
    tp.conv_packing(x, w4, None, offset_out=True)
    assert len(calls) == 1
    (co, ci, *k), stride = calls[0]
    assert (co, ci, k[-2:]) == (8, 12, [2, 2])
    assert set(stride) == {1}


@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_bf16_grads(kd):
    """The cell form's input and weight gradients, bf16, against the
    strided conv's in fp32 from the same bf16 operands (relative norm
    within the bf16 tolerance)."""
    x = torch.from_numpy(_x((2, 4, 8, 10, 3))).to(torch.bfloat16)
    w4 = torch.from_numpy(_x((kd, 4, 4, 3, 8), 1) * 0.3).to(torch.bfloat16)
    gy = torch.from_numpy(_x((2, 4, 4, 5, 8), 3))

    def grads(fn, dt):
        xg = x.to(dt).requires_grad_(True)
        wg = w4.to(dt).requires_grad_(True)
        y = fn(xg, wg, None)
        return torch.autograd.grad(y, (xg, wg), gy.to(dt))

    got = grads(tp.conv_packing, torch.bfloat16)
    want = grads(_strided_packing, torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w).norm() / w.norm())
        assert err < BF16_TOL, err
