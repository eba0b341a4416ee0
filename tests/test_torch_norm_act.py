"""The norm-act op (``ops/norm_act.py``) on the CPU: its plain version
against the packed forward's eager chain as it stood before the op, bit
for bit, in every form and dtype; the forward's routing (pallas_conv False
never calls the op; "cat" calls it at every ConvNormAct and its CPU
forward is the eager chain's bit for bit); the coverage rule; the refusal
of inputs that require grad; the C entry names. The kernels themselves
run on the card only (``tests/test_torch_norm_act_card.py``)."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rehrseg_tpu_torch import kernels
from rehrseg_tpu_torch.models import convert, segnet_packed
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.ops import norm_act as na
from rehrseg_tpu_torch.ops.pack2d import offset_rim_mask, stats_dtype
from rehrseg_tpu_torch.train.precision import policy

torch.set_num_threads(2)

_K = ((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
ARCH_PLAIN = dict(
    n_stages=4, features_per_stage=(32, 32, 32, 32), kernel_sizes=_K,
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_conv_per_stage=(2, 2, 2, 2), n_conv_per_stage_decoder=(2, 2, 2),
    conv_bias=True, norm_eps=1e-5, norm_affine=True, nonlin_slope=0.01)
ARCH_RES = dict(
    n_stages=4, features_per_stage=(32, 32, 64, 64), kernel_sizes=_K,
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_blocks_per_stage=(1, 2, 2, 2), n_conv_per_stage_decoder=(1, 1, 1),
    conv_bias=True, norm_eps=1e-5, norm_affine=True, nonlin_slope=0.01)
ARCHS = {"plain": ARCH_PLAIN, "resenc": ARCH_RES}
INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.float64: torch.int64}

# form: (shape (B, D, h, w, C4), true_w)
CASES = {
    "offset_widened": ((2, 3, 5, 8, 32), 6),
    "offset": ((2, 3, 5, 7, 32), None),
    "aligned": ((2, 3, 4, 6, 32), None),
    "unpacked": ((2, 3, 4, 6, 16), None),
}


def _instance_norm_packed(xp, scale, bias, eps, offset_parity=False,
                          true_w=None):
    """``ops.pack2d.instance_norm_packed`` as it stood before the op, in
    one piece."""
    b_, d, h, w, c4 = xp.shape
    c = c4 // 4

    def group_mean(t):
        return t.reshape(b_, 4, c).mean(1).repeat(1, 4)

    x32 = stats_dtype(xp)
    if offset_parity:
        n = d * (h - 1) * ((true_w if true_w is not None else w) - 1)
        m1 = group_mean(x32.sum((1, 2, 3)) / n)
        m2 = group_mean(x32.square().sum((1, 2, 3)) / n)
        v = m2 - m1.square()
    else:
        m1 = group_mean(x32.mean((1, 2, 3)))
        vg = (x32 - m1[:, None, None, None, :]).square().mean((1, 2, 3))
        v = group_mean(vg)
    k = torch.rsqrt(v + eps)
    y = (xp - m1[:, None, None, None, :].to(xp.dtype)) \
        * k[:, None, None, None, :].to(xp.dtype)
    if scale is not None:
        y = y * scale.repeat(4) + bias.repeat(4)
    return y


def _eager_chain(y, b, scale, bias, eps, slope, form, true_w):
    """The packed forward's tail as ``_conv_norm_act`` ran it before the
    op: the conv's ``y + b``, then the unpacked ``_instance_norm``, or
    ``instance_norm_packed`` (between two rim masks for an offset
    tensor), then ``F.leaky_relu``, each as it stood then."""
    def leaky(t):
        return t if slope is None else F.leaky_relu(t, slope)

    if b is not None:
        y = y + b
    if form == "unpacked":
        spatial = tuple(range(1, y.ndim - 1))
        x32 = stats_dtype(y)
        m = x32.mean(spatial, keepdim=True)
        v = x32.var(spatial, correction=0, keepdim=True)
        y = (y - m.to(y.dtype)) * torch.rsqrt(v + eps).to(y.dtype)
        if scale is not None:
            y = y * scale + bias
        return leaky(y)
    if form == "aligned":
        return leaky(_instance_norm_packed(y, scale, bias, eps))
    hp, wp, c = y.shape[2], y.shape[3], y.shape[-1] // 4

    def mask(t):
        return t * offset_rim_mask(hp, wp, c, t.dtype, t.device,
                                   true_w=true_w)[0:hp]

    y = _instance_norm_packed(mask(y), scale, bias, eps, offset_parity=True,
                              true_w=true_w)
    return mask(leaky(y))


def _operands(case, dtype, affine, seed=0):
    shape, true_w = CASES[case]
    rng = np.random.default_rng(seed)
    c4 = shape[-1]
    c = c4 if case == "unpacked" else c4 // 4
    y = torch.from_numpy(1.5 + 2.0 * rng.normal(size=shape)).to(dtype)
    b = torch.from_numpy(0.3 * rng.normal(size=c4)).to(dtype)
    scale = bias = None
    if affine:
        scale = torch.from_numpy(1 + 0.2 * rng.normal(size=c)).to(dtype)
        bias = torch.from_numpy(0.2 * rng.normal(size=c)).to(dtype)
    form = "unpacked" if case == "unpacked" else case.split("_")[0]
    return y, b, scale, bias, form, true_w


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(INT_VIEW[a.dtype]), b.view(INT_VIEW[b.dtype]))


@pytest.mark.parametrize("slope", [0.01, None], ids=["leaky", "linear"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64],
                         ids=["bf16", "fp32", "fp64"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_is_the_eager_chain(case, dtype, affine, slope):
    """The plain version, and the op on CPU tensors, equal the eager chain
    bit for bit (signed zeros at the rim included); the moments and the
    apply half compose to it."""
    y, b, scale, bias, form, true_w = _operands(case, dtype, affine)
    want = _eager_chain(y, b, scale, bias, 1e-5, slope, form, true_w)
    kw = dict(eps=1e-5, slope=slope, form=form, true_w=true_w)
    launches = na.norm_act.launches
    assert _bits_equal(na.norm_act_plain(y, b, scale, bias, **kw), want)
    assert _bits_equal(na.norm_act(y, b, scale, bias, **kw), want)
    assert na.norm_act.launches == launches
    m, k = na.norm_stats_plain(y, b, eps=1e-5, form=form, true_w=true_w)
    assert m.shape == k.shape == (y.shape[0], y.shape[-1])
    got = na.norm_act_apply_plain(y, b, m, k, scale, bias, slope=slope,
                                  form=form, true_w=true_w)
    assert _bits_equal(got, want)


def test_offset_rim_is_zero_and_moments_skip_it():
    """Garbage at the rim and past true_w changes neither the moments
    nor the real pixels; the rim comes out zero."""
    y, b, scale, bias, form, true_w = _operands("offset_widened",
                                                torch.float32, True)
    kw = dict(eps=1e-5, slope=0.01, form=form, true_w=true_w)
    rim = offset_rim_mask(y.shape[2], y.shape[3], y.shape[-1] // 4,
                          y.dtype, true_w=true_w)
    noisy = torch.where(rim.bool(), y, torch.full_like(y, 1e4))
    got = na.norm_act_plain(noisy, b, scale, bias, **kw)
    assert torch.equal(got, na.norm_act_plain(y, b, scale, bias, **kw))
    assert not got[..., ~rim.bool()].any()


def test_covers():
    y = torch.zeros((2, 3, 5, 8, 32), dtype=torch.bfloat16)
    b = torch.zeros(32, dtype=torch.bfloat16)
    g = torch.ones(8, dtype=torch.bfloat16)
    assert na.norm_act_covers(y, b, g, g, "offset")
    assert na.norm_act_covers(y, None, None, None, "unpacked")
    assert na.norm_act_covers(y.float(), b.float(), None, None, "aligned")
    # fp64; a group of 4 channels (not a whole 16-byte vector); 2048
    # channels; a strided view; a bias of another dtype
    assert not na.norm_act_covers(y.double(), None, None, None, "aligned")
    assert not na.norm_act_covers(y[..., :16], None, None, None, "offset")
    assert not na.norm_act_covers(
        torch.zeros((1, 1, 2, 2, 2048), dtype=torch.bfloat16), None, None,
        None, "unpacked")
    assert not na.norm_act_covers(y[:, :, :, ::2], None, None, None,
                                  "aligned")
    assert not na.norm_act_covers(y, b.float(), None, None, "offset")
    with pytest.raises(ValueError, match="form"):
        na.norm_act_covers(y, None, None, None, "packed")
    # the dtype and width half alone
    assert na.norm_act_takes(torch.bfloat16, 256, "aligned")
    assert not na.norm_act_takes(torch.bfloat16, 320, "offset")
    assert na.norm_act_takes(torch.float32, 320, "unpacked", None, g.float())
    assert not na.norm_act_takes(torch.float64, 32, "unpacked")
    assert not na.norm_act_takes(torch.bfloat16, 4, "unpacked")
    assert not na.norm_act_takes(torch.bfloat16, 32, "offset", g.float())


@pytest.mark.parametrize("dtype,feats,params_dtype,want", [
    (torch.bfloat16, 32, None, {"offset", "aligned", "unpacked"}),
    (torch.float32, 320, None, {"unpacked"}),
    (torch.bfloat16, 12, None, set()),
    (torch.float64, 32, None, set()),
    (torch.bfloat16, 32, torch.float32, set()),
], ids=["bf16", "fp32_wide", "narrow", "fp64", "fp32_params"])
def test_route_on_the_card_by_dtype_and_width(dtype, feats, params_dtype,
                                              want):
    """Off the CPU the forward routes only the forms whose dtypes and
    width the kernels take (a meta tensor stands for a CUDA one here);
    the others keep the plain version, and the op itself raises on a
    non-CPU tensor it does not cover instead of giving way."""
    x = torch.empty((2, 3, 4, 6, 1), dtype=dtype, device="meta")
    p = torch.empty(feats, dtype=params_dtype or dtype, device="meta")
    w = torch.empty((1, 3, 3, 1, feats), dtype=dtype, device="meta")
    assert segnet_packed._norm_act_route("cat", feats, (x,),
                                         (w, p, p, p)) == want
    assert segnet_packed._norm_act_route(False, feats, (x,),
                                         (w, p, p, p)) == frozenset()
    cpu = torch.empty((2, 3, 4, 6, 1), dtype=dtype)
    assert segnet_packed._norm_act_route("cat", feats, (cpu,),
                                         (w, p, p, p)) == set(na.FORMS)
    y = torch.empty((2, 3, 4, 6, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        na.norm_act(y, None, None, None, eps=1e-5, slope=0.01,
                    form="unpacked")


def test_requires_grad_raises():
    y, b, scale, bias, form, true_w = _operands("aligned", torch.float32,
                                                True)
    y.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        na.norm_act(y, b, scale, bias, eps=1e-5, slope=0.01, form=form)
    with torch.no_grad():
        na.norm_act(y, b, scale, bias, eps=1e-5, slope=0.01, form=form)


def test_c_entries_declared():
    src = (kernels.CSRC / kernels.SOURCES["norm_act"]).read_text()
    for lib, fn_name in na.C_ENTRIES.values():
        assert lib == "norm_act"
        assert re.search(r'extern "C" int\s+%s\s*\(' % fn_name, src), fn_name
    # the kernels' names classify as reductions in a profiler's breakdown
    for name in re.findall(r"__global__ void __launch_bounds__\(\w+\)\n"
                           r"(\w+)\(", src):
        assert "norm" in name
        assert not any(f in name for f in (
            "conv", "gemm", "xmma", "cutlass", "sm90_", "sm80_", "cudnn",
            "implicit", "cat", "pad", "copy"))


def _n_norms(tree) -> int:
    """ConvNormActs (and projection norms) of a params tree: its "norm"
    groups."""
    if not isinstance(tree, dict):
        return 0
    return sum(1 if k == "norm" else _n_norms(v) for k, v in tree.items())


def _forward(arch, dtype, pallas_conv, monkeypatch, route=None):
    """One dual packed forward; returns (outputs, tails, op calls, norms):
    tails holds, for each tail, whether its form was on the op's
    route."""
    tails, calls = [], []
    orig_tail, orig_op = segnet_packed._norm_act_tail, segnet_packed.norm_act

    def tail_spy(*a, **k):
        tails.append(k["form"] in k["routes"])
        return orig_tail(*a, **k)

    def op_spy(*a, **k):
        calls.append(k["form"])
        return orig_op(*a, **k)

    monkeypatch.setattr(segnet_packed, "_norm_act_tail", tail_spy)
    monkeypatch.setattr(segnet_packed, "norm_act", op_spy)
    if route is False:
        monkeypatch.setattr(segnet_packed, "_norm_act_route",
                            lambda *a: frozenset())
    params = convert.random_flax_params(arch, 0)
    x = np.random.default_rng(0).normal(size=(2, 8, 32, 48, 1))
    tparams = policy("bf16" if dtype == torch.bfloat16
                     else "fp32").cast_compute(convert.tree_to_torch(params))
    with torch.no_grad():
        out = segmodel_apply_packed(arch, tparams, torch.from_numpy(x).to(
            dtype), dual=True, upscale=4, pallas_conv=pallas_conv)
    monkeypatch.undo()
    return out, tails, calls, _n_norms(params)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cat_forward_routes_every_tail_bit_for_bit(arch, dtype,
                                                   monkeypatch):
    """Under "cat" every ConvNormAct's tail calls the op (the CPU route:
    no launch), and the forward equals, bit for bit, the one with the op
    kept off (the convs adding their bias, the eager chain), which is the
    forward before the op. Under False the op is never called."""
    launches = na.norm_act.launches
    got, tails, calls, n_norms = _forward(ARCHS[arch], dtype, "cat",
                                          monkeypatch)
    assert len(tails) == len(calls) == n_norms and all(tails)
    assert na.norm_act.launches == launches
    want, tails_off, calls_off, _ = _forward(ARCHS[arch], dtype, "cat",
                                             monkeypatch, route=False)
    assert len(tails_off) == n_norms and not calls_off
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    _, tails_false, calls_false, _ = _forward(ARCHS[arch], dtype, False,
                                              monkeypatch)
    assert len(tails_false) == n_norms and not any(tails_false)
    assert not calls_false
