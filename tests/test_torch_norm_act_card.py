"""The norm-act kernels on the card (``cuda``-marked; they skip where
PyTorch sees no card), bf16 at the served forward's shapes (an 8-way TTA
batch of (16, 320, 384) tiles) and fp32 at a small one:

- the moment kernel's mean m and inverse std k against an fp64
  computation of the same moments (1e-5 relative; m relative to the
  larger of |m| and the standard deviation, as a mean near zero has no
  relative error of its own);
- the apply kernel, given the plain chain's own m and k, bit for bit
  against the plain chain (``norm_act_plain``, the packed forward's eager
  chain);
- the two kernels end to end against the plain chain: at least 99 % of
  the elements equal, and none more than 2 bf16 ulps off, ulps counted at
  the element's magnitude floored at 1 (the normalized unit: near zero a
  one-ulp change of the bf16 mean, or of a product before the affine
  shift, moves an output by an absolute amount, so a count of
  representable values in between would be unbounded there);
- ``norm_act.launches`` counts every ConvNormAct of one "cat" tile
  forward, both archs; an fp64 tail keeps the plain chain by its route
  (no launch), and the op raises on a CUDA tensor it does not cover
  instead of giving way;
- calls on two streams keep their own ticket counters and give the
  default stream's results;
- under ``torch.profiler`` the kernels' names fall in the benchmark's
  ``reduction`` class (``h100bench/trace.py``), so its glue counts them.

No JAX here: the card's machine has none, so ``pytest --noconftest -m
cuda`` runs this file there."""

import pytest
import torch

from rehrseg_tpu_torch.ops import norm_act as na
from rehrseg_tpu_torch.ops.pack2d import offset_rim_mask

# (shape (B, D, h, w, C4), true_w, form): the stem's offset output, K1's
# 8-aligned offset output, stage 0's aligned and stage 1's unpacked
# tensors, a deep stage's
SERVED = {
    "stage0_offset": ((8, 16, 161, 193, 128), None, "offset"),
    "stage0_offset_k1": ((8, 16, 161, 200, 128), 193, "offset"),
    "stage0_aligned": ((8, 16, 160, 192, 128), None, "aligned"),
    "stage1_unpacked": ((8, 16, 160, 192, 64), None, "unpacked"),
    "stage4_unpacked": ((8, 2, 20, 24, 320), None, "unpacked"),
}
SMALL_F32 = {
    "offset": ((2, 3, 9, 16, 32), 13, "offset"),
    "aligned": ((2, 3, 8, 12, 64), None, "aligned"),
    "unpacked": ((2, 3, 8, 12, 40), None, "unpacked"),
}
INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _operands(dev, shape, form, dtype, affine=True, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c4 = shape[-1]
    c = c4 if form == "unpacked" else c4 // 4
    y = (0.7 + 1.3 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    b = (0.3 * torch.randn(c4, generator=gen, device=dev)).to(dtype)
    scale = bias = None
    if affine:
        scale = (1 + 0.2 * torch.randn(c, generator=gen, device=dev)).to(
            dtype)
        bias = (0.2 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    return y, b, scale, bias


def _moments64(y, b, form, true_w, eps):
    """m and k in fp64 of the tail's input (y + b rounded to y's dtype,
    rim excluded), the groups merged; each (B, C4)."""
    t = (y + b).double()
    bsz, c4 = y.shape[0], y.shape[-1]
    g = 1 if form == "unpacked" else 4
    if form == "offset":
        real = offset_rim_mask(y.shape[2], y.shape[3], c4 // 4,
                               torch.float64, y.device, true_w=true_w)
    else:
        real = torch.ones(y.shape[2:], dtype=torch.float64, device=y.device)
    n = (real.sum((0, 1)) * y.shape[1]).reshape(g, c4 // g).sum(0)
    s = (t * real).sum((1, 2, 3)).reshape(bsz, g, c4 // g).sum(1)
    m = s / n
    mb = m.repeat(1, g)
    q = ((t - mb[:, None, None, None]).square() * real).sum(
        (1, 2, 3)).reshape(bsz, g, c4 // g).sum(1)
    del t
    return mb, torch.rsqrt(q / n + eps).repeat(1, g)


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SERVED))
def test_stats_match_fp64(cuda_device, site):
    shape, true_w, form = SERVED[site]
    y, b, _, _ = _operands(cuda_device, shape, form, torch.bfloat16, False)
    m, k = na.norm_stats(y, b, eps=1e-5, form=form, true_w=true_w)
    m64, k64 = _moments64(y, b, form, true_w, 1e-5)
    sd = 1 / k64
    assert float(((m.double() - m64).abs() / torch.maximum(
        m64.abs(), sd)).max()) <= 1e-5
    assert float(((k.double() - k64).abs() / k64).max()) <= 1e-5


def _ulps_at_scale(got, want):
    """|got - want| in bf16 ulps of max(|want|, 1)."""
    mag = want.float().abs().clamp_min(1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got.float() - want.float()).abs() / ulp


@pytest.mark.cuda
@pytest.mark.parametrize("affine,slope", [(True, 0.01), (False, None)],
                         ids=["affine_leaky", "linear"])
@pytest.mark.parametrize("site", list(SERVED))
def test_apply_bit_equal_and_end_to_end(cuda_device, site, affine, slope):
    shape, true_w, form = SERVED[site]
    y, b, scale, bias = _operands(cuda_device, shape, form, torch.bfloat16,
                                  affine)
    kw = dict(slope=slope, form=form, true_w=true_w)
    want = na.norm_act_plain(y, b, scale, bias, eps=1e-5, **kw)
    m, k = na.norm_stats_plain(y, b, eps=1e-5, form=form, true_w=true_w)
    got = na.norm_act_apply(y, b, m, k, scale, bias, **kw)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    del got
    launches = na.norm_act.launches
    got = na.norm_act(y, b, scale, bias, eps=1e-5, **kw)
    assert na.norm_act.launches == launches + 1
    equal = float((got.view(torch.int16) == want.view(torch.int16)).double()
                  .mean())
    worst = float(_ulps_at_scale(got, want).max())
    print(f"{site}: equal {equal:.6f}, worst {worst} ulps at scale")
    assert equal >= 0.99
    assert worst <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SMALL_F32))
def test_fp32(cuda_device, case):
    """fp32 at a small shape: the apply bit for bit from the plain
    moments, the moments against fp64."""
    shape, true_w, form = SMALL_F32[case]
    y, b, scale, bias = _operands(cuda_device, shape, form, torch.float32)
    kw = dict(slope=0.01, form=form, true_w=true_w)
    want = na.norm_act_plain(y, b, scale, bias, eps=1e-5, **kw)
    m, k = na.norm_stats_plain(y, b, eps=1e-5, form=form, true_w=true_w)
    got = na.norm_act_apply(y, b, m, k, scale, bias, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m, k = na.norm_stats(y, b, eps=1e-5, form=form, true_w=true_w)
    m64, k64 = _moments64(y, b, form, true_w, 1e-5)
    assert float(((m.double() - m64).abs() / torch.maximum(
        m64.abs(), 1 / k64)).max()) <= 1e-5
    assert float(((k.double() - k64).abs() / k64).max()) <= 1e-5
    torch.testing.assert_close(na.norm_act(y, b, scale, bias, eps=1e-5,
                                           **kw), want, rtol=1e-5,
                               atol=1e-5)


def _n_norms(tree) -> int:
    if not isinstance(tree, dict):
        return 0
    return sum(1 if k == "norm" else _n_norms(v) for k, v in tree.items())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["plain", "resenc"])
def test_launches_every_site_of_a_tile(cuda_device, arch):
    """One bf16 "cat" tile forward at the served archs' widths (a smaller
    patch): every ConvNormAct (a "norm" group of the params) launches the
    kernels once, and the outputs are finite."""
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
    from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
    from rehrseg_tpu_torch.train.precision import policy

    a = dict(DEFAULT_ARCH)
    if arch == "resenc":     # nnU-Net's ResEnc plans on the same stages
        del a["n_conv_per_stage"]
        a.update(n_blocks_per_stage=(1, 3, 4, 6, 6, 6),
                 n_conv_per_stage_decoder=(1, 1, 1, 1, 1))
    params = convert.random_flax_params(a, 0)
    tparams = policy("bf16").cast_compute(
        convert.tree_to_torch(params, device=cuda_device))
    x = torch.randn((8, 16, 64, 96, 1), device=cuda_device).to(
        torch.bfloat16)
    launches = na.norm_act.launches
    with torch.no_grad():
        lr, hr = segmodel_apply_packed(a, tparams, x, dual=True, upscale=4,
                                       pallas_conv="cat", plane_out=True)
    assert na.norm_act.launches - launches == _n_norms(params)
    assert bool(torch.isfinite(lr.float()).all())
    assert bool(torch.isfinite(hr.float()).all())


@pytest.mark.cuda
def test_kernel_names_classify_as_reduction(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from h100bench.trace import classify

    shape, true_w, form = SMALL_F32["offset"]
    y, b, scale, bias = _operands(cuda_device, shape, form, torch.bfloat16)

    def run():
        return na.norm_act(y, b, scale, bias, eps=1e-5, slope=0.01,
                           form=form, true_w=true_w)

    run()
    torch.cuda.synchronize()
    # three calls: a profiler started after an earlier one in the process
    # can drop the first kernel of its window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    stats = [n for n in names if "norm_stats" in n]
    apply = [n for n in names if "norm_act_apply" in n]
    assert len(stats) == len(apply) == 1, names
    assert classify(stats[0]) == classify(apply[0]) == "reduction"


@pytest.mark.cuda
def test_uncovered_cuda_tensor_raises(cuda_device):
    shape, true_w, form = SMALL_F32["aligned"]
    y, b, scale, bias = _operands(cuda_device, shape, form, torch.bfloat16)
    kw = dict(eps=1e-5, slope=0.01, form=form, true_w=true_w)
    for args in ((y.double(), None, None, None),          # fp64
                 (y[:, :, :, ::2], b, scale, bias),        # strided
                 (y, b, scale.float(), bias.float())):     # fp32 affine
        with pytest.raises(ValueError, match="does not take"):
            na.norm_act(*args, **kw)


@pytest.mark.cuda
def test_fp64_tail_keeps_the_plain_chain(cuda_device):
    """fp64 is not a dtype of the kernels: on the card the forward's route
    turns every form away, and the tail is the plain chain (no launch, no
    error); a bf16 input routes every form."""
    from rehrseg_tpu_torch.models import segnet_packed as spk

    shape, true_w, form = SMALL_F32["offset"]
    y, b, scale, bias = (t.double() for t in _operands(
        cuda_device, shape, form, torch.float32))
    w = torch.zeros((1, 3, 3, 8, 8), dtype=torch.float64, device=cuda_device)
    params = (w, b[:8], scale, bias)
    routes = spk._norm_act_route("cat", 8, (y,), params)
    assert routes == frozenset()
    assert spk._norm_act_route("cat", 8, (y.bfloat16(),), tuple(
        t.bfloat16() for t in params)) == set(na.FORMS)
    launches = na.norm_act.launches
    got = spk._norm_act_tail(y, None, scale, bias, 1e-5, 0.01, form, 8,
                             tw=true_w, routes=routes)
    assert na.norm_act.launches == launches
    want = na.norm_act_plain(y, None, scale, bias, eps=1e-5, slope=0.01,
                             form=form, true_w=true_w)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_two_streams_keep_their_own_tickets(cuda_device):
    shape, true_w, form = SMALL_F32["offset"]
    ys = [_operands(cuda_device, shape, form, torch.bfloat16, seed=s)
          for s in (1, 2)]
    kw = dict(eps=1e-5, slope=0.01, form=form, true_w=true_w)
    want = [na.norm_act(*ops, **kw) for ops in ys]
    streams = [torch.cuda.Stream(cuda_device) for _ in ys]
    torch.cuda.synchronize()
    got = []
    for st, ops in zip(streams, ys):
        with torch.cuda.stream(st):
            got.append(na.norm_act(*ops, **kw))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    keys = {(st.device, st.cuda_stream) for st in streams}
    assert keys <= set(na._TICKETS)
    assert len({na._TICKETS[k_].data_ptr() for k_ in keys}) == 2
