"""Spatial (H-sharded) serving in the port (``parallel.spatial``) on the
CPU, one CPU named several times as XLA's forced host device count names
it for JAX:

  - each sharded op of the packed forward (``conv_packed`` pad10 / pad11 /
    valid, ``conv_packing``, K1's plain version, ``instance_norm_packed``
    and the unpacked norm, the unpacked conv, the SR head in its three
    forms) against the op on the whole tensor, over 2, 3 and 4 blocks (3
    gives uneven blocks): in fp32 within 1e-6 of the output's scale (the
    legacy SR head's last conv, 5120 products a sum, 4e-6: the CPU's conv
    sums a block's rows in another order than the whole tensor's), in
    fp64 within 1e-12;
  - the whole packed forward (LR, dual, skips; pallas_conv False and
    "cat"; packed and unpacked) against the unsharded one (1e-5);
  - ``torch.autograd.gradcheck`` through the halo exchange and the norm's
    moment sums on a tiny fp64 case, and its gradients against the
    unsharded function's;
  - JAX's three engine configurations (tests/test_tta_mesh.py: data 8,
    spatial 4, data 4 x spatial 2): the port's labels against JAX's
    sharded engine and against the port's single-device engine, equal
    except under the 1e-3 near-tie rule;
  - the Segmenter case of tests/test_serve.py (bf16, mismatch under 2 %),
    and the dual and ``_many`` paths;
  - the row record at the bench tile's H (320, spatial 2, DEFAULT_ARCH):
    every level, the packed stages 0-1 and the decoder's last stages
    included, runs sharded; small levels of a small tile run gathered."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.parallel import make_mesh as jax_make_mesh
from rehrseg_tpu.parallel import replicate
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models import segnet_packed as spk
from rehrseg_tpu_torch.models.segnet import DEFAULT_ARCH
from rehrseg_tpu_torch.ops import pack2d, pconv
from rehrseg_tpu_torch.parallel import spatial as sp
from rehrseg_tpu_torch.parallel.mesh import make_mesh
from rehrseg_tpu_torch.serve import Segmenter
from tests.test_models import SMALL_ARCH
from tests.test_torch_engine import _labels_agree

torch.set_num_threads(2)

CPU = torch.device("cpu")
PATCH = (4, 16, 16)
BLOCKS = [2, 3, 4]


def _g(n):
    return [CPU] * n


def _t(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(dtype)


def _close(got, want, tol=1e-6):
    """``got`` within ``tol`` (fp32; 1e-12 for fp64) of ``want``'s largest
    magnitude."""
    got, want = sp.gather(got), sp.gather(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == torch.float64:
        tol = 1e-12
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(params=[torch.float32, torch.float64], ids=["fp32", "fp64"])
def dt(request):
    return request.param


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(SMALL_ARCH, 3)


# ---------------------------------------------------------------- the ops

CONV_PACKED = {
    # name: (input layout's extra row, unpacked weights, pack kwargs,
    # conv_packed kwargs)
    "pad11_kd1": (0, (1, 3, 3), {}, dict(hw_pad="pad11")),
    "pad11_kd3": (0, (3, 3, 3), {}, dict(hw_pad="pad11")),
    "pad10_strided": (0, (3, 3, 3), dict(packed_out=False,
                                         aligned_in_strided=True),
                      dict(hw_pad="pad10")),
    "valid_kd1": (1, (1, 3, 3), {}, {}),
    "valid_k5": (1, (1, 5, 5), {}, {}),
    "valid_strided": (1, (3, 3, 3), dict(packed_out=False), {}),
}


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("case", list(CONV_PACKED))
def test_conv_packed_sharded(case, n, dt):
    extra, k, pack_kw, kw = CONV_PACKED[case]
    gen = torch.Generator().manual_seed(1)
    x = _t(gen, 2, 3, 12 + extra, 7 + extra, 8, dtype=dt)
    wp = pack2d.pack_conv_weights(_t(gen, *k, 2, 3, dtype=dt), **pack_kw)
    b = _t(gen, wp.shape[-1], dtype=dt)
    want = pack2d.conv_packed(x, wp, b, **kw)
    _close(spk._packed(sp.split(x, _g(n)), wp, b, **kw), want)


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("offset_out", [False, True])
@pytest.mark.parametrize("kd", [1, 3])
def test_conv_packing_sharded(kd, offset_out, n, dt):
    gen = torch.Generator().manual_seed(2)
    x = _t(gen, 2, 3, 24, 14, 3, dtype=dt)
    w4 = pack2d.pack_conv_weights_from_unpacked(
        _t(gen, kd, 3, 3, 3, 4, dtype=dt))
    b = _t(gen, 16, dtype=dt)
    want = pack2d.conv_packing(x, w4, b, offset_out=offset_out)
    _close(spk._packing(sp.split(x, _g(n)), w4, b, offset_out=offset_out),
           want)


@pytest.mark.parametrize("n", BLOCKS)
def test_k1_plain_sharded(n, dt):
    """K1 (its plain version on the CPU) on each block with its halo rows,
    cropped to the block's offset rows."""
    gen = torch.Generator().manual_seed(3)
    xa = _t(gen, 1, 2, 10, 8, 128, dtype=dt)
    xb = _t(gen, 1, 2, 10, 8, 128, dtype=dt)
    w, b = _t(gen, 2, 2, 256, 128, dtype=dt) * 0.05, _t(gen, 128, dtype=dt)
    assert pconv.pconv_pad11_cat_covers(xa, xb, w)
    want = spk._k1_cat((xa, xb), w, b)
    assert want.shape == (1, 2, 11, 16, 128)
    got = sp.conv(spk._k1_cat, (sp.split(xa, _g(n)), sp.split(xb, _g(n))),
                  w, b, k=2, pad=(1, 1))
    _close(got, want)


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("form", ["offset", "offset_wide", "aligned"])
def test_instance_norm_packed_sharded(form, n, dt):
    gen = torch.Generator().manual_seed(4)
    x = _t(gen, 2, 3, 13, 9, 8, dtype=dt) * 3 + 1
    kw, tw = {}, None
    if form != "aligned":
        tw = 7 if form == "offset_wide" else None
        x = x * pack2d.offset_rim_mask(13, 9, 2, x.dtype, true_w=tw)
        kw = dict(offset_parity=True, true_w=tw)
    scale, bias = _t(gen, 2, dtype=dt), _t(gen, 2, dtype=dt)
    want = pack2d.instance_norm_packed(x, scale, bias, 1e-5, **kw)
    _close(spk._norm_packed(sp.split(x, _g(n)), scale, bias, 1e-5, **kw),
           want)
    # the rim mask of a block is its rows of the whole mask
    _close(spk._mask_offset(sp.split(x + 1, _g(n)), 2, tw=tw),
           spk._mask_offset(x + 1, 2, tw=tw))


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("stride", [1, 2])
def test_unpacked_conv_and_norm_sharded(stride, n, dt):
    gen = torch.Generator().manual_seed(5)
    x = _t(gen, 2, 4, 16, 10, 3, dtype=dt)
    w, b = _t(gen, 3, 3, 3, 3, 5, dtype=dt), _t(gen, 5, dtype=dt)
    st = (1, stride, stride)
    _close(spk._conv_std(sp.split(x, _g(n)), w, b, st),
           spk._conv_std(x, w, b, st))
    s, t = _t(gen, 5, dtype=dt), _t(gen, 5, dtype=dt)
    y = spk._conv_std(x, w, b, st)
    _close(spk._instance_norm(sp.split(y, _g(n)), s, t, 1e-5),
           spk._instance_norm(y, s, t, 1e-5))


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("form", ["auto", "cell4", "legacy", "unpacked"])
def test_sr_head_sharded(params, form, n, dt):
    p = convert.tree_to_torch(params)["params"]
    p = {k: {kk: vv.to(dt) for kk, vv in v.items()} for k, v in p.items()
         if k.startswith("sr_head")}
    w1, b1 = p["sr_head_conv1"]["kernel"], p["sr_head_conv1"]["bias"]
    w2, b2 = p["sr_head_conv2"]["kernel"], p["sr_head_conv2"]["bias"]
    gen = torch.Generator().manual_seed(6)
    layout = "u" if form == "unpacked" else "a"
    f = _t(gen, 2, 2, 12, 8, 8 if layout == "u" else 32, dtype=dt)
    kw = dict(layout=layout, tw=None, w1=w1, b1=b1, w2=w2, b2=b2,
              upscale=4, plane_out=False,
              sr_head_form="auto" if form == "unpacked" else form)
    want = spk._sr_head(f, **kw)
    got = spk._sr_head(sp.split(f, _g(n)), **kw)
    # the head's logits come back as even blocks of the HR H
    assert isinstance(got, sp.HBlocks)
    assert got.starts == sp.partition(want.shape[2], n)
    _close(got, want, tol=4e-6 if form == "legacy" else 1e-6)


def test_partition_and_gather():
    assert sp.partition(161, 2) == [0, 80, 161]
    assert sp.partition(10, 4) == [0, 2, 5, 7, 10]
    x = torch.arange(2 * 1 * 10 * 1 * 1.0).reshape(2, 1, 10, 1, 1)
    h = sp.split(x, _g(3))
    assert h.shape == x.shape and h.sharded and h.starts == [0, 3, 6, 10]
    assert torch.equal(sp.gather(h), x)
    assert torch.equal(sp.rows(h, 2, 8, CPU), x[:, :, 2:8])
    assert torch.equal(sp.gather(sp.reshard(h, [0, 5, 6, 10])), x)


# ------------------------------------------------------ the whole forward

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", [False, "cat"])
@pytest.mark.parametrize("pack", [64, 0])
def test_forward_sharded(params, mode, pack, n):
    p = convert.tree_to_torch(params)
    x = _t(torch.Generator().manual_seed(7), 2, 4, 32, 24, 1)
    kw = dict(pack_max_channels=pack, pallas_conv=mode, upscale=4,
              return_skips=True)
    want = spk.segmodel_apply_packed(SMALL_ARCH, p, x, **kw)
    got = spk.segmodel_apply_packed(SMALL_ARCH, p, sp.split(x, _g(n)), **kw)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        # the logits and the skips come back as even blocks of their H
        assert isinstance(g, sp.HBlocks) and len(g.parts) == n
        assert g.starts == sp.partition(w.shape[2], n)
        _close(g, w, tol=1e-5)
    with pytest.raises(ValueError, match="no spatial form"):
        spk.segmodel_apply_packed(SMALL_ARCH, p, sp.split(x, _g(n)),
                                  pallas_conv="fused")


def test_gradcheck_through_halo_and_norm():
    """fp64: packing conv (offset out) -> rim mask -> offset norm (moment
    sums across blocks) -> leaky -> valid packed conv, over 2 and 3
    blocks; the analytic gradient (autograd through the row copies and
    the sums) matches the numeric one, and the unsharded function's."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1, 1, 8, 4, 1, generator=gen, dtype=torch.float64)
    w = torch.randn(1, 3, 3, 1, 2, generator=gen, dtype=torch.float64)
    w2 = torch.randn(1, 3, 3, 2, 1, generator=gen, dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)

    def fn(n):
        def f(x, w):
            xs = sp.split(x, _g(n)) if n else x
            y = spk._packing(xs, pack2d.pack_conv_weights_from_unpacked(w),
                             None, offset_out=True)
            y = spk._mask_offset(y, 2)
            y = spk._norm_packed(y, None, None, 1e-5, offset_parity=True)
            y = spk._leaky(y, 0.01)
            return sp.gather(spk._packed(y, pack2d.pack_conv_weights(w2),
                                         None))
        return f

    for n in (2, 3):
        assert torch.autograd.gradcheck(fn(n), (x, w))
    want = torch.autograd.grad(fn(0)(x, w).square().sum(), (x, w))
    got = torch.autograd.grad(fn(2)(x, w).square().sum(), (x, w))
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------- the engines

def _port_fn(params):
    tparams = convert.tree_to_torch(params)

    def fn(batch):
        return spk.segmodel_apply_packed(SMALL_ARCH, tparams, batch,
                                         pack_max_channels=64)
    return fn


ENGINES = {  # tests/test_tta_mesh.py's three meshes (n devices, spatial)
    "data8": (8, 1, (6, 24, 24)),
    "spatial4": (4, 4, (6, 32, 24)),
    "data4_spatial2": (8, 2, (6, 32, 24)),
}


@pytest.mark.parametrize("config", list(ENGINES))
def test_engine_matches_jax_sharded(params, config):
    n, spatial, shape = ENGINES[config]
    assert len(jax.devices()) == 8
    vol = np.random.default_rng(0).normal(size=(*shape, 1)).astype(
        np.float32)
    jmodel = JaxSegModel(num_classes=2, upscale=4, arch=SMALL_ARCH)

    def jfn(p, batch):
        return jmodel.apply(p, batch)[0]

    jmesh = jax_make_mesh(n, spatial=spatial)
    jparams = jax.tree.map(jnp.asarray, params)
    with jmesh:
        want = jsw.predict_sliding_window_labels(
            jfn, replicate(jparams, jmesh), vol, PATCH, mirror=True,
            input_dtype=jnp.float32, tta_mesh=jmesh)
    kw = dict(input_dtype=torch.float32)
    logits = tsw.predict_sliding_window_logits(_port_fn(params), vol, PATCH,
                                               device="cpu", **kw)
    single = np.argmax(logits, -1)
    sp.reset_record()
    got = tsw.predict_sliding_window_labels(
        _port_fn(params), vol, PATCH,
        tta_mesh=make_mesh(devices=_g(n), spatial=spatial), **kw)
    assert any(len(r) == spatial for _, r in sp.RECORD) == (spatial > 1)
    _labels_agree(got, want, logits)
    _labels_agree(got, single, logits)


def test_accumulators_sharded_on_the_group(params):
    """The engine keeps the volume and its fp32 accumulators in even H
    blocks over the group (the JAX engine's ``P(None, 'spatial')``): a
    (data 1, spatial 2) mesh whose first device is the CPU and whose
    second is the CPU's other name holds each buffer as two blocks, one on
    each name, as the buffer record shows, and the blocks joined equal the
    single-device engine's logits up to fp32 summation order."""
    vol = np.random.default_rng(1).normal(size=(6, 32, 24, 1)).astype(
        np.float32)
    mesh = make_mesh(devices=[CPU, torch.device("cpu", 1)], spatial=2)
    tsw.reset_buffers()
    logits, weights = tsw._run_sliding_window(
        _port_fn(params), vol, PATCH, 1, 0.5, True, True, 2, torch.float32,
        device=mesh.first, tta_mesh=mesh)
    assert isinstance(logits, sp.HBlocks) and isinstance(weights, sp.HBlocks)
    assert logits.shape == (6, 32, 24, 2) and weights.shape == (6, 32, 24)
    assert logits.group == weights.group == mesh.groups()[0]
    names = [name for name, _, _ in tsw.BUFFERS]
    assert names == ["volume", "logits_x1", "weights", "tile",
                     "tile_logits_x1"]
    for name, starts, devices in tsw.BUFFERS:
        assert devices == ["cpu", "cpu"], name
        assert starts == sp.partition(16 if "tile" in name else 32, 2)
    want, wt = tsw._run_sliding_window(
        _port_fn(params), vol, PATCH, 1, 0.5, True, True, 2, torch.float32,
        device=CPU)
    torch.testing.assert_close(sp.gather(logits), want, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(sp.gather(weights), wt, rtol=0, atol=0)


def test_segmenter_spatial_matches_single_device(params):
    """tests/test_serve.py's case: SMALL_ARCH, bf16, a (data 4, spatial 2)
    mesh against one device, mismatch under 2 % (the moment sums
    reassociate, so bf16 near-ties may flip); the dual path and
    ``segment_many`` over the mesh; the unpacked Segmenter through the
    packed forward's plain path."""
    mesh = make_mesh(devices=_g(8), spatial=2)
    vol = np.random.default_rng(0).normal(size=(6, 24, 24)).astype(
        np.float32)
    for packed in (True, False):
        kw = dict(packed_eval=packed)
        single = Segmenter.from_flax(params, SMALL_ARCH, PATCH,
                                     device="cpu", **kw)
        sharded = Segmenter.from_flax(params, SMALL_ARCH, PATCH, mesh=mesh,
                                      **kw)
        got = sharded.segment(vol)
        assert np.mean(single.segment(vol) != got) < 0.02
        (lr, hr), (wlr, whr) = (sharded.segment(vol, hr=True),
                                single.segment(vol, hr=True))
        assert hr.shape == (24, 24, 24)
        assert np.mean(lr != wlr) < 0.02 and np.mean(hr != whr) < 0.02
        many = sharded.segment_many([vol, vol])
        np.testing.assert_array_equal(many[0], got)
        np.testing.assert_array_equal(many[1], got)


def test_bench_tile_levels_run_sharded():
    """The row record at the bench tile's H (320; D and W cut to 8 and 32
    to fit the CPU), DEFAULT_ARCH, spatial 2, the served forward: every
    conv of the packed stages 0-1, of the decoder's last stages (K1 among
    them) and of the SR head runs on two blocks. A 16-row tile over four
    blocks runs its small levels gathered and splits again above them."""
    p = convert.tree_to_torch(convert.random_flax_params(DEFAULT_ARCH, 0))
    x = torch.randn(1, 8, 320, 32, 1, generator=torch.Generator()
                    .manual_seed(9))
    sp.reset_record()
    with torch.no_grad():
        spk.segmodel_apply_packed(DEFAULT_ARCH, p, sp.split(x, _g(2)),
                                  pack_max_channels=64, pallas_conv="cat",
                                  dual=True, upscale=4)
    rec = list(sp.RECORD)
    assert all(len(rows) == 2 for _, rows in rec), rec
    assert rec[:5] == [("conv_packing", [80, 81]),
                       ("conv_packed_valid", [80, 80]),
                       ("conv_packed_pad10", [80, 80]),
                       ("conv_packing", [40, 40]),
                       ("conv_packed_pad10", [40, 40])]
    assert rec[-4:] == [("pconv_pad11_cat", [80, 81]),
                        ("conv_packed_valid", [80, 80]),
                        ("fused_upsample_conv1", [80, 81]),
                        ("conv_packed_s2_cell4z2", [40, 40])]
    sp.reset_record()
    small = convert.tree_to_torch(convert.random_flax_params(SMALL_ARCH, 0))
    with torch.no_grad():
        spk.segmodel_apply_packed(SMALL_ARCH, small,
                                  sp.split(x[:, :4, :16, :16], _g(4)),
                                  pack_max_channels=64)
    widths = [len(rows) for _, rows in sp.RECORD]
    assert widths[0] == 4 and widths[-1] == 4 and 1 in widths
