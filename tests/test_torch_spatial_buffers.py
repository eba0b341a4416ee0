"""Spatial (H-sharded) serving and stage-2 training kept sharded end to end
(``infer.sliding_window.BUFFERS``, the blocks ``segmodel_apply_packed``
hands back, the block forms of the seg losses, the FLAVR teacher and the
distiller), on the CPU named several times:

  - the engine's buffer record for the LR, dual and ``_many`` engines on
    (spatial 2), (spatial 4), (data 4 x spatial 2) and (spatial 3) over an
    H that does not split evenly: the volume, every accumulator, the label
    maps and the first tile and its logits in S even blocks; the labels
    equal to the single-device engine's outside near-ties (fp32);
  - the labels of JAX's sharded ``predict_sliding_window_labels`` on
    tests/test_tta_mesh.py's three meshes, the port's forward handing its
    logits back as blocks, at test_engine_matches_jax_sharded's rule;
  - the mirror batch read from the volume's blocks against the whole
    tile's, the offset unpack of a block against the whole tensor's, and
    the forward's block outputs (LR, HR in each SR head form, skips)
    against the unsharded forward's;
  - the sharded dice, CE (with and without uncertainty), the distiller's
    terms and the z-score against their whole forms, fp32 within 1e-6;
    ``torch.autograd.gradcheck`` through the ``total``-based dice and CE;
  - the teacher's blocks against ``flavr_teacher_features`` on the whole
    batch, every conv of the encoder in S blocks in ``spatial.RECORD``;
  - the stage-2 step with distillation on a spatial pair: every loss,
    the distiller and the teacher read blocks of H, never a whole field."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.infer import sliding_window as jsw
from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.parallel import make_mesh as jax_make_mesh
from rehrseg_tpu.parallel import replicate
from rehrseg_tpu_torch import losses
from rehrseg_tpu_torch.data.normalize import zscore_batch
from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.models import convert, distiller as dst
from rehrseg_tpu_torch.models import segnet_packed as spk
from rehrseg_tpu_torch.models.distiller import Distiller
from rehrseg_tpu_torch.models.flavr import UNet3D
from rehrseg_tpu_torch.parallel import spatial as sp
from rehrseg_tpu_torch.parallel.mesh import make_mesh
from rehrseg_tpu_torch.train import seg_trainer as st
from tests.test_models import SMALL_ARCH
from tests.test_torch_engine import _labels_agree

torch.set_num_threads(2)

CPU = torch.device("cpu")
PATCH = (4, 16, 16)


def _g(n):
    return [CPU] * n


def _rel_close(got, want, tol=1e-6):
    got, want = sp.gather(got), sp.gather(want)
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def params():
    return convert.random_flax_params(SMALL_ARCH, 3)


def _fn(params, dual=False):
    tparams = convert.tree_to_torch(params)

    def fn(batch):
        return spk.segmodel_apply_packed(
            SMALL_ARCH, tparams, batch, pack_max_channels=64, dual=dual,
            upscale=4)
    return fn


# ------------------------------------------------------- the engine record

MESHES = {  # (devices, spatial, volume (D, H, W))
    "spatial2": (2, 2, (6, 32, 24)),
    "spatial4": (4, 4, (6, 32, 24)),
    "data4_spatial2": (8, 2, (6, 32, 24)),
    "uneven_spatial3": (3, 3, (6, 29, 24)),
}


def _normalized(fn, vol, z, dual_head=None):
    """Single-device normalized logits of head z (the margin reference)."""
    if dual_head is None:
        lg, wt = tsw._run_sliding_window(fn, vol, PATCH, z, 0.5, True, True,
                                         2, torch.float32, device=CPU)
    else:
        lg = tsw._dual_logits(fn, vol, PATCH, 4, 0.5, True, True, 2,
                              torch.float32, CPU)[dual_head]

        def ones(b):
            o = torch.ones(*b.shape[:-1], 1)
            return o, o.repeat_interleave(4, 1)
        _, wt = tsw._run_sliding_window(
            lambda b: ones(b)[dual_head], vol, PATCH, z, 0.5, True, True, 1,
            torch.float32, device=CPU)
    return (lg / wt[..., None]).numpy()


@pytest.mark.parametrize("kind", ["lr", "lr_k5", "dual", "many"])
@pytest.mark.parametrize("config", list(MESHES))
def test_engine_buffers_in_even_blocks(params, config, kind):
    """lr_k5: five tiles a forward, the last forward padded with three
    repeats that add nothing."""
    n, s, shape = MESHES[config]
    mesh = make_mesh(devices=_g(n), spatial=s)
    vols = [np.random.default_rng(seed).normal(size=(*shape, 1)).astype(
        np.float32) for seed in (0, 1)]
    kw = dict(input_dtype=torch.float32, tta_mesh=mesh)
    tsw.reset_buffers()
    if kind.startswith("lr"):
        got = [tsw.predict_sliding_window_labels(
            _fn(params), vols[0], PATCH,
            tiles_per_step=5 if kind == "lr_k5" else 1, **kw)]
        heads = [(1, None)]
    elif kind == "dual":
        got = list(tsw.predict_sliding_window_dual_labels(
            _fn(params, True), vols[0], PATCH, slice_separation=4, **kw))
        heads = [(1, 0), (4, 1)]
    else:
        got = tsw.predict_sliding_window_labels_many(_fn(params), vols,
                                                     PATCH, **kw)
        heads = [(1, None)]
    per_volume = (["volume"] + [f"logits_x{z}" for z, _ in heads]
                  + ["tile"] + [f"tile_logits_x{z}" for z, _ in heads])
    labels = ["labels"] * len(heads)
    names = [name for name, _, _ in tsw.BUFFERS]
    if kind == "many":
        assert names == (per_volume + labels) * 2
    else:
        assert names == per_volume + labels
    for name, starts, devices in tsw.BUFFERS:
        # every buffer in S even blocks, none whole on one device
        assert len(devices) == s and len(starts) == s + 1, name
        h = PATCH[1] if name.startswith("tile") else shape[1]
        assert starts == sp.partition(h, s), (name, starts)
    cases = ([(vols[k], got[k], 1, None) for k in range(2)]
             if kind == "many" else
             [(vols[0], lab, z, head) for lab, (z, head) in zip(got, heads)])
    for vol, lab, z, head in cases:
        assert lab.shape == (shape[0] * z, *shape[1:])
        ref = _normalized(_fn(params, head is not None), vol, z, head)
        _labels_agree(lab, np.argmax(ref, -1), ref)


ENGINES = {  # tests/test_tta_mesh.py's three meshes (n devices, spatial)
    "data8": (8, 1, (6, 24, 24)),
    "spatial4": (4, 4, (6, 32, 24)),
    "data4_spatial2": (8, 2, (6, 32, 24)),
}


@pytest.mark.parametrize("config", list(ENGINES))
def test_block_engine_matches_jax_sharded(params, config):
    n, spatial, shape = ENGINES[config]
    vol = np.random.default_rng(0).normal(size=(*shape, 1)).astype(
        np.float32)
    jmodel = JaxSegModel(num_classes=2, upscale=4, arch=SMALL_ARCH)
    jmesh = jax_make_mesh(n, spatial=spatial)
    with jmesh:
        want = jsw.predict_sliding_window_labels(
            lambda p, b: jmodel.apply(p, b)[0],
            replicate(jax.tree.map(jnp.asarray, params), jmesh), vol, PATCH,
            mirror=True, input_dtype=jnp.float32, tta_mesh=jmesh)
    kw = dict(input_dtype=torch.float32)
    logits = tsw.predict_sliding_window_logits(_fn(params), vol, PATCH,
                                               device="cpu", **kw)
    got = tsw.predict_sliding_window_labels(
        _fn(params), vol, PATCH,
        tta_mesh=make_mesh(devices=_g(n), spatial=spatial), **kw)
    _labels_agree(got, want, logits)


# ------------------------------------------------ flips, unpack, outputs

@pytest.mark.parametrize("n", [2, 3, 4])
def test_mirror_blocks_match_whole_tiles(n):
    """Each data row's tile blocks, read from the volume's blocks with the
    H flips reversing blocks and rows, joined equal the whole mirror batch
    (three blocks of a 13-row tile are uneven: the flip reshards)."""
    gen = torch.Generator().manual_seed(0)
    vol = torch.randn(7, 37, 11, 1, generator=gen)
    blocks = sp.split(vol, _g(n), dim=1)
    combos = tsw._flip_axes_combinations(3)
    tiles = [(1, 5, 2), (3, 20, 0)]
    patch = (4, 13, 9)
    groups = [_g(n), _g(n)]
    got = tsw._mirror_blocks(blocks, tiles, combos, patch, groups)
    want = torch.cat([tsw._mirror_batch(vol[sx:sx + 4, sy:sy + 13,
                                            sz:sz + 9], combos)
                      for sx, sy, sz in tiles]).chunk(2)
    for g, w in zip(got, want):
        assert g.starts == sp.partition(13, n)
        assert torch.equal(sp.gather(g), w)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("hp", [9, 10, 13])
def test_offset_unpack_of_blocks(hp, n):
    """An offset tensor's blocks unpack alone (each unpacked row from one
    cell row) and land on the even blocks of the unpacked H."""
    x = torch.randn(2, 3, hp, 7, 8, generator=torch.Generator()
                    .manual_seed(hp))
    for tw in (None, 6):
        want = spk._unpack(x, "o", tw)
        got = spk._unpack(sp.split(x, _g(n)), "o", tw)
        assert got.starts == sp.partition(want.shape[2], n)
        assert torch.equal(sp.gather(got), want)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("form", ["auto", "cell4", "legacy", "unpacked"])
def test_forward_blocks_in_each_head_form(params, form, n):
    """The forward of an H-split batch hands its LR and HR logits (in each
    SR head form) and its skips back as HBlocks on the even blocks of
    their H, joined within 1e-5 of the unsharded forward's; plane_out has
    no H-sharded form."""
    p = convert.tree_to_torch(params)
    x = torch.randn(2, 4, 32, 24, 1, generator=torch.Generator()
                    .manual_seed(7))
    kw = dict(pack_max_channels=0 if form == "unpacked" else 64, upscale=4,
              return_skips=True,
              sr_head_form="auto" if form == "unpacked" else form)
    want = spk.segmodel_apply_packed(SMALL_ARCH, p, x, **kw)
    got = spk.segmodel_apply_packed(SMALL_ARCH, p, sp.split(x, _g(n)),
                                    **kw)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert isinstance(g, sp.HBlocks) and len(g.parts) == n
        assert g.starts == sp.partition(w.shape[2], n)
        _rel_close(g, w, tol=1e-5)
    with pytest.raises(ValueError, match="no H-sharded form"):
        spk.segmodel_apply_packed(SMALL_ARCH, p, sp.split(x, _g(n)),
                                  plane_out=True)


# ------------------------------------------------------------ the losses

def _seg_case(seed, d=4, h=13):
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(2, d, h, 6, 2, generator=gen) * 3
    target = (torch.randn(2, d, h, 6, 1, generator=gen) > 0).float()
    unc = torch.rand(2, d, h, 6, 1, generator=gen) + 0.5
    return logits, target, unc


LOSSES = {
    "dice": lambda lg, tg, u: losses.soft_dice_loss(lg, tg),
    "dice_onehot": lambda lg, tg, u: losses.soft_dice_loss(
        lg, sp.local(lambda t: torch.cat([1 - t, t], -1), tg)),
    "ce": lambda lg, tg, u: losses.robust_cross_entropy(lg, tg),
    "ce_unc": lambda lg, tg, u: losses.robust_cross_entropy(lg, tg, u),
    "dc_and_ce_unc": lambda lg, tg, u: losses.dc_and_weighted_ce(lg, tg, u),
}


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_seg_losses_on_blocks(loss, n):
    lg, tg, unc = _seg_case(n)
    want = LOSSES[loss](lg, tg, unc)
    got = LOSSES[loss](*(sp.split(t, _g(n)) for t in (lg, tg, unc)))
    assert got.shape == () and float(got) == pytest.approx(
        float(want), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("loss", ["dice", "ce_unc"])
def test_gradcheck_through_loss_totals(loss):
    """fp64: the loss of three uneven blocks against the whole tensor's,
    gradients by autograd through ``spatial.total_of`` checked against
    numeric ones and against the whole loss's gradients."""
    lg, tg, unc = (t.double() for t in _seg_case(5, d=2, h=7))
    lg = (lg[:1, :, :, :3] * 0.5).requires_grad_(True)
    tg, unc = tg[:1, :, :, :3], unc[:1, :, :, :3]
    fn = LOSSES[loss]

    def sharded(x):
        return fn(*(sp.split(t, _g(3)) for t in (x, tg, unc)))
    assert torch.autograd.gradcheck(sharded, (lg,))
    got, = torch.autograd.grad(sharded(lg), lg)
    want, = torch.autograd.grad(fn(lg, tg, unc), lg)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("term", ["structure", "cosine", "l1", "all"])
def test_distiller_on_blocks(term, n):
    """The distiller's terms of two 16-row maps in n blocks against the
    whole maps' (the pooled cells of the structural term span blocks for
    n = 3 and 4), loss and gradients within 1e-6."""
    torch.manual_seed(0)
    lam = dict(structure=(0.0, 0.0, 1.0), cosine=(0.0, 1.0, 0.0),
               l1=(1.0, 0.0, 0.0), all=(0.5, 1.0, 1.0))[term]
    dist = Distiller(8, 6, *lam)
    gen = torch.Generator().manual_seed(n)
    fs = torch.randn(2, 3, 16, 10, 8, generator=gen).requires_grad_(True)
    ft = torch.randn(2, 3, 16, 10, 6, generator=gen)
    leaves = [fs, *dist.parameters()]
    want = dist(fs, ft)
    gw = torch.autograd.grad(want, leaves, allow_unused=True)
    got = dist(sp.split(fs, _g(n)), sp.split(ft, _g(n)))
    gg = torch.autograd.grad(got, leaves, allow_unused=True)
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    for a, b in zip(gg, gw):
        # the projection takes no gradient from the structural term
        assert (a is None) == (b is None)
        if b is not None:
            _rel_close(a, b, 1e-5)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("h", [16, 17])
def test_pooled_map_of_blocks(h, n):
    """The pool to about 2x2 cells of a map in n blocks equals the whole
    map's (cells split across blocks; an odd H gives a third cell row)."""
    x = torch.randn(2, 3, h, 9, 4, generator=torch.Generator()
                    .manual_seed(h))
    kh, kw = h // 2, 4
    want = dst._maxpool2d_ceil(dst._fold(x), kh, kw)
    assert torch.equal(dst._maxpool_blocks(sp.split(x, _g(n)), kh, kw), want)


@pytest.mark.parametrize("n", [2, 3])
def test_zscore_batch_on_blocks(n):
    x = torch.randn(3, 4, 11, 5, 2, generator=torch.Generator()
                    .manual_seed(n)) * 4 + 2
    _rel_close(zscore_batch(sp.split(x, _g(n))), zscore_batch(x), 1e-6)


# ----------------------------------------------------------- the teacher

@pytest.fixture(scope="module")
def teacher():
    flavr = UNet3D(2, 4, 4)
    convert.load_flax_flavr_params(flavr, convert.random_flavr_params(1),
                                   False)
    return flavr.eval().requires_grad_(False)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunk", [None, 3])
def test_teacher_on_blocks(teacher, n, chunk):
    """flavr_teacher_features of an H-split batch: HBlocks on the even
    blocks of H/2, within 1e-5 of the whole batch's features; every conv
    of the encoder (the stem and each layer's) ran in n blocks."""
    gen = torch.Generator().manual_seed(n)
    img = torch.randn(2, 4, 32, 32, 1, generator=gen)
    lab = (torch.randn(2, 4, 32, 32, 1, generator=gen) > 0).float()
    want = st.flavr_teacher_features(teacher, img, lab, window_chunk=chunk)
    sp.reset_record()
    got = st.flavr_teacher_features(teacher, sp.split(img, _g(n)),
                                    sp.split(lab, _g(n)), window_chunk=chunk)
    assert isinstance(got, sp.HBlocks) and got.starts == sp.partition(16, n)
    _rel_close(got, want, 1e-5)
    tags = [(tag, len(rows)) for tag, rows in sp.RECORD]
    assert {t for t, _ in tags} == {"flavr_stem"} | {
        f"flavr_layer{i}_{c}" for i in range(1, 5)
        for c in ("conv1", "conv2", "downsample") if (i, c) != (1, "downsample")}
    assert all(k == n for _, k in tags), tags


# -------------------------------------------------------------- the step

def test_step_reads_blocks_only(monkeypatch):
    """The distilled stage-2 step on a spatial pair: every call of the
    seg losses' and the distiller's per-block sums sees half of its H
    (labels, uncertainty, logits, skips, teacher features: none gathered),
    and the teacher's convs ran in two blocks."""
    seen = []

    def spy(name, fn):
        def wrapped(*ts, **kw):
            seen.append((name, [t.shape[2] for t in ts
                                if isinstance(t, torch.Tensor)]))
            return fn(*ts, **kw)
        return wrapped
    monkeypatch.setattr(losses, "_dice_sums",
                        spy("dice", losses._dice_sums))
    monkeypatch.setattr(losses, "_nll_sum", spy("ce", losses._nll_sum))
    monkeypatch.setattr(dst, "_cosine_sums",
                        spy("cosine", dst._cosine_sums))
    seg_np = convert.random_flax_params(SMALL_ARCH, 0)
    from tests.test_torch_spatial_train import _batch, _port_step
    from rehrseg_tpu_torch.parallel import multihost as mh

    _, state, step = _port_step([CPU, CPU], True, seg_np)
    batch = mh.place_global(st.SegBatch(*(torch.from_numpy(a)
                                          for a in _batch(b=2))), [CPU, CPU])
    sp.reset_record()
    st.STEP_BUFFERS.clear()
    _, m = step(state, batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert [name for name, _, _ in st.STEP_BUFFERS] == [
        "img", "label_lr", "label_hr", "uncertainty_lr", "logits_lr",
        "logits_hr", "skip", "teacher_features"]
    for name, starts, devices in st.STEP_BUFFERS:
        h = 16 if name in ("skip", "teacher_features") else 32
        assert starts == sp.partition(h, 2) and len(devices) == 2, name
    # the HR dice (the LR one is off under uncertainty), the LR and HR CE
    # and the distiller's cosine term, each on both blocks
    assert {name for name, _ in seen} == {"dice", "ce", "cosine"}
    for name, hs in seen:
        # 32 rows split in two (16 at the skips' half resolution)
        assert hs and set(hs) <= {16, 8}, (name, hs)
    flavr = [rows for tag, rows in sp.RECORD if tag.startswith("flavr_")]
    assert flavr and all(len(r) == 2 for r in flavr)
