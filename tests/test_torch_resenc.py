"""The port's residual-encoder SegModel (nnU-Net's ResidualEncoderUNet with
BasicBlockD, REHRSeg's SR head) against the plain reference
``tests/resenc_reference.py`` on seeded random weights, on the CPU: the
unpacked module, the packed forward (pallas_conv False and "cat", fp32
and bf16), the aligned Segmenter, the state-dict keys, ``arch_from_plans``
and ``arch_override``, and the modes the residual encoder refuses.

Two small archs cover every kind of skip: ``ARCH_RES`` (features 32-64,
so K1 engages at the 128-lane stage-0 concat) has identity skips, pool-only
skips (stages 1 and 3, (1, 2, 2)) and a pool + projection skip (stage 2,
(2, 2, 2), 32 -> 64); ``ARCH_PROJ`` (features 8-32) has a projection-only
skip (stage 1, stride 1, 8 -> 16)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from h100bench.reference import sliding_window as ref_sw
from rehrseg_tpu_torch import config as tconfig
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel, arch_from_plans
from rehrseg_tpu_torch.models.segnet_packed import segmodel_apply_packed
from rehrseg_tpu_torch.ops import pconv
from rehrseg_tpu_torch.pipeline import seg_arch_and_patches
from rehrseg_tpu_torch.serve import Segmenter
from rehrseg_tpu_torch.train.precision import policy
from rehrseg_tpu_torch.utils import timer
from tests.resenc_reference import ResEncSegModel

torch.set_num_threads(2)

# fp32: test_torch_packed.py's tolerance (summation order of the packed
# convs and norms). bf16: the relative norm of the error, within the port's
# bf16 output tolerance for packed convs (0.04, JAX's pconv tests and
# test_torch_fused.py); the readings at ARCH_RES are 0.016-0.020.
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 0.04

_K = ((1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
ARCH_RES = dict(
    n_stages=4, features_per_stage=(32, 32, 64, 64), kernel_sizes=_K,
    strides=((1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
    n_blocks_per_stage=(1, 2, 2, 2), n_conv_per_stage_decoder=(1, 1, 1),
    conv_bias=True, norm_eps=1e-5, norm_affine=True, nonlin_slope=0.01)
ARCH_PROJ = dict(ARCH_RES, features_per_stage=(8, 16, 32, 32),
                 strides=((1, 1, 1), (1, 1, 1), (2, 2, 2), (1, 2, 2)))
ARCHS = {"res": ARCH_RES, "proj": ARCH_PROJ}
SHAPE = (2, 8, 32, 48, 1)
PATCH = (8, 32, 48)


def _setup(arch, seed=0, shape=SHAPE):
    params = convert.random_flax_params(arch, seed)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    ref = ResEncSegModel(arch)
    ref.load_state_dict(convert.state_dict_from_flax(params, arch))
    return params, torch.from_numpy(x), ref.eval()


def _module(arch, params):
    model = SegModel(2, 4, arch=arch)
    convert.load_flax_params(model, params)
    return model.eval()


@pytest.fixture
def k1_spy(monkeypatch):
    """Per call of the port's K1 wrapper, whether it covered the shape."""
    engaged = []
    orig = pconv.pconv_pad11_cat

    def spy(*a, **k):
        y = orig(*a, **k)
        engaged.append(y is not None)
        return y

    monkeypatch.setattr(pconv, "pconv_pad11_cat", spy)
    return engaged


def test_state_dict_keys_are_the_librarys():
    """ResidualEncoderUNet's keys: the stem, conv1 / conv2 of each block,
    the projection at ``skip.1`` after a pool and at ``skip.0`` without
    one, bias-free; the decoder's as the plain model's."""
    for arch in ARCHS.values():
        keys = set(SegModel(2, 4, arch=arch).state_dict())
        assert keys == set(ResEncSegModel(arch).state_dict())
        assert keys == set(convert.segmodel_mapping(arch))
    keys = set(SegModel(2, 4, arch=ARCH_RES).state_dict())
    assert {"encoder.stem.convs.0.conv.weight",
            "encoder.stem.convs.0.norm.weight",
            "encoder.stages.1.blocks.1.conv1.conv.bias",
            "encoder.stages.1.blocks.1.conv2.norm.bias",
            "encoder.stages.2.blocks.0.skip.1.conv.weight",
            "encoder.stages.2.blocks.0.skip.1.norm.weight",
            "decoder.stages.0.convs.0.conv.weight",
            "decoder.transpconvs.2.weight", "decoder.seg_layers.2.weight",
            "sr_head.2.bias"} <= keys
    assert not any(".skip." in k for k in keys
                   if k.startswith(("encoder.stages.1.", "encoder.stages.3.",
                                    "encoder.stages.0.")))
    assert "encoder.stages.2.blocks.0.skip.1.conv.bias" not in keys
    proj = set(SegModel(2, 4, arch=ARCH_PROJ).state_dict())
    assert "encoder.stages.1.blocks.0.skip.0.conv.weight" in proj
    assert not any(k.startswith("encoder.stages.0.convs") for k in proj)
    shapes = convert.flax_param_shapes(ARCH_RES)["params"]["encoder"]
    assert shapes["stage_2"]["block_0"]["skip"]["conv"] == {
        "kernel": (1, 1, 1, 32, 64)}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_module_matches_reference(name):
    arch = ARCHS[name]
    params, x, ref = _setup(arch)
    with torch.no_grad():
        got, want = _module(arch, params)(x), ref(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("pack_max", [64, 0])
@pytest.mark.parametrize("pallas_conv", [False, "cat"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_packed_matches_reference(k1_spy, name, pallas_conv, pack_max):
    """The packed forward (the served pack_max_channels=64, and 0: every
    block unpacked) in fp32, both heads; K1 takes the stage-0 concat of
    ARCH_RES under "cat" when stage 0 is packed."""
    arch = ARCHS[name]
    params, x, ref = _setup(arch)
    with torch.no_grad():
        lr, hr = segmodel_apply_packed(
            arch, convert.tree_to_torch(params), x, dual=True, upscale=4,
            pack_max_channels=pack_max, pallas_conv=pallas_conv)
        r_lr, r_hr = ref(x)
    torch.testing.assert_close(lr, r_lr, **TOL)
    torch.testing.assert_close(hr, r_hr, **TOL)
    k1 = bool(pallas_conv) and pack_max and name == "res"
    assert k1_spy == ([True] if k1 else [])


def test_packed_plane_out_matches_reference():
    params, x, ref = _setup(ARCH_RES)
    with torch.no_grad():
        lr, hr = segmodel_apply_packed(
            ARCH_RES, convert.tree_to_torch(params), x, dual=True,
            upscale=4, pack_max_channels=64, plane_out=True,
            pallas_conv="cat")
        r_lr, r_hr = ref(x)
    assert lr.shape == (2, 2, 8, 32, 48) and hr.shape == (2, 2, 32, 32, 48)
    torch.testing.assert_close(lr, torch.movedim(r_lr, -1, 1), **TOL)
    torch.testing.assert_close(hr, torch.movedim(r_hr, -1, 1), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_bf16_within_tolerance(seed):
    """The served precision: bf16 params and input, "cat"."""
    params, x, ref = _setup(ARCH_RES, seed)
    tparams = policy("bf16").cast_compute(convert.tree_to_torch(params))
    with torch.no_grad():
        got = segmodel_apply_packed(
            ARCH_RES, tparams, x.to(torch.bfloat16), dual=True, upscale=4,
            pack_max_channels=64, pallas_conv="cat")
        want = ref(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).norm() / w.norm())
        assert err < BF16_REL, err


def test_packed_return_skips_match_reference():
    """The distillation interface: the encoder's skips, unpacked."""
    params, x, ref = _setup(ARCH_RES)
    with torch.no_grad():
        _, _, skips = segmodel_apply_packed(
            ARCH_RES, convert.tree_to_torch(params), x, upscale=4,
            pack_max_channels=64, return_skips=True)
        want = ref.encoder(x.permute(0, 4, 1, 2, 3))
    assert len(skips) == len(want) == ARCH_RES["n_stages"]
    for g, w in zip(skips, want):
        torch.testing.assert_close(g, w.permute(0, 2, 3, 4, 1), **TOL)


def _volume(shape, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(3, 4, 4))
    idx = [np.linspace(0, c - 1, n).round().astype(int)
           for c, n in zip(coarse.shape, shape)]
    smooth = coarse[np.ix_(*idx)]
    return (100 + 30 * smooth + 10 * rng.normal(size=shape)).astype(
        np.float32)


def test_segmenter_aligned_dual_agrees_with_reference():
    """``Segmenter(tile_grid="aligned").segment(vol, hr=True)`` in fp32
    against the plain sliding window (h100bench's reference: nnU-Net's
    rule, the aligned grid) over the reference model: labels equal but
    for near-tie voxels, at most 1e-3 of them (test_torch_serve.py's
    rule). The engine uploads the volume in bf16 (its ``input_dtype``),
    so the reference's tiles are rounded through bf16 too; without that
    the widest gap is 0.009, the plain model's alike."""
    params, _, ref = _setup(ARCH_RES)
    seg = Segmenter(model=_module(ARCH_RES, params), patch_size=PATCH,
                    tile_grid="aligned", device="cpu",
                    compute_dtype=torch.float32, pallas_conv="cat")
    vol = _volume((10, 44, 48), 3)
    before = timer.counters().get("serve.aligned_fallbacks", 0)
    lr, hr = seg.segment(vol, hr=True)
    assert timer.counters().get("serve.aligned_fallbacks", 0) == before
    r_lr, r_hr = ref_sw.logits(
        lambda x, hr: ref(x.to(torch.bfloat16).float(), hr=hr), vol, PATCH,
        grid="aligned", hr=True)
    for got, want in ((lr, r_lr), (hr, r_hr)):
        want = want.argmax(0).to(torch.uint8).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.mean(got != want) <= 1e-3, np.mean(got != want)


RESENC_PLANS = {"configurations": {"3d_fullres": {
    "patch_size": [8, 32, 48],
    "architecture": {
        "network_class_name": "dynamic_network_architectures.architectures."
                              "unet.ResidualEncoderUNet",
        "arch_kwargs": {
            "n_stages": 4, "features_per_stage": [32, 32, 64, 64],
            "conv_op": "torch.nn.modules.conv.Conv3d",
            "kernel_sizes": [list(k) for k in _K],
            "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [1, 2, 2]],
            "n_blocks_per_stage": [1, 2, 2, 2],
            "n_conv_per_stage_decoder": [1, 1, 1], "conv_bias": True,
            "norm_op": "torch.nn.modules.instancenorm.InstanceNorm3d",
            "norm_op_kwargs": {"eps": 1e-05, "affine": True},
            "dropout_op": None, "dropout_op_kwargs": None,
            "nonlin": "torch.nn.LeakyReLU",
            "nonlin_kwargs": {"inplace": True}}}}}}


def _plans(net=None, **ak):
    plans = json.loads(json.dumps(RESENC_PLANS))
    arch = plans["configurations"]["3d_fullres"]["architecture"]
    arch["arch_kwargs"].update(ak)
    if net is not None:
        arch["network_class_name"] = net
    return plans


def test_arch_from_plans_reads_resenc():
    arch, patch = arch_from_plans(_plans())
    assert arch == ARCH_RES and patch == [8, 32, 48]
    per_stage, _ = arch_from_plans(_plans(n_blocks_per_stage=2))
    assert per_stage["n_blocks_per_stage"] == (2, 2, 2, 2)


@pytest.mark.parametrize("net,ak", [
    ("dynamic_network_architectures.architectures.unet.ResidualUNet", {}),
    ("my.Net", {}),
    ("dynamic_network_architectures.architectures.unet.ResidualEncoderUNet",
     {"block": "BottleneckD"}),
    ("dynamic_network_architectures.architectures.unet.ResidualEncoderUNet",
     {"squeeze_excitation": True}),
], ids=["residual_unet", "unknown", "bottleneck", "squeeze_excitation"])
def test_arch_from_plans_refuses_what_it_cannot_build(net, ak):
    with pytest.raises(ValueError):
        arch_from_plans(_plans(net, **ak))


def test_an_arch_names_one_encoder():
    with pytest.raises(ValueError, match="exactly one"):
        SegModel(2, 4, arch=dict(ARCH_RES, n_conv_per_stage=(2,) * 4))
    plain = {k: v for k, v in ARCH_RES.items() if k != "n_blocks_per_stage"}
    with pytest.raises(ValueError, match="exactly one"):
        SegModel(2, 4, arch=plain)


def _cfg(tmp_path, extra=None):
    seg_path = tmp_path / "nnUNet_results" / "Dataset001" / "trainer"
    seg_path.mkdir(parents=True)
    (seg_path / "plans.json").write_text(json.dumps(RESENC_PLANS))
    cfg = {"seg_path": str(seg_path)}
    if extra is not None:
        cfg["arch_override"] = extra
        cfg["patch_size_zyx"] = [8, 32, 48]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return tconfig.load_config(str(path))


@pytest.mark.parametrize("source", ["plans", "arch_override"])
def test_pipeline_builds_and_serves_resenc(tmp_path, source):
    """A ResEnc plans.json (or the same arch as ``arch_override``) through
    ``seg_arch_and_patches`` -> SegModel -> ``Segmenter.segment(hr=True)``
    on the aligned grid."""
    override = None
    if source == "arch_override":
        override = json.loads(json.dumps(ARCH_RES))
    arch, patch_zyx, _, _ = seg_arch_and_patches(_cfg(tmp_path, override))
    assert arch == ARCH_RES and patch_zyx == [8, 32, 48]
    model = SegModel(2, 4, arch=arch)
    convert.load_flax_params(model, convert.random_flax_params(arch, 4))
    seg = Segmenter(model=model, patch_size=patch_zyx, tile_grid="aligned",
                    device="cpu", compute_dtype=torch.float32)
    lr, hr = seg.segment(_volume((9, 40, 48), 5), hr=True)
    assert lr.shape == (9, 40, 48) and hr.shape == (36, 40, 48)
    assert lr.dtype == hr.dtype == np.uint8


@pytest.mark.parametrize("kw,match", [
    (dict(pallas_conv=True), "pallas_conv=True"),
    (dict(pallas_conv="fused"), "pallas_conv='fused'"),
    (dict(remat="hires"), "remat='hires'"),
    (dict(remat=True), "remat=True"),
], ids=["pallas_all", "fused", "remat_hires", "remat_all"])
def test_residual_refuses_unimplemented_modes(kw, match):
    params, x, _ = _setup(ARCH_RES)
    with pytest.raises(ValueError, match=match):
        segmodel_apply_packed(ARCH_RES, convert.tree_to_torch(params), x,
                              pack_max_channels=64, **kw)


def test_residual_refuses_an_h_sharded_input():
    from rehrseg_tpu_torch.parallel import spatial as sp

    params, x, _ = _setup(ARCH_RES)
    blocks = sp.HBlocks([x[:, :, :16], x[:, :, 16:]], [0, 16, 32],
                        [torch.device("cpu")] * 2, 2)
    with pytest.raises(ValueError, match="HBlocks"):
        segmodel_apply_packed(ARCH_RES, convert.tree_to_torch(params),
                              blocks, pack_max_channels=64)
