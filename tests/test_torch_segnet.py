"""The port's weight bridge and unpacked SegModel against the JAX package:
the same flax params (made with numpy from a seed) through flax
``SegModel.apply`` and through the bridged ``nn.Module``, fp32, on the
CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rehrseg_tpu.models import SegModel as JaxSegModel
from rehrseg_tpu.models.segnet import (DEFAULT_ARCH as JAX_DEFAULT_ARCH,
                                       arch_from_plans as jax_arch_from_plans)
from rehrseg_tpu.ops.bspline import (
    trilinear_upsample_matrix as jax_upsample_matrix)
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import (DEFAULT_ARCH, SegModel,
                                             arch_from_plans)
from rehrseg_tpu_torch.ops.bspline import (trilinear_upsample_matrix,
                                           upsample_axis_linear)
from tests.test_packed_segmodel import ARCH_SMALL

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


def _params(arch, seed=0, num_classes=2):
    """Flax-layout params made with numpy from a seed (no flax init: the
    bridge's own shape tree is checked against flax separately)."""
    return convert.random_flax_params(arch, seed, num_classes=num_classes)


@pytest.mark.parametrize("arch", [ARCH_SMALL, DEFAULT_ARCH],
                         ids=["small", "default"])
def test_param_shapes_match_flax_init(arch):
    model = JaxSegModel(num_classes=2, upscale=4, arch=dict(arch))
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 8, 32, 32, 1)))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert want == convert.flax_param_shapes(arch)


def test_default_arch_matches_jax():
    assert DEFAULT_ARCH == JAX_DEFAULT_ARCH


def test_bridge_round_trip_is_exact():
    """flax -> state dict -> module -> flax-layout views gives back the
    same numbers (the layouts are pure permutations)."""
    params = _params(ARCH_SMALL, seed=3)
    model = SegModel(2, 4, arch=ARCH_SMALL)
    convert.load_flax_params(model, params)
    back = convert.flax_tree_from_module(model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.detach().numpy(), back)))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_bridge_keys_are_the_reference_torch_names():
    """The module's state-dict keys are the nnUNet / reference keys of
    rehrseg_tpu.train.torch_import.segmodel_mapping (attribute form)."""
    from rehrseg_tpu.train.torch_import import segmodel_mapping
    jax_keys = {k for k in segmodel_mapping(DEFAULT_ARCH)
                if ".all_modules." not in k}
    n = DEFAULT_ARCH["n_stages"]
    # the JAX mapping lists a seg layer per decoder stage; the model only
    # has the last one (no deep supervision)
    jax_keys = {k for k in jax_keys if not k.startswith("decoder.seg_layers")
                or k.startswith(f"decoder.seg_layers.{n - 2}.")}
    assert set(SegModel(2, 4).state_dict()) == jax_keys


@pytest.mark.parametrize("arch,shape", [
    (ARCH_SMALL, (2, 8, 32, 48, 1)),
    (DEFAULT_ARCH, (1, 8, 32, 32, 1)),
], ids=["small", "default_full_width"])
def test_segmodel_matches_flax(arch, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    params = _params(arch)
    jm = JaxSegModel(num_classes=2, upscale=4, arch=dict(arch))
    ref_lr, ref_hr, ref_skips = jax.jit(
        lambda p, v: jm.apply(p, v, return_intermediate_feature=True))(
            params, jnp.asarray(x))

    model = SegModel(2, 4, arch=arch)
    convert.load_flax_params(model, params)
    with torch.no_grad():
        lr, hr, skips = model(torch.from_numpy(x),
                              return_intermediate_feature=True)
    np.testing.assert_allclose(lr.numpy(), np.asarray(ref_lr), **TOL)
    np.testing.assert_allclose(hr.numpy(), np.asarray(ref_hr), **TOL)
    for got, want in zip(skips, ref_skips):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,scale,align", [(4, 4, True), (1, 4, True),
                                           (5, 2, False)])
def test_upsample_matrix_matches_jax(n, scale, align):
    np.testing.assert_array_equal(trilinear_upsample_matrix(n, scale, align),
                                  jax_upsample_matrix(n, scale, align))


def test_upsample_axis_linear_matches_matrix():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 5, 4)).astype(np.float32))
    got = upsample_axis_linear(x, 4, axis=1)
    want = np.einsum("bdhw,md->bmhw", x.numpy(),
                     jax_upsample_matrix(3, 4, True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_arch_from_plans_matches_jax():
    plans = {"configurations": {"3d_fullres": {
        "patch_size": [16, 320, 384],
        "architecture": {"arch_kwargs": {
            "n_stages": 6,
            "features_per_stage": [32, 64, 128, 256, 320, 320],
            "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
            "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2],
                        [2, 2, 2], [1, 2, 2]],
            "n_conv_per_stage": 2, "n_conv_per_stage_decoder": 2,
            "conv_bias": True, "norm_op_kwargs": {"eps": 1e-5,
                                                  "affine": True},
            "nonlin_kwargs": {"negative_slope": 0.01}}}}}}
    assert arch_from_plans(plans) == jax_arch_from_plans(plans)
    assert arch_from_plans(plans)[0] == DEFAULT_ARCH
