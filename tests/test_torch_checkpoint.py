"""The port's torch checkpoints: roundtrip of params, optimizer state and
step; latest-step resume that ignores tags and interrupted saves; and
serving from a checkpoint whose params came from a JAX orbax checkpoint,
against the JAX package serving that checkpoint."""

import os

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from rehrseg_tpu.serve import (
    load_segmenter_from_checkpoint as jax_load_segmenter)
from rehrseg_tpu.train import TrainState
from rehrseg_tpu.train import checkpoint as jckpt
from rehrseg_tpu_torch.models import convert
from rehrseg_tpu_torch.models.segnet import SegModel
from rehrseg_tpu_torch.serve import load_segmenter_from_checkpoint
from rehrseg_tpu_torch.train import checkpoint as ckpt
from tests.test_aligned_engine import _blob_volume
from tests.test_models import SMALL_ARCH

torch.set_num_threads(2)

PATCH = (4, 16, 16)


def _model_and_opt(seed):
    torch.manual_seed(seed)
    model = SegModel(2, 4, arch=SMALL_ARCH)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    return model, opt


def _train_step(model, opt):
    x = torch.randn(1, *PATCH, 1)
    lr, hr = model(x)
    (lr.square().mean() + hr.square().mean()).backward()
    opt.step()
    opt.zero_grad()


def test_roundtrip_params_optimizer_step(tmp_path):
    model, opt = _model_and_opt(0)
    _train_step(model, opt)
    d = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(d, model, opt, step=7)
    assert path == os.path.join(os.path.abspath(d), "7")
    assert sorted(os.listdir(path)) == ["state.pt"]
    # everything it holds loads without unpickling code
    raw = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert raw["step"] == 7

    model2, opt2 = _model_and_opt(1)
    assert ckpt.restore_checkpoint(d, model2, opt2) == 7
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i in s1["state"]:
        for key in s1["state"][i]:
            torch.testing.assert_close(s1["state"][i][key],
                                       s2["state"][i][key], rtol=0, atol=0)
    # training resumes identically from the restored state
    torch.manual_seed(5)
    _train_step(model, opt)
    torch.manual_seed(5)
    _train_step(model2, opt2)
    for a, b in zip(model.parameters(), model2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_latest_step_ignores_tags_and_interrupted_saves(tmp_path):
    d = tmp_path / "ck"
    assert ckpt.latest_step(str(d)) is None
    assert not ckpt.has_checkpoint(str(d))
    sd = {"w": torch.arange(3.0)}
    for step in (2, 10, 4):
        ckpt.save_checkpoint(str(d), sd, step=step)
    ckpt.save_checkpoint(str(d), {"w": torch.ones(3)}, step=10, tag="best")
    # a save killed after its temporary file: step 12 holds only that
    (d / "12").mkdir()
    (d / "12" / "state.pt.tmp").write_bytes(b"partial")
    assert ckpt.latest_step(str(d)) == 10
    assert ckpt.has_checkpoint(str(d))
    assert ckpt.restore_checkpoint_raw(str(d))["step"] == 10
    best = ckpt.restore_checkpoint_raw(str(d), step="best")
    assert best["step"] == 10
    torch.testing.assert_close(best["params"]["w"], torch.ones(3))
    torch.testing.assert_close(
        ckpt.restore_checkpoint_raw(str(d), step=4)["params"]["w"],
        torch.arange(3.0))
    only_partial = tmp_path / "only_partial" / "3"
    only_partial.mkdir(parents=True)
    (only_partial / "state.pt.tmp").write_bytes(b"")
    assert not ckpt.has_checkpoint(str(tmp_path / "only_partial"))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore_checkpoint_raw(str(tmp_path / "only_partial"))


def test_named_item_and_cuda_free_load(tmp_path):
    """A non-default item name resolves the latest step against that name;
    saved tensors are CPU tensors."""
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, {"w": torch.zeros(2)}, step=3, name="seg")
    assert ckpt.latest_step(d) is None
    assert ckpt.latest_step(d, name="seg") == 3
    raw = ckpt.restore_checkpoint_raw(d, name="seg")
    assert raw["params"]["w"].device.type == "cpu"
    assert raw["opt_state"] is None


def _agree(got, want, max_frac=1e-3):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got != want) <= max_frac, np.mean(got != want)


@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_jax_checkpoint_served_by_the_port(tmp_path, distilled):
    """A JAX orbax checkpoint restored with JAX, its params carried through
    convert.load_flax_params and saved with the port: the port's
    load_segmenter_from_checkpoint labels agree with the JAX one's on at
    least 99.9 % of voxels (fp32; summation order differs)."""
    seg = convert.random_flax_params(SMALL_ARCH, 3)
    params = {"seg": seg, "distiller": {"proj": {
        "kernel": np.ones((2, 3), np.float32)}}} if distilled else seg
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, TrainState.create(params, optax.sgd(1e-3)),
                          step=2)

    restored = jckpt.restore_checkpoint_raw(jdir)["params"]
    model = SegModel(2, 4, arch=SMALL_ARCH)
    convert.load_flax_params(model, restored["seg"] if distilled
                             else restored)
    saved = ({"seg": model.state_dict(),
              "distiller": convert.tree_to_torch(restored["distiller"])}
             if distilled else model)
    ckpt.save_checkpoint(tdir, saved, step=2)

    tseg = load_segmenter_from_checkpoint(
        tdir, SMALL_ARCH, PATCH, device="cpu", compute_dtype=torch.float32)
    jseg = jax_load_segmenter(jdir, SMALL_ARCH, PATCH,
                              compute_dtype=jnp.float32)
    vol = _blob_volume((6, 20, 24), np.random.default_rng(4))
    lr, hr = tseg.segment(vol, hr=True)
    want_lr, want_hr = jseg.segment(vol, hr=True)
    _agree(lr, want_lr)
    _agree(hr, want_hr)
