"""The port's config loader against the JAX package's: the same files give
equal Configs (YAML and JSON, the ``extra`` merge, the "1e-3" coercion),
the nnUNet artifacts load alike, and the stage-2 arch and patches come out
the same from an arch_override and from a plans.json. The port reads JSON
without pyyaml and says so when a YAML file needs it."""

import dataclasses
import json
import os
import sys

import pytest

from rehrseg_tpu import config as jconfig
from rehrseg_tpu.pipeline import Pipeline
from rehrseg_tpu_torch import config as tconfig
from rehrseg_tpu_torch.pipeline import seg_arch_and_patches
from tests.test_models import SMALL_ARCH
from tests.test_plans_arch import PLANS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRAIN = os.path.join(REPO, "configs", "brain.yaml")


def _arch_lists(arch):
    return {k: [list(v) if isinstance(v, tuple) else v for v in val]
            if isinstance(val, tuple) else val for k, val in arch.items()}


def _both(path, **overrides):
    got = tconfig.load_config(path, **overrides)
    want = jconfig.load_config(path, **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.slice_separation == want.slice_separation
    return got


def test_brain_yaml_matches_jax():
    cfg = _both(BRAIN)
    assert cfg.lr_segsr == 1e-3 and isinstance(cfg.lr_segsr, float)
    assert cfg.extra == {}
    _both(BRAIN, fold=2, lr_sr="1e-4")


def test_yaml_extra_merge_and_coercion_match_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("lr_sr: 1e-3\nepochs: '3'\nextra:\n  precision: fp32\n"
                    "eval_mirror: false\npatch_size_zyx: [4, 16, 16]\n")
    cfg = _both(str(path))
    assert cfg.lr_sr == 1e-3 and cfg.epochs == 3
    assert cfg.extra == {"precision": "fp32", "eval_mirror": False,
                         "patch_size_zyx": [4, 16, 16]}


def _json_config(tmp_path, **extra):
    cfg = {"slice_thickness": 4.0, "target_thickness": 1.0,
           "lr_segsr": "1e-3", "epochs": 1, "fold": 0,
           "arch_override": _arch_lists(dict(SMALL_ARCH, norm_eps=0.001)),
           "patch_size_zyx": [4, 16, 16], **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg, indent=1))
    return str(path)


def test_json_matches_jax(tmp_path):
    cfg = _both(_json_config(tmp_path))
    assert cfg.lr_segsr == 1e-3
    assert cfg.extra["patch_size_zyx"] == [4, 16, 16]


def test_json_exponent_without_a_dot_in_extra(tmp_path):
    """The one divergence: YAML 1.1 reads ``1e-05`` as a string, JSON as a
    float. Declared fields are coerced on both sides; ``extra`` is not, so
    a JSON config for both packages writes such floats with a dot."""
    path = tmp_path / "trap.json"
    path.write_text('{"lr_sr": 1e-05, "eps_bare": 1e-05, '
                    '"eps_dot": 1.0e-05}')
    got, want = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert got.lr_sr == want.lr_sr == 1e-05
    assert got.extra["eps_bare"] == 1e-05
    assert want.extra["eps_bare"] == "1e-05"
    assert got.extra["eps_dot"] == want.extra["eps_dot"] == 1e-05


def test_json_without_pyyaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = tconfig.load_config(_json_config(tmp_path))
    assert cfg.epochs == 1 and cfg.extra["patch_size_zyx"] == [4, 16, 16]
    with pytest.raises(ImportError, match="pyyaml"):
        tconfig.load_config(BRAIN)


def _nnunet_tree(tmp_path):
    seg_path = tmp_path / "nnUNet_results" / "Dataset1" / "trainer"
    seg_path.mkdir(parents=True)
    (seg_path / "plans.json").write_text(json.dumps(PLANS))
    pre = tmp_path / "nnUNet_preprocessed" / "Dataset1"
    pre.mkdir(parents=True)
    splits = [{"train": ["a", "b"], "val": ["c"]},
              {"train": ["a", "c"], "val": ["b"]}]
    (pre / "splits_final.json").write_text(json.dumps(splits))
    return str(seg_path), splits


def test_plans_and_splits_match_jax(tmp_path):
    seg_path, splits = _nnunet_tree(tmp_path)
    assert tconfig.load_plans(seg_path) == jconfig.load_plans(seg_path) \
        == PLANS
    assert tconfig.load_splits(seg_path) == jconfig.load_splits(seg_path) \
        == splits


def _jax_arch_and_patches(cfg):
    pipe = Pipeline.__new__(Pipeline)
    pipe.cfg = cfg
    pipe.arch_override = (cfg.extra or {}).get("arch_override")
    return Pipeline._seg_arch_and_patches(pipe)


@pytest.mark.parametrize("source", ["arch_override", "plans"])
def test_seg_arch_and_patches_match_jax(tmp_path, source):
    if source == "plans":
        seg_path, _ = _nnunet_tree(tmp_path)
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"seg_path": seg_path}))
        path = str(path)
    else:
        path = _json_config(tmp_path)
    got = seg_arch_and_patches(tconfig.load_config(path))
    want = _jax_arch_and_patches(jconfig.load_config(path))
    assert got == want
    arch, patch_zyx, patch_xyz, patch_ori = got
    if source == "plans":
        assert patch_zyx == [16, 128, 160] and arch["n_stages"] == 5
    else:
        assert arch == dict(SMALL_ARCH, norm_eps=0.001)
        assert patch_zyx == [4, 16, 16]
    assert patch_xyz == patch_zyx[::-1]
    assert patch_ori == [patch_xyz[0] + 64, patch_xyz[1] + 64, patch_xyz[2]]


def test_chip_smoke_json_reads_alike(tmp_path):
    """chip_smoke's JSON writer puts a dot in every exponent float, so both
    packages read its configs alike, ``extra`` included."""
    from chip_smoke import json_with_dots

    cfg = {"lr_sr": 1e-05, "extra_eps": 1e-05, "tiny": -2.5e-07,
           "big": 1e20, "name": 'a1e-05b "quoted 2e-3',
           "arch_override": _arch_lists(SMALL_ARCH)}
    path = tmp_path / "cfg.json"
    path.write_text(json_with_dots(cfg))
    got = _both(str(path))
    assert json.loads(path.read_text()) == cfg
    assert got.extra["extra_eps"] == 1e-05 and got.extra["tiny"] == -2.5e-07
    assert got.extra["arch_override"]["norm_eps"] == 1e-05
