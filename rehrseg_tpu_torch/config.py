"""Config system: the port's own copy of ``rehrseg_tpu.config`` (the
reference's configs/brain.yaml schema plus the nnUNet artifacts plans.json
and splits_final.json).

pyyaml is imported only to read a YAML file: a config whose content is JSON
is read with ``json`` and gives the same :class:`Config` (YAML reads JSON
too), so serving needs no pyyaml. One difference remains: YAML 1.1 reads an
exponent float without a dot (``1e-05``) as a string, JSON as a float. The
declared fields are coerced either way, the ``extra`` values are not, so a
JSON config meant for both packages writes such floats with a dot
(``1.0e-05``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields


@dataclass
class Config:
    # paths
    data_path: str = ""
    tmp_path: str = "./tmp"
    checkpoint_path: str = "./checkpoints"
    seg_path: str = ""
    # stage 1
    smore_initialization: bool = True
    pretrain_path: str | None = None
    batch_size_sr: int = 32
    lr_sr: float = 5e-4
    n_patches: int = 8_320_000
    save_iters_sr: int = 10_000
    num_slices: int = 4
    patch_size: int = 96
    slice_thickness: float = 4.0
    target_thickness: float = 1.0
    blur_kernel: str = "rf-pulse-slr"
    random_flip: bool = True
    nnunet_transform: bool = True
    enable_uncertainty: bool = True
    # stage 2
    batch_size_segsr: int = 2
    lr_segsr: float = 1e-3
    epochs: int = 200
    save_iters_segsr: int = 500
    enable_distillation: bool = True
    lambda_l1: float = 0.0
    lambda_cosine: float = 1.0
    lambda_structure: float = 1.0
    # runtime additions (not in the reference schema)
    fold: int | str | None = None  # int, None, or 'all' (fold-parallel)
    uncertainty_steps: int = 20_000  # hard-coded 20000 in train_all.py:448
    # extra: opt-in keys beyond the reference schema (unknown top-level keys
    # merge here); the serving path reads arch_override and patch_size_zyx
    extra: dict = field(default_factory=dict)

    @property
    def slice_separation(self) -> float:
        return float(self.slice_thickness) / float(self.target_thickness)


def _read(path: str) -> dict:
    """The file's mapping: JSON by ``json``, anything else by pyyaml."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise ImportError(
            f"{path} is not JSON, and reading a YAML config needs pyyaml, "
            f"which is not installed; write the config as JSON") from None
    return yaml.safe_load(text) or {}


def load_config(path: str, **overrides) -> Config:
    raw = _read(path)
    raw.update(overrides)
    known = {f.name: f for f in fields(Config)}
    kwargs = {}
    extra = {}
    for k, v in raw.items():
        if k not in known:
            extra[k] = v
            continue
        # pyyaml (YAML 1.1) parses exponent floats without a dot ("1e-3")
        # as strings: coerce to the declared field type
        ftype = known[k].type
        if isinstance(v, str):
            if ftype in ("float", float):
                v = float(v)
            elif ftype in ("int", int):
                v = int(float(v))
        kwargs[k] = v
    cfg = Config(**kwargs)
    # unknown top-level keys merge INTO an explicit `extra:` mapping rather
    # than clobbering it (both spellings are accepted)
    cfg.extra = {**(cfg.extra or {}), **extra}
    return cfg


def load_plans(seg_path: str) -> dict:
    with open(os.path.join(seg_path, "plans.json")) as f:
        return json.load(f)


def load_splits(seg_path: str) -> list:
    """splits_final.json lives in nnUNet_preprocessed (train_all.py:259)."""
    split_path = os.path.join(
        os.path.dirname(seg_path).replace("nnUNet_results",
                                          "nnUNet_preprocessed"),
        "splits_final.json")
    with open(split_path) as f:
        return json.load(f)
