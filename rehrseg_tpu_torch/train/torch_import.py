"""Warm starts from reference PyTorch checkpoints
(``rehrseg_tpu.train.torch_import``).

The port's modules carry the reference's key names (the SegModel nnUNet /
dynamic_network_architectures', UNet3D FLAVR_arch's, WDSR the reference
WDSR's), so a checkpoint loads into the module by name: ``module.``
prefixes are stripped, and a tensor lands where its key and shape match
(the reference's strict=False, train_all.py:347-356, 429-435, 496-499).

  - :func:`import_segmodel`: an nnUNet ``checkpoint_final.pth``, each
    convolution block under both of its names (``convs.{i}.conv`` and
    ``convs.{i}.all_modules.0``; the norm as ``.norm`` or
    ``.all_modules.1``); below a 90 % match of the checkpoint's weight
    tensors it fails loudly unless ``allow_partial`` (small synthetic state
    dicts, fewer weight keys than half the mapping, allow it by default);
  - :func:`import_flavr`: a public FLAVR checkpoint with the reference's
    drop filters (``encoder.stem.0``, ``outconv.1``, ``feature_fuse``),
    partial by design;
  - :func:`import_wdsr`: a weight-normed WDSR checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import convert

# torch buffer keys that are never model weights (BatchNorm running stats,
# counters): excluded from the match-rate denominator
_NON_WEIGHT = ("num_batches_tracked", "running_mean", "running_var")


def load_torch_state_dict(path: str, key: str | None = None) -> dict:
    """torch.load a checkpoint and return a flat dict of CPU tensors (the
    ``state_dict`` / ``model`` / ``network_weights`` entry when the file
    wraps one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and key in ckpt:
        ckpt = ckpt[key]
    elif isinstance(ckpt, dict):
        for k in ("state_dict", "model", "network_weights"):
            if k in ckpt:
                ckpt = ckpt[k]
                break
    return {k: v.detach().cpu() if hasattr(v, "detach")
            else torch.as_tensor(np.asarray(v)) for k, v in ckpt.items()}


def strip_module_prefix(sd: dict) -> dict:
    return {k.replace("module.", "") if k.startswith("module.") else k: v
            for k, v in sd.items()}


def drop_keys(sd: dict, substrings) -> dict:
    """The reference's drop filter (train_all.py:350-356): keys holding any
    of ``substrings`` go."""
    return {k: v for k, v in sd.items()
            if not any(s in k for s in substrings)}


class ImportReport(list):
    """Diagnostics of one import: the list holds the unfilled mapping
    keys; ``loaded_keys`` the checkpoint keys that landed, ``unconsumed``
    its weight keys no mapping entry consumed, ``match_rate`` loaded /
    (loaded + unconsumed)."""

    def __init__(self, skipped, loaded_keys, unconsumed):
        super().__init__(skipped)
        self.loaded_keys = list(loaded_keys)
        self.unconsumed = list(unconsumed)
        denom = len(self.loaded_keys) + len(self.unconsumed)
        self.match_rate = (len(self.loaded_keys) / denom) if denom else 1.0

    def summary(self) -> str:
        lines = [f"torch_import: loaded {len(self.loaded_keys)} tensors, "
                 f"match_rate={self.match_rate:.2%}"]
        if self.unconsumed:
            lines.append(f"  UNCONSUMED checkpoint keys "
                         f"({len(self.unconsumed)}):")
            lines += [f"    {k}" for k in self.unconsumed[:20]]
            if len(self.unconsumed) > 20:
                lines.append(f"    ... and {len(self.unconsumed) - 20} more")
        if list(self):
            lines.append(f"  unfilled mapping entries ({len(self)}): "
                         + ", ".join(list(self)[:10])
                         + (" ..." if len(self) > 10 else ""))
        return "\n".join(lines)


def segmodel_mapping(arch: dict) -> dict:
    """Checkpoint key -> the port SegModel's state-dict key, every seg
    layer (an nnUNet checkpoint carries the deep-supervision heads) and
    both names of each block."""
    m = {}
    for key in convert.segmodel_mapping(arch, deep_supervision=True):
        m[key] = key
        for part, alias in ((".conv.", ".all_modules.0."),
                            (".norm.", ".all_modules.1.")):
            if ".convs." in key and part in key:
                m[key.replace(part, alias)] = key
    return m


def _apply_mapping(model, sd: dict, mapping: dict, verbose: bool,
                   allow_partial: bool, what: str) -> ImportReport:
    """Copy ``sd[k]`` into ``model``'s state-dict entry ``mapping[k]`` in
    place wherever the entry exists with the same shape; returns the
    report. Raises ValueError below a 90 % match unless
    ``allow_partial``."""
    target = model.state_dict()
    loaded, skipped, new = [], [], {}
    for tk, key in mapping.items():
        v = sd.get(tk)
        if (v is None or key not in target
                or tuple(v.shape) != tuple(target[key].shape)):
            skipped.append(tk)
            continue
        new[key] = torch.as_tensor(v).to(target[key].dtype)
        loaded.append(tk)
    consumed = set(loaded)
    unconsumed = [k for k in sd
                  if k not in consumed
                  and not any(s in k for s in _NON_WEIGHT)
                  and getattr(sd[k], "ndim", 0) > 0]
    report = ImportReport(skipped, loaded, unconsumed)
    if verbose and (report.unconsumed or skipped):
        print(report.summary())
    if not allow_partial and report.match_rate < 0.9:
        raise ValueError(
            f"{what} import matched only {report.match_rate:.0%} "
            f"of the checkpoint's weight tensors: the key layout is "
            f"probably not what this importer expects. Pass "
            f"allow_partial=True to warm-start anyway (reference "
            f"strict=False semantics).\n" + report.summary())
    with torch.no_grad():
        for key, v in new.items():
            target[key].copy_(v)
    return report


def import_segmodel(model, sd: dict, verbose: bool = True,
                    allow_partial: bool | None = None) -> ImportReport:
    """Load an nnUNet checkpoint's state dict into the port's SegModel in
    place (train_all.py:496-499); returns the :class:`ImportReport`.
    Raises ValueError below a 90 % match unless ``allow_partial``."""
    sd = strip_module_prefix(sd)
    mapping = segmodel_mapping(model.arch)
    if allow_partial is None:
        n_weightish = sum(1 for k in sd
                          if not any(s in k for s in _NON_WEIGHT))
        allow_partial = n_weightish < len(mapping) // 2
    return _apply_mapping(model, sd, mapping, verbose, allow_partial,
                          "nnUNet SegModel")


def flavr_mapping(use_uncertainty: bool) -> dict:
    """Checkpoint key -> the port UNet3D's state-dict key (the same
    names), biases of the encoder included: a UNet3D without them
    (n_outputs = 1) leaves those entries unfilled."""
    return {k: k for k in convert.flavr_mapping(use_uncertainty,
                                                 enc_bias=True)}


def import_flavr(model, sd: dict, drop=("encoder.stem.0", "outconv.1",
                                        "feature_fuse"),
                 verbose: bool = True,
                 allow_partial: bool = True) -> ImportReport:
    """FLAVR warm start into the port's UNet3D in place, with the
    reference's drop filters (train_all.py:350-356). Partial matches are
    the expected case (the public FLAVR_4x checkpoint's head is
    re-purposed), so ``allow_partial`` defaults True; the report still
    prints."""
    sd = drop_keys(strip_module_prefix(sd), drop or ())
    return _apply_mapping(model, sd, flavr_mapping(model.use_uncertainty),
                          verbose, allow_partial, "FLAVR")


def wdsr_mapping(n_resblocks: int) -> dict:
    """Checkpoint key -> the port WDSR's state-dict key (the same
    names)."""
    return {k: k for k in convert.wdsr_mapping(n_resblocks)}


def import_wdsr(model, sd: dict, verbose: bool = True,
                allow_partial: bool = True) -> ImportReport:
    """A reference WDSR checkpoint into the port's WDSR in place."""
    return _apply_mapping(model, strip_module_prefix(sd),
                          wdsr_mapping(len(model.body)), verbose,
                          allow_partial, "WDSR")
