"""Weight bridge: flax SegModel params <-> the port's SegModel.

A flax param tree (nested dict of numpy arrays, as ``SegModel.init`` or a
restored checkpoint gives it) becomes the state dict of
:class:`rehrseg_tpu_torch.models.segnet.SegModel`. This is the inverse of
``rehrseg_tpu.train.torch_import``:

  - Conv kernels DHWIO -> OIDHW;
  - ConvTranspose kernels, flax ``transpose_kernel=True`` (*K, O, I) ->
    torch (I, O, *K): a pure transpose with no spatial flip;
  - InstanceNorm ``scale``/``bias`` -> ``weight``/``bias``.

Both kernel kinds move with the same axis permutation (4, 3, 0, 1, 2).

The packed forward consumes weights in the flax layout (its weight packing
is written for DHWIO), so :func:`flax_tree_from_module` gives that layout
back as views of a module's parameters.
"""

from __future__ import annotations

import numpy as np
import torch

_TO_TORCH = (4, 3, 0, 1, 2)      # DHWIO / (*K, O, I) -> OIDHW / (I, O, *K)
_TO_FLAX = (2, 3, 4, 1, 0)       # the inverse


def segmodel_mapping(arch: dict) -> dict:
    """torch state-dict key -> flax path (tuple) for a SegModel of ``arch``
    (the names of ``rehrseg_tpu.train.torch_import.segmodel_mapping``)."""
    m: dict[str, tuple] = {}
    n = arch["n_stages"]

    def block(tbase, fbase):
        m[f"{tbase}.conv.weight"] = fbase + ("conv", "kernel")
        if arch["conv_bias"]:
            m[f"{tbase}.conv.bias"] = fbase + ("conv", "bias")
        if arch["norm_affine"]:
            m[f"{tbase}.norm.weight"] = fbase + ("norm", "scale")
            m[f"{tbase}.norm.bias"] = fbase + ("norm", "bias")

    for s in range(n):
        for i in range(arch["n_conv_per_stage"][s]):
            block(f"encoder.stages.{s}.convs.{i}",
                  ("encoder", f"stage_{s}", f"conv_{i}"))
    for s in range(n - 1):
        m[f"decoder.transpconvs.{s}.weight"] = (
            "decoder", f"transpconv_{s}", "kernel")
        if arch["conv_bias"]:
            m[f"decoder.transpconvs.{s}.bias"] = (
                "decoder", f"transpconv_{s}", "bias")
        for i in range(arch["n_conv_per_stage_decoder"][s]):
            block(f"decoder.stages.{s}.convs.{i}",
                  ("decoder", f"stage_{s}", f"conv_{i}"))
    m[f"decoder.seg_layers.{n - 2}.weight"] = (
        "decoder", f"seg_layer_{n - 2}", "kernel")
    m[f"decoder.seg_layers.{n - 2}.bias"] = (
        "decoder", f"seg_layer_{n - 2}", "bias")
    m["sr_head.0.weight"] = ("sr_head_conv1", "kernel")
    m["sr_head.0.bias"] = ("sr_head_conv1", "bias")
    m["sr_head.2.weight"] = ("sr_head_conv2", "kernel")
    m["sr_head.2.bias"] = ("sr_head_conv2", "bias")
    return m


def _tree(params) -> dict:
    return params["params"] if "params" in params else params


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_flax(params, arch: dict) -> dict:
    """Flax SegModel params -> the port SegModel's state dict (CPU fp32
    tensors, torch layouts)."""
    tree = _tree(params)
    sd = {}
    for key, path in segmodel_mapping(arch).items():
        a = np.asarray(_get(tree, path), dtype=np.float32)
        if a.ndim == 5:
            a = np.transpose(a, _TO_TORCH)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_flax_params(model, params) -> None:
    """Copy flax params into ``model`` (strict: every key must land)."""
    model.load_state_dict(state_dict_from_flax(params, model.arch),
                          strict=True)


def flax_tree_from_module(model) -> dict:
    """The module's parameters as a flax-layout tree ``{"params": ...}`` of
    torch tensors (permuted views, no copies) — the form
    :func:`rehrseg_tpu_torch.models.segnet_packed.segmodel_apply_packed`
    consumes."""
    sd = dict(model.named_parameters())
    out: dict = {}
    for key, path in segmodel_mapping(model.arch).items():
        t = sd[key]
        if t.ndim == 5:
            t = t.permute(_TO_FLAX)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return {"params": out}


def tree_to_torch(params, device=None, dtype=None):
    """Map every leaf of a nested dict (numpy or array-like) to a torch
    tensor, layouts unchanged."""
    if isinstance(params, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in params.items()}
    return torch.as_tensor(np.asarray(params), device=device).to(
        dtype if dtype is not None else torch.float32)


def flax_param_shapes(arch: dict, num_classes: int = 2,
                      input_channels: int = 1) -> dict:
    """The shapes of the flax SegModel param tree ``{"params": ...}`` for
    ``arch`` (what ``rehrseg_tpu.models.SegModel(...).init`` builds)."""
    n = arch["n_stages"]
    feats = arch["features_per_stage"]

    def k3(k):
        return (k, k, k) if isinstance(k, int) else tuple(k)

    def block(cin, cout, k):
        d = {"conv": {"kernel": k3(k) + (cin, cout)}}
        if arch["conv_bias"]:
            d["conv"]["bias"] = (cout,)
        if arch["norm_affine"]:
            d["norm"] = {"scale": (cout,), "bias": (cout,)}
        return d

    enc = {}
    for s in range(n):
        enc[f"stage_{s}"] = {
            f"conv_{i}": block(
                (input_channels if s == 0 else feats[s - 1]) if i == 0
                else feats[s], feats[s], arch["kernel_sizes"][s])
            for i in range(arch["n_conv_per_stage"][s])}
    dec = {}
    for s in range(n - 1):
        cin, cout = feats[n - 1 - s], feats[n - 2 - s]
        dec[f"transpconv_{s}"] = {"kernel": k3(arch["strides"][n - 1 - s])
                                  + (cout, cin)}
        if arch["conv_bias"]:
            dec[f"transpconv_{s}"]["bias"] = (cout,)
        dec[f"stage_{s}"] = {
            f"conv_{i}": block(2 * cout if i == 0 else cout, cout,
                               arch["kernel_sizes"][n - 2 - s])
            for i in range(arch["n_conv_per_stage_decoder"][s])}
    dec[f"seg_layer_{n - 2}"] = {"kernel": (1, 1, 1, feats[0], num_classes),
                                 "bias": (num_classes,)}
    return {"params": {
        "encoder": enc, "decoder": dec,
        "sr_head_conv1": {"kernel": (3, 3, 3, feats[0], 16), "bias": (16,)},
        "sr_head_conv2": {"kernel": (5, 5, 5, 16, num_classes),
                          "bias": (num_classes,)}}}


def random_flax_params(arch: dict, seed: int, num_classes: int = 2,
                       input_channels: int = 1) -> dict:
    """A flax-layout SegModel param tree of numpy fp32 arrays made from
    ``seed``: kernels normal with std 1/sqrt(fan_in), biases and norm
    shifts small normal, norm scales near 1."""
    rng = np.random.default_rng(seed)

    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        shape = node
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = 1.0 / np.sqrt(fan_in)
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(flax_param_shapes(arch, num_classes, input_channels), "")
