"""Weight bridge: flax params -> the port's SegModel, UNet3D (FLAVR) and
WDSR.

A flax param tree (nested dict of numpy arrays, as ``init`` or a restored
checkpoint gives it) becomes the state dict of the port's module. This is
the inverse of ``rehrseg_tpu.train.torch_import``:

  - Conv kernels DHWIO -> OIDHW;
  - ConvTranspose kernels, flax ``transpose_kernel=True`` (*K, O, I) ->
    torch (I, O, *K): a pure transpose with no spatial flip;
  - InstanceNorm ``scale``/``bias`` -> ``weight``/``bias``;
  - WNConv ``v`` (kh, kw, I, O) / ``g`` (O,) -> ``weight_v`` (O, I, kh, kw)
    / ``weight_g`` (O, 1, 1, 1).

Both 3D kernel kinds move with the same axis permutation (4, 3, 0, 1, 2),
2D kernels with (3, 2, 0, 1). The torch key names of UNet3D and WDSR are
the reference's (``torch_import.flavr_mapping`` / ``wdsr_mapping``).

Each model also has numpy-only param-shape functions and seeded random
params (:func:`flax_param_shapes`, :func:`flavr_param_shapes`,
:func:`wdsr_param_shapes` and their ``random_*`` counterparts), the shapes
the JAX ``init`` builds, for hosts without JAX.

The packed forward consumes weights in the flax layout (its weight packing
is written for DHWIO), so :func:`flax_tree_from_module` gives that layout
back as views of a module's parameters.
"""

from __future__ import annotations

import numpy as np
import torch

_TO_TORCH = (4, 3, 0, 1, 2)      # DHWIO / (*K, O, I) -> OIDHW / (I, O, *K)
_TO_FLAX = (2, 3, 4, 1, 0)       # the inverse


def segmodel_mapping(arch: dict, deep_supervision: bool = False) -> dict:
    """torch state-dict key -> flax path (tuple) for a SegModel of ``arch``
    (the names of ``rehrseg_tpu.train.torch_import.segmodel_mapping``);
    with ``deep_supervision`` every decoder stage has a seg layer, else
    only the last."""
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
        if deep_supervision or s == n - 2:
            m[f"decoder.seg_layers.{s}.weight"] = (
                "decoder", f"seg_layer_{s}", "kernel")
            m[f"decoder.seg_layers.{s}.bias"] = (
                "decoder", f"seg_layer_{s}", "bias")
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


def state_dict_from_flax(params, arch: dict,
                         deep_supervision: bool = False) -> dict:
    """Flax SegModel params -> the port SegModel's state dict (CPU fp32
    tensors, torch layouts)."""
    tree = _tree(params)
    sd = {}
    for key, path in segmodel_mapping(arch, deep_supervision).items():
        a = np.asarray(_get(tree, path), dtype=np.float32)
        if a.ndim == 5:
            a = np.transpose(a, _TO_TORCH)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_flax_params(model, params) -> None:
    """Copy flax params into ``model`` (strict: every key must land)."""
    model.load_state_dict(state_dict_from_flax(
        params, model.arch, getattr(model, "deep_supervision", False)),
        strict=True)


def flax_tree_from_module(model) -> dict:
    """The module's parameters as a flax-layout tree ``{"params": ...}`` of
    torch tensors (permuted views, no copies) — the form
    :func:`rehrseg_tpu_torch.models.segnet_packed.segmodel_apply_packed`
    consumes."""
    sd = dict(model.named_parameters())
    out: dict = {}
    mapping = segmodel_mapping(model.arch,
                               getattr(model, "deep_supervision", False))
    for key, path in mapping.items():
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
                      input_channels: int = 1,
                      deep_supervision: bool = False) -> dict:
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
        if deep_supervision or s == n - 2:
            dec[f"seg_layer_{s}"] = {"kernel": (1, 1, 1, cout, num_classes),
                                     "bias": (num_classes,)}
    return {"params": {
        "encoder": enc, "decoder": dec,
        "sr_head_conv1": {"kernel": (3, 3, 3, feats[0], 16), "bias": (16,)},
        "sr_head_conv2": {"kernel": (5, 5, 5, 16, num_classes),
                          "bias": (num_classes,)}}}


def random_flax_params(arch: dict, seed: int, num_classes: int = 2,
                       input_channels: int = 1,
                       deep_supervision: bool = False) -> dict:
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

    return fill(flax_param_shapes(arch, num_classes, input_channels,
                                  deep_supervision), "")


# ------------------------------------------------------------------ FLAVR

def _conv_to_torch(a: np.ndarray) -> np.ndarray:
    """Flax conv kernel (*K, I, O) -> torch (O, I, *K); flax transposed
    kernel (*K, O, I) -> torch (I, O, *K): the same permutation."""
    nsp = a.ndim - 2
    return np.transpose(a, (nsp + 1, nsp) + tuple(range(nsp)))


def _unet3d_enc_blocks():
    """(layer, block, inplanes, planes, downsample) of the encoder."""
    out, inplanes = [], 64
    for layer, planes in zip((1, 2, 3, 4), (64, 128, 256, 512)):
        for blk in range(2):
            cin = inplanes if blk == 0 else planes
            out.append((layer, blk, cin, planes,
                        blk == 0 and (layer in (2, 3) or cin != planes)))
        inplanes = planes
    return out


def flavr_mapping(use_uncertainty: bool, enc_bias: bool = True) -> dict:
    """torch state-dict key -> flax path (tuple) for a UNet3D (the names of
    ``rehrseg_tpu.train.torch_import.flavr_mapping``; the encoder's biases
    exist only when ``enc_bias``, i.e. n_outputs > 1)."""
    m: dict[str, tuple] = {}

    def conv(tk, path, bias=True):
        m[f"{tk}.weight"] = path + ("kernel",)
        if bias:
            m[f"{tk}.bias"] = path + ("bias",)

    conv("encoder.stem.0", ("encoder", "stem"), enc_bias)
    for layer, blk, _, _, down in _unet3d_enc_blocks():
        base, fb = f"encoder.layer{layer}.{blk}", ("encoder",
                                                   f"layer{layer}_{blk}")
        conv(f"{base}.conv1.0", fb + ("conv1",), enc_bias)
        conv(f"{base}.conv2.0", fb + ("conv2",), enc_bias)
        conv(f"{base}.fg.attn_layer.0", fb + ("fg", "attn"))
        if down:
            conv(f"{base}.downsample.0", fb + ("downsample",), False)
    for i in range(5):
        kind = "conv" if i in (0, 3) else "upconv"
        conv(f"decoder.{i}.{kind}.0", (f"dec{i}", kind))
        conv(f"decoder.{i}.{kind}.1.attn_layer.0", (f"dec{i}", "gate",
                                                    "attn"))
    conv("feature_fuse.conv.0", ("feature_fuse",))
    if use_uncertainty:
        conv("feature_fuse1.conv.0", ("feature_fuse1",))
        conv("uncertainty_early.conv.0", ("uncertainty_early",))
        conv("uncertainty_out", ("uncertainty_out",))
    else:
        conv("outconv.1", ("outconv",))
    return m


def _state_dict(tree, mapping) -> dict:
    sd = {}
    for key, path in mapping.items():
        a = np.asarray(_get(tree, path), dtype=np.float32)
        if path[-1] == "g":
            a = a.reshape(-1, 1, 1, 1)
        elif a.ndim >= 4:
            a = _conv_to_torch(a)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_flax_flavr_params(model, params, use_uncertainty: bool) -> None:
    """Copy flax UNet3D params into the port's ``UNet3D`` (strict)."""
    if bool(use_uncertainty) != bool(model.use_uncertainty):
        raise ValueError(
            f"params of use_uncertainty={use_uncertainty} for a UNet3D "
            f"with use_uncertainty={model.use_uncertainty}")
    mapping = flavr_mapping(use_uncertainty, model.n_outputs > 1)
    model.load_state_dict(_state_dict(_tree(params), mapping), strict=True)


def flavr_param_shapes(img_channels: int = 2, n_inputs: int = 4,
                       n_outputs: int = 4,
                       use_uncertainty: bool = False) -> dict:
    """The shapes of the flax UNet3D param tree ``{"params": ...}`` (what
    ``rehrseg_tpu.models.UNet3D(...).init`` builds on n_inputs slices)."""
    enc_bias = n_outputs > 1

    def conv(k, cin, cout, bias=True):
        d = {"kernel": tuple(k) + (cin, cout)}
        if bias:
            d["bias"] = (cout,)
        return d

    def gate(c):
        return {"attn": conv((1, 1, 1), c, c)}

    enc = {"stem": conv((3, 7, 7), img_channels, 64, enc_bias)}
    for layer, blk, cin, planes, down in _unet3d_enc_blocks():
        b = {"conv1": conv((3, 3, 3), cin, planes, enc_bias),
             "conv2": conv((3, 3, 3), planes, planes, enc_bias),
             "fg": gate(planes)}
        if down:
            b["downsample"] = conv((1, 1, 1), cin, planes, False)
        enc[f"layer{layer}_{blk}"] = b
    tree = {"encoder": enc}
    for i, (cin, cout) in enumerate(((512, 256), (512, 128), (256, 64),
                                     (128, 64), (128, 64))):
        if i in (0, 3):
            tree[f"dec{i}"] = {"conv": conv((3, 3, 3), cin, cout),
                               "gate": gate(cout)}
        else:     # flax transpose_kernel=True: (*K, O, I)
            tree[f"dec{i}"] = {"upconv": {"kernel": (3, 4, 4, cout, cin),
                                          "bias": (cout,)},
                               "gate": gate(cout)}
    fold = 64 * n_inputs
    fuse_out = fold if use_uncertainty else 64
    tree["feature_fuse"] = conv((3, 3), fold, fuse_out)
    if use_uncertainty:
        n_hyp = (64 * img_channels) // n_outputs // img_channels
        tree["feature_fuse1"] = conv((1, 1), fuse_out, 64 * img_channels)
        tree["uncertainty_early"] = conv((1, 1), fuse_out, 64)
        tree["uncertainty_out"] = conv((1, 1, 1), n_hyp, 1)
    else:
        tree["outconv"] = conv((7, 7), 64, n_outputs * img_channels)
    return {"params": tree}


def random_flavr_params(seed: int, **kw) -> dict:
    """A flax-layout UNet3D param tree of numpy fp32 arrays made from
    ``seed`` (kernels normal with std 1/sqrt(fan_in), biases small normal);
    ``kw`` as :func:`flavr_param_shapes`."""
    return _fill(flavr_param_shapes(**kw), np.random.default_rng(seed))


# ------------------------------------------------------------------- WDSR

def wdsr_mapping(n_resblocks: int) -> dict:
    """torch state-dict key -> flax path for a WDSR (the names of
    ``rehrseg_tpu.train.torch_import.wdsr_mapping``)."""
    m: dict[str, tuple] = {}

    def wn(tk, *path):
        m[f"{tk}.weight_v"] = path + ("v",)
        m[f"{tk}.weight_g"] = path + ("g",)
        m[f"{tk}.bias"] = path + ("bias",)

    wn("head", "head")
    for i in range(n_resblocks):
        for j, name in ((0, "conv_expand"), (2, "conv_linear"),
                        (3, "conv_out")):
            wn(f"body.{i}.body.{j}", f"body_{i}", name)
    wn("tail.conv0", "tail", "conv0")
    wn("skip.conv0", "skip", "conv0")
    return m


def load_flax_wdsr_params(model, params) -> None:
    """Copy flax WDSR params into the port's ``WDSR`` (strict)."""
    model.load_state_dict(
        _state_dict(_tree(params), wdsr_mapping(len(model.body))),
        strict=True)


def wdsr_param_shapes(out_channel: int = 2, n_resblocks: int = 16,
                      num_channels: int = 32, scale: float = 4.0) -> dict:
    """The shapes of the flax WDSR param tree ``{"params": ...}``."""
    def wn(k, cin, cout):
        return {"v": (k, k, cin, cout), "g": (cout,), "bias": (cout,)}

    nc, lin, s1 = num_channels, int(num_channels * 0.8), int(scale)
    tree = {"head": wn(3, out_channel, nc),
            "tail": {"conv0": wn(3, nc, s1 * out_channel)},
            "skip": {"conv0": wn(5, out_channel, s1 * out_channel)}}
    for i in range(n_resblocks):
        tree[f"body_{i}"] = {"conv_expand": wn(1, nc, nc * 4),
                             "conv_linear": wn(1, nc * 4, lin),
                             "conv_out": wn(3, lin, nc)}
    return {"params": tree}


def random_wdsr_params(seed: int, **kw) -> dict:
    """A flax-layout WDSR param tree of numpy fp32 arrays made from
    ``seed``: ``v`` normal with std 1/sqrt(fan_in), ``g`` = ||v|| times
    (1 + small normal), biases small normal; ``kw`` as
    :func:`wdsr_param_shapes`."""
    return _fill(wdsr_param_shapes(**kw), np.random.default_rng(seed))


def _fill(shapes: dict, rng) -> dict:
    """Seeded values for a shape tree, in its key order: ``kernel`` / ``v``
    normal with std 1/sqrt(fan_in), ``g`` the norm of its sibling ``v``
    times (1 + 0.1 normal), anything else 0.1 normal."""
    def fill(node):
        if "kernel" not in node and "v" not in node:
            return {k: fill(v) for k, v in node.items()}
        out = {}
        for name, shape in node.items():
            if name in ("kernel", "v"):
                std = 1.0 / np.sqrt(int(np.prod(shape[:-1])))
                out[name] = (rng.standard_normal(shape) * std).astype(
                    np.float32)
            elif name == "g":
                norm = np.sqrt((out["v"].astype(np.float64) ** 2).sum(
                    (0, 1, 2)))
                out[name] = (norm * (1.0 + 0.1 * rng.standard_normal(
                    shape))).astype(np.float32)
            else:
                out[name] = (0.1 * rng.standard_normal(shape)).astype(
                    np.float32)
        return out

    return fill(shapes)


# -------------------------------------------------------------- Distiller

def distiller_param_shapes(student_dim: int = 64,
                           teacher_dim: int = 64) -> dict:
    """The shapes of the flax Distiller param tree ``{"params": ...}``."""
    return {"params": {"distill": {
        "kernel": (1, 1, 1, student_dim, teacher_dim),
        "bias": (teacher_dim,)}}}


def random_distiller_params(seed: int, **kw) -> dict:
    """A flax-layout Distiller param tree of numpy fp32 arrays made from
    ``seed``; ``kw`` as :func:`distiller_param_shapes`."""
    return _fill(distiller_param_shapes(**kw), np.random.default_rng(seed))


def load_flax_distiller_params(model, params) -> None:
    """Copy flax Distiller params into the port's ``Distiller`` (strict)."""
    model.load_state_dict(_state_dict(_tree(params), {
        "distill.weight": ("distill", "kernel"),
        "distill.bias": ("distill", "bias")}), strict=True)
