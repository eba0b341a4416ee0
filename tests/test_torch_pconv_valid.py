"""K3 (pconv_valid), K4 (pconv_pad11) and K5 (pconv3_valid): the port's
plain PyTorch versions against the JAX Pallas kernels in interpret mode, on
the same numpy inputs; and, on a machine with a card, each CUDA kernel
against its plain version.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops import pconv

torch.set_num_threads(2)

C = 128     # the smallest covered packed channel count


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pallas_pconv
    return jnp, pallas_pconv


def _rng(seed):
    return np.random.default_rng(seed)


def _offset(lead, hp, wp8, w_out, seed=0):
    """An offset tensor stored wp8 wide whose pad columns (> w_out) hold
    garbage: the kernels must read only the true columns 0..w_out."""
    x = _rng(seed).normal(size=(*lead, hp, wp8, C)).astype(np.float32)
    x[..., w_out + 1:, :] = 1e3 * _rng(seed + 1).normal(
        size=x[..., w_out + 1:, :].shape)
    return x


def _weights(kd, seed=1, c_out=C):
    shape = (2, 2, C, c_out) if kd == 1 else (3, 2, 2, C, c_out)
    w = _rng(seed).normal(size=shape) / np.sqrt(4 * kd * C)
    b = 0.1 * _rng(seed + 1).normal(size=(c_out,))
    return w.astype(np.float32), b.astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


DTYPES = {"fp32": (torch.float32, "float32", 2e-5),
          "bf16": (torch.bfloat16, "bfloat16", 0.04)}


def _run_both(name, dt, x, w, b, **kw):
    jnp, pp = _jax()
    tdt, jdt, tol = DTYPES[dt]
    want = getattr(pp, name)(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(b, jdt), interpret=True, **kw)
    got = getattr(pconv, name)(_t(x, tdt), _t(w, tdt), _t(b, tdt), **kw)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("wp8,w_out", [(32, None), (32, 16), (24, 16)],
                         ids=["default_w_out", "w_out_below", "odd8_wide"])
def test_k3_plain_matches_pallas(dt, wp8, w_out):
    x = _offset((2,), 9, wp8, 24 if w_out is None else w_out)
    w, b = _weights(1)
    got = _run_both("pconv_valid", dt, x, w, b, w_out=w_out)
    assert got.shape == (2, 8, 24 if w_out is None else w_out, C)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_k4_plain_matches_pallas(dt):
    x = _rng(0).normal(size=(2, 8, 16, C)).astype(np.float32)
    w, b = _weights(1)
    got = _run_both("pconv_pad11", dt, x, w, b)
    assert got.shape == (2, 9, 24, C)
    assert torch.all(got[:, :, 17:] == 0)       # columns > w: exact zeros


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("d,w_out", [(3, None), (3, 8), (1, None)],
                         ids=["default_w_out", "w_out_below", "single_z"])
def test_k5_plain_matches_pallas(dt, d, w_out):
    x = _offset((1, d), 9, 32, 24 if w_out is None else w_out)
    w, b = _weights(3)
    got = _run_both("pconv3_valid", dt, x, w, b, w_out=w_out)
    assert got.shape == (1, d, 8, 24 if w_out is None else w_out, C)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("d,hp,c_out", [(2, 7, 3 * C), (1, 11, 2 * C)],
                         ids=["co_384", "ci_ne_co_single_z"])
def test_k5_plain_matches_pallas_shapes(dt, d, hp, c_out):
    """Shapes the Hopper kernel must take as well: several blocks of
    output channels, Ci != Co, heights that are no multiple of a tile's."""
    x = _offset((1, d), hp, 32, 24)
    w, b = _weights(3, c_out=c_out)
    got = _run_both("pconv3_valid", dt, x, w, b, w_out=None)
    assert got.shape == (1, d, hp - 1, 24, c_out)


def _uncovered(case):
    """(wrapper name, x, w, kw) for shapes the kernels do not cover."""
    rng = _rng(0)
    w1, _ = _weights(1)
    w3, _ = _weights(3)

    def x(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "k3_wp8_not_8": ("pconv_valid", x(1, 5, 20, C), w1, dict(w_out=8)),
        "k3_w_out_not_8": ("pconv_valid", x(1, 5, 24, C), w1,
                           dict(w_out=12)),
        "k3_w_out_too_wide": ("pconv_valid", x(1, 5, 24, C), w1,
                              dict(w_out=24)),
        "k3_default_w_out_odd": ("pconv_valid", x(1, 5, 24, C), w1, {}),
        "k3_ci_not_128": ("pconv_valid", x(1, 5, 24, 64), w1[:, :, :64],
                          dict(w_out=16)),
        "k3_co_not_128": ("pconv_valid", x(1, 5, 24, C), w1[..., :64],
                          dict(w_out=16)),
        "k4_w_not_8": ("pconv_pad11", x(1, 4, 12, C), w1, {}),
        "k4_ci_not_128": ("pconv_pad11", x(1, 4, 16, 64), w1[:, :, :64], {}),
        "k4_co_not_128": ("pconv_pad11", x(1, 4, 16, C), w1[..., :64], {}),
        "k5_w_out_not_8": ("pconv3_valid", x(1, 2, 5, 24, C), w3,
                           dict(w_out=12)),
        "k5_co_not_128": ("pconv3_valid", x(1, 2, 5, 24, C), w3[..., :64],
                          dict(w_out=16)),
        "k5_kd_not_3": ("pconv3_valid", x(1, 2, 5, 24, C),
                        np.stack([w1] * 5), dict(w_out=16)),
    }[case]


@pytest.mark.parametrize("case", [
    "k3_wp8_not_8", "k3_w_out_not_8", "k3_w_out_too_wide",
    "k3_default_w_out_odd", "k3_ci_not_128", "k3_co_not_128",
    "k4_w_not_8", "k4_ci_not_128", "k4_co_not_128",
    "k5_w_out_not_8", "k5_co_not_128", "k5_kd_not_3"])
def test_none_where_jax_returns_none(case):
    """The shape predicates are JAX's: both return None on the same
    shapes, so the packed forward runs the cuDNN conv at the same sites."""
    jnp, pp = _jax()
    name, x, w, kw = _uncovered(case)
    assert getattr(pp, name)(jnp.asarray(x), jnp.asarray(w), None,
                             interpret=True, **kw) is None
    assert getattr(pconv, name)(_t(x), _t(w), None, **kw) is None


def _xla_reference(name, x, w, b, w_out=None):
    """JAX's XLA form of the same conv (ops/pack2d.py conv_packed) in fp32:
    the reference where the Pallas wrapper refuses a height for its TPU
    block choice. K4's columns > w are zeroed as the kernel stores them."""
    import jax.numpy as jnp
    from rehrseg_tpu.ops import pack2d
    xj, wj, bj = (jnp.asarray(a, jnp.float32) for a in (x, w, b))
    if name == "pconv_valid":
        y = pack2d.conv_packed(xj[None], wj[None], bj, hw_pad="valid",
                               in_w=w_out + 1)[0]
        return np.asarray(y)
    w_in = x.shape[2]
    y = np.array(pack2d.conv_packed(xj[None], wj[None], bj, hw_pad="pad11",
                                    out_w=-(-(w_in + 1) // 8) * 8)[0])
    y[:, :, w_in + 1:] = 0
    return y


def _run_both_or_xla(name, dt, x, w, b, **kw):
    """The plain version against the Pallas kernel (interpret mode) or,
    where JAX refuses the height (``_pick_bi``: a TPU block choice the port
    drops), against JAX's XLA conv on the same (rounded) operands."""
    jnp, pp = _jax()
    tdt, jdt, tol = DTYPES[dt]
    args = [jnp.asarray(a, jdt) for a in (x, w, b)]
    want = getattr(pp, name)(*args, interpret=True, **kw)
    if want is None:
        want = _xla_reference(name, *(np.asarray(a, np.float32)
                                      for a in args), **kw)
    got = getattr(pconv, name)(_t(x, tdt), _t(w, tdt), _t(b, tdt), **kw)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    return got


def _wide_weights(c_in, c_out, seed=3):
    w = _rng(seed).normal(size=(2, 2, c_in, c_out)) / np.sqrt(4 * c_in)
    b = 0.1 * _rng(seed + 1).normal(size=(c_out,))
    return w.astype(np.float32), b.astype(np.float32)


# (hp, wp8, w_out, Ci, Co): shapes the Hopper tiling must take: an odd
# packed height (7 rows: JAX's block choice refuses it), the narrowest
# output, w_out below the default on a single output row, several blocks
# of output channels, Ci = 256 (weights streamed, not resident)
K3_TILING = {"odd_height": (8, 32, 24, C, C), "w_out_8": (5, 16, 8, C, C),
             "one_row_w_out_below": (2, 32, 8, C, C),
             "co_256": (5, 24, 16, C, 2 * C), "co_384": (9, 16, 8, C, 3 * C),
             "ci_256": (5, 24, 16, 2 * C, C)}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K3_TILING))
def test_k3_plain_matches_jax_tiling_shapes(dt, case):
    hp, wp8, w_out, c_in, c_out = K3_TILING[case]
    x = _rng(7).normal(size=(2, hp, wp8, c_in)).astype(np.float32)
    x[:, :, w_out + 1:] = 1e3       # pad columns: never read
    w, b = _wide_weights(c_in, c_out)
    got = _run_both_or_xla("pconv_valid", dt, x, w, b, w_out=w_out)
    assert got.shape == (2, hp - 1, w_out, c_out)


# (h, w, Ci, Co): one input row, an odd height, Co = 256 and 384, Ci = 256
K4_TILING = {"h_1": (1, 8, C, C), "odd_height": (7, 24, C, C),
             "co_256": (4, 8, C, 2 * C), "co_384": (2, 16, C, 3 * C),
             "ci_256": (4, 16, 2 * C, C)}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K4_TILING))
def test_k4_plain_matches_jax_tiling_shapes(dt, case):
    h, w_in, c_in, c_out = K4_TILING[case]
    x = _rng(8).normal(size=(2, h, w_in, c_in)).astype(np.float32)
    w, b = _wide_weights(c_in, c_out)
    got = _run_both_or_xla("pconv_pad11", dt, x, w, b)
    assert got.shape == (2, h + 1, -(-(w_in + 1) // 8) * 8, c_out)
    assert torch.all(got[:, :, w_in + 1:] == 0)     # exact zeros, no bias


def test_c_entries_are_declared_in_their_sources():
    """Every C entry the wrappers look up is declared ``extern "C"`` in the
    source its library is built from, and every ``_entry`` call names a key
    of the table: a renamed entry would otherwise show only on the card."""
    import ast
    import re
    from pathlib import Path
    from rehrseg_tpu_torch import kernels
    from rehrseg_tpu_torch.ops import conv2x2, tail

    for table in (pconv.C_ENTRIES, tail.C_ENTRIES):
        for lib, fn_name in table.values():
            src = (kernels.CSRC / kernels.SOURCES[lib]).read_text()
            assert re.search(r'extern "C" int\s+%s\s*\(' % fn_name, src), \
                f"{fn_name} is not declared in {kernels.SOURCES[lib]}"
    n_calls = 0
    for mod in (pconv, conv2x2):
        for node in ast.walk(ast.parse(Path(mod.__file__).read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "_entry"):
                key = node.args[0]
                if isinstance(key, ast.Constant):
                    assert key.value in pconv.C_ENTRIES, key.value
                else:   # f"k4_{sfx}": the table has it for both dtypes
                    assert isinstance(key, ast.JoinedStr), ast.dump(key)
                    pattern = "".join(
                        re.escape(v.value) if isinstance(v, ast.Constant)
                        else "[a-z0-9]+" for v in key.values)
                    for sfx in ("bf16", "f32"):
                        assert any(re.fullmatch(pattern, k)
                                   and k.endswith(sfx)
                                   for k in pconv.C_ENTRIES), (pattern, sfx)
                n_calls += 1
    assert n_calls >= 8


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _on(dev, dtype, *arrays):
    return [_t(a, dtype).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.04)])
@pytest.mark.parametrize("name", ["pconv_valid", "pconv_pad11",
                                  "pconv3_valid"])
def test_kernel_matches_plain(cuda_device, name, dtype, tol, monkeypatch):
    """Each kernel against its plain version in fp32 (TF32 off), with
    garbage in the pad columns of the VALID kernels' inputs."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if name == "pconv_pad11":
        x = _rng(0).normal(size=(4, 16, 32, C))
        w, b = _weights(1)
        kw, plain = {}, pconv.pconv_pad11_plain
    elif name == "pconv_valid":
        x = _offset((4,), 17, 40, 32)
        w, b = _weights(1)
        kw, plain = dict(w_out=32), pconv.pconv_valid_plain
    else:
        x = _offset((2, 3), 17, 40, 32)
        w, b = _weights(3, c_out=2 * C)
        kw, plain = dict(w_out=32), pconv.pconv3_valid_plain
    x, w, b = _on(cuda_device, dtype, x, w, b)
    fn = getattr(pconv, name)
    before = fn.launches
    got = fn(x, w, b, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x.float(), w.float(), b.float(), *kw.values())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if name == "pconv_pad11":
        assert torch.all(got[:, :, 33:] == 0)


# (B, D, hp, wp8, Ci, Co), w_out = wp8 - 8: D = 1 with an odd height and one
# and a half 16-wide tiles; D = 2 with Co = 384; an image smaller than one
# tile with a batch of one; Ci = 256 != Co on more than one tile row
SM90_SHAPES = [(2, 1, 14, 32, 128, 128), (1, 2, 10, 32, 128, 384),
               (1, 3, 4, 16, 128, 128), (2, 2, 19, 40, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_SHAPES,
                         ids=["single_z_odd_h_ragged_w", "two_z_co384",
                              "below_one_tile_batch1", "ci256_two_tile_rows"])
def test_sm90_k5_matches_plain(cuda_device, shape, monkeypatch):
    """The bf16 wgmma / TMA kernel of K5 against the plain version on fp32
    copies (TF32 off), at ragged shapes, with garbage in the pad columns."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    bsz, d, hp, wp8, ci, co = shape
    w_out = wp8 - 8
    rng = _rng(5)
    x = rng.normal(size=(bsz, d, hp, wp8, ci))
    x[..., w_out + 1:, :] = 1e3
    w = rng.normal(size=(3, 2, 2, ci, co)) / np.sqrt(12 * ci)
    b = 0.1 * rng.normal(size=(co,))
    x, w, b = _on(cuda_device, torch.bfloat16, x, w, b)
    before = pconv.pconv3_valid.launches
    got = pconv.pconv3_valid(x, w, b, w_out=w_out)
    torch.cuda.synchronize()
    assert pconv.pconv3_valid.launches == before + 1
    want = pconv.pconv3_valid_plain(x.float(), w.float(), b.float(), w_out)
    torch.testing.assert_close(got.float(), want, rtol=0.04, atol=0.04)


# K3 (n, hp, wp8, Ci, Co), w_out = wp8 - 8: an odd height on one and a half
# 16-wide tiles; one image with Co = 384; an image smaller than one tile;
# Ci = 256 (weights streamed) on more than one tile row; one output row;
# enough tiles that every block goes round its ring several times
SM90_K3_SHAPES = [(2, 14, 32, 128, 128), (1, 10, 32, 128, 384),
                  (3, 4, 16, 128, 128), (2, 19, 40, 256, 128),
                  (2, 2, 16, 128, 256), (40, 34, 72, 128, 128)]
SM90_2D_IDS = ["odd_h_ragged_w", "one_image_co384", "below_one_tile",
               "ci256_two_tile_rows", "one_row", "many_tiles_a_block"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_K3_SHAPES, ids=SM90_2D_IDS)
def test_sm90_k3_matches_plain(cuda_device, shape, monkeypatch):
    """The bf16 wgmma / TMA kernel of K3 against the plain version on fp32
    copies (TF32 off), at ragged shapes, with garbage in the pad columns."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, hp, wp8, ci, co = shape
    w_out = wp8 - 8
    rng = _rng(6)
    x = rng.normal(size=(n, hp, wp8, ci))
    x[..., w_out + 1:, :] = 1e3
    w = rng.normal(size=(2, 2, ci, co)) / np.sqrt(4 * ci)
    b = 0.1 * rng.normal(size=(co,))
    x, w, b = _on(cuda_device, torch.bfloat16, x, w, b)
    before = pconv.pconv_valid.launches
    got = pconv.pconv_valid(x, w, b, w_out=w_out)
    torch.cuda.synchronize()
    assert pconv.pconv_valid.launches == before + 1
    want = pconv.pconv_valid_plain(x.float(), w.float(), b.float(), w_out)
    torch.testing.assert_close(got.float(), want, rtol=0.04, atol=0.04)


# K4 (n, h, w, Ci, Co): the same, its last an input one row high
SM90_K4_SHAPES = [(2, 13, 24, 128, 128), (1, 9, 24, 128, 384),
                  (3, 3, 8, 128, 128), (2, 18, 32, 256, 128),
                  (2, 1, 8, 128, 256), (40, 33, 64, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_K4_SHAPES, ids=SM90_2D_IDS)
def test_sm90_k4_matches_plain(cuda_device, shape, monkeypatch):
    """The bf16 wgmma / TMA kernel of K4 against the plain version on fp32
    copies (TF32 off), at ragged shapes; its columns > w are exact zeros."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, h, w_in, ci, co = shape
    rng = _rng(7)
    x = rng.normal(size=(n, h, w_in, ci))
    w = rng.normal(size=(2, 2, ci, co)) / np.sqrt(4 * ci)
    b = 0.1 * rng.normal(size=(co,))
    x, w, b = _on(cuda_device, torch.bfloat16, x, w, b)
    before = pconv.pconv_pad11.launches
    got = pconv.pconv_pad11(x, w, b)
    torch.cuda.synchronize()
    assert pconv.pconv_pad11.launches == before + 1
    want = pconv.pconv_pad11_plain(x.float(), w.float(), b.float())
    torch.testing.assert_close(got.float(), want, rtol=0.04, atol=0.04)
    assert torch.all(got[:, :, w_in + 1:] == 0)
