"""K2 (accumulate_tta_tile): the port's plain PyTorch version against the
JAX Pallas kernel in interpret mode, on the same numpy inputs; and, on a
machine with a card, the CUDA kernel against the plain version.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.infer import sliding_window as tsw
from rehrseg_tpu_torch.ops.tail import (_k2_vector_ok, accumulate_tta_tile,
                                        accumulate_tta_tile_plain,
                                        zgrouped_combos)

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops.pallas_tail import accumulate_tta_tile
    return jnp, accumulate_tta_tile


def _inputs(z_scale=1, seed=0, pw=256):
    rng = np.random.default_rng(seed)
    C, pd, ph = 2, 2, 16
    od = pd * z_scale
    D, H, W = 8 * z_scale, 32, 512
    preds = rng.normal(size=(8, C, od, ph, pw)).astype(np.float32)
    g = rng.uniform(0.1, 1.0, size=(od, ph, pw)).astype(np.float32)
    logits = (rng.normal(size=(C, D, H, W)) * 0.1).astype(np.float32)
    return logits, preds, g


def test_combo_order_matches_jax():
    from rehrseg_tpu.ops.pallas_tail import zgrouped_combos as jax_combos
    assert zgrouped_combos() == jax_combos()


@pytest.mark.parametrize("z_scale,offsets", [
    (1, (2, 8, 128, 1)),
    (1, (0, 0, 0, 1)),
    (4, (1, 16, 0, 1)),
    (1, (2, 8, 128, 0)),   # padded grid row: contributes nothing
])
def test_plain_matches_pallas(z_scale, offsets):
    jnp, jax_acc = _jax()
    logits, preds, g = _inputs(z_scale)
    p16 = jnp.asarray(preds, jnp.bfloat16)
    want = jax_acc(jnp.asarray(logits), p16, jnp.asarray(g),
                   jnp.asarray(offsets, jnp.int32), z_scale=z_scale,
                   interpret=True)
    got = accumulate_tta_tile(
        torch.tensor(logits),
        torch.tensor(np.asarray(p16, np.float32)).to(torch.bfloat16),
        torch.tensor(g), offsets, z_scale=z_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_matches_pallas_fp32_preds():
    """fp32 predictions (an fp32 Segmenter): the gaussian stays fp32."""
    jnp, jax_acc = _jax()
    logits, preds, g = _inputs(seed=2)
    off = (1, 8, 0, 1)
    want = jax_acc(jnp.asarray(logits), jnp.asarray(preds), jnp.asarray(g),
                   jnp.asarray(off, jnp.int32), interpret=True)
    got = accumulate_tta_tile(torch.tensor(logits), torch.tensor(preds),
                              torch.tensor(g), off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_two_tiles_overlap():
    """Two overlapping tiles accumulate additively, in place."""
    jnp, jax_acc = _jax()
    rng = np.random.default_rng(1)
    C, od, ph, pw = 2, 2, 16, 256
    g = rng.uniform(0.1, 1.0, size=(od, ph, pw)).astype(np.float32)
    tiles = [(0, 0, 0, 1), (1, 8, 128, 1)]
    preds = [jnp.asarray(rng.normal(size=(8, C, od, ph, pw)), jnp.bfloat16)
             for _ in tiles]
    want = jnp.zeros((C, 4, 32, 512), jnp.float32)
    got = torch.zeros((C, 4, 32, 512))
    for p, off in zip(preds, tiles):
        want = jax_acc(want, p, jnp.asarray(g), jnp.asarray(off, jnp.int32),
                       interpret=True)
        out = accumulate_tta_tile(
            got, torch.tensor(np.asarray(p, np.float32)).to(torch.bfloat16),
            torch.tensor(g), off)
        assert out is got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tile_outside_logits_raises():
    logits, preds, g = _inputs()
    with pytest.raises(ValueError, match="outside"):
        accumulate_tta_tile(torch.tensor(logits), torch.tensor(preds),
                            torch.tensor(g), (7, 0, 0, 1))


def _misaligned(shape, dtype, shift):
    """A contiguous zero tensor whose data starts ``shift`` elements past
    the allocator's (16-byte aligned) base."""
    n = int(np.prod(shape))
    return torch.zeros(n + shift, dtype=dtype)[shift:].view(shape)


@pytest.mark.parametrize("dtype,pw,W,sz,shifted,want", [
    (torch.bfloat16, 384, 640, 128, None, True),   # the aligned grid
    (torch.float32, 384, 640, 128, None, True),
    (torch.bfloat16, 384, 640, 4, None, True),     # sz % 4 == 0 is enough
    (torch.bfloat16, 252, 640, 128, None, False),  # bf16 rows: pw % 8
    (torch.float32, 252, 640, 128, None, True),    # fp32 rows: pw % 4
    (torch.float32, 250, 640, 128, None, False),
    (torch.bfloat16, 384, 640, 5, None, False),    # float4 accumulator rows
    (torch.float32, 384, 638, 128, None, False),
    (torch.bfloat16, 384, 640, 128, "logits", False),  # 16-byte bases
    (torch.bfloat16, 384, 640, 128, "preds", False),
    (torch.float32, 384, 640, 128, "gaussian", False),
])
def test_vector_instance_choice(dtype, pw, W, sz, shifted, want):
    """The launcher's choice between K2's vector instance (16-byte chunks,
    float4 accumulator rows) and its general one."""
    shapes = dict(logits=((2, 2, 8, W), torch.float32),
                  preds=((8, 2, 1, 4, pw), dtype),
                  gaussian=((1, 4, pw), dtype))
    t = {k: _misaligned(shape, dt, int(k == shifted))
         for k, (shape, dt) in shapes.items()}
    assert all(v.is_contiguous() for v in t.values())
    assert _k2_vector_ok(t["logits"], t["preds"], t["gaussian"], sz) is want


@pytest.mark.parametrize("sep", [0, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_aligned_logits_cast_gaussian_once(monkeypatch, sep, dtype):
    """The aligned engine casts each gaussian to the preds' dtype once a
    volume: every K2 call gets that one tensor, and the logits are bit for
    bit those of K2's plain version given the fp32 gaussian on every
    tile."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(6, 20, 300, 1)).astype(np.float32)
    patch = (4, 16, 256)

    def model_fn(batch):
        x = batch[..., 0].float()
        lr = torch.stack([torch.sin(x), torch.cos(3 * x)], 1).to(dtype)
        return (lr, lr.repeat_interleave(sep, 2) * 0.5) if sep else lr

    calls = []

    def spy(logits, preds, gaussian, offsets, *, z_scale=1):
        calls.append((z_scale, preds.dtype, gaussian))
        return accumulate_tta_tile(logits, preds, gaussian, offsets,
                                   z_scale=z_scale)

    monkeypatch.setattr(tsw, "accumulate_tta_tile", spy)
    got = tsw._aligned_logits(model_fn, data, patch, slice_separation=sep,
                              device="cpu")
    got = got if sep else (got,)
    vol, starts, _ = tsw._aligned_prep(data, patch, 0.5, torch.bfloat16,
                                       torch.device("cpu"))
    want = [torch.zeros_like(a) for a in got]
    g = [tsw._gaussian((4 * max(s, 1), 16, 256), True, "cpu")
         for s in (1, sep)[:len(got)]]
    for row in starts:
        sx, sy, sz = row[:3]
        out = model_fn(tsw._mirror_batch_zgrouped(
            vol[sx:sx + 4, sy:sy + 16, sz:sz + 256]))
        for a, p, gi, zs in zip(want, out if sep else (out,), g, (1, sep)):
            accumulate_tta_tile_plain(a, p.contiguous(), gi, row, zs)
    assert len(starts) > 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(calls) == len(starts) * len(got)
    for zs in {c[0] for c in calls}:
        gs = [c[2] for c in calls if c[0] == zs]
        assert all(x is gs[0] for x in gs) and gs[0].dtype == dtype
    assert all(c[1] == dtype for c in calls)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z_scale,offsets,pw,shift", [
    (1, (2, 8, 128, 1), 256, 0),    # an aligned grid start: vector
    (4, (1, 3, 5, 1), 256, 0),      # an unaligned start: general
    (1, (6, 16, 256, 1), 256, 0),   # at the accumulator's far edge
    (4, (6, 16, 256, 1), 256, 0),   # z_scale 4 at the far edge
    (1, (2, 8, 128, 0), 256, 0),    # valid = 0: adds zeros
    (1, (2, 8, 128, 1), 252, 0),    # pw % 8 != 0: bf16 general, fp32 vector
    (1, (2, 8, 128, 1), 250, 0),    # pw % 4 != 0: general
    (1, (2, 8, 128, 1), 256, 1),    # preds not 16-byte aligned: general
], ids=["vector", "offset", "far_edge", "far_edge_z4", "invalid", "pw252",
        "pw250", "shifted"])
def test_kernel_matches_plain(cuda_device, dtype, z_scale, offsets, pw,
                              shift):
    """Each instance of the kernel against the plain version, bit for
    bit."""
    logits, preds, g = (torch.tensor(a).to(cuda_device)
                        for a in _inputs(z_scale, pw=pw))
    p = torch.empty(preds.numel() + shift, dtype=dtype, device=cuda_device)
    p = p[shift:].view(preds.shape)
    p.copy_(preds)
    vector = (pw % (16 // p.element_size()) == 0 and offsets[2] % 4 == 0
              and shift == 0)
    assert _k2_vector_ok(logits, p, g.to(dtype), offsets[2]) is vector
    before = accumulate_tta_tile.launches
    got = accumulate_tta_tile(logits.clone(), p, g, offsets,
                              z_scale=z_scale)
    torch.cuda.synchronize()
    assert accumulate_tta_tile.launches == before + 1
    want = accumulate_tta_tile_plain(logits.clone(), p, g, offsets, z_scale)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if offsets[3] == 0:
        assert torch.equal(got, logits)
