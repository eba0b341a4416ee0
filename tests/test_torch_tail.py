"""K2 (accumulate_tta_tile): the port's plain PyTorch version against the
JAX Pallas kernel in interpret mode, on the same numpy inputs; and, on a
machine with a card, the CUDA kernel against the plain version.

JAX is imported inside the tests that compare with it: the card's machine
has no JAX, and runs the ``cuda``-marked tests of this file with
``pytest --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.ops.tail import (accumulate_tta_tile,
                                        accumulate_tta_tile_plain,
                                        zgrouped_combos)

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _jax():
    import jax.numpy as jnp
    from rehrseg_tpu.ops.pallas_tail import accumulate_tta_tile
    return jnp, accumulate_tta_tile


def _inputs(z_scale=1, seed=0):
    rng = np.random.default_rng(seed)
    C, pd, ph, pw = 2, 2, 16, 256
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z_scale,offsets", [(1, (2, 8, 128, 1)),
                                             (4, (1, 3, 5, 1))])
def test_kernel_matches_plain(cuda_device, dtype, z_scale, offsets):
    logits, preds, g = (torch.tensor(a).to(cuda_device)
                        for a in _inputs(z_scale))
    preds = preds.to(dtype)
    before = accumulate_tta_tile.launches
    got = accumulate_tta_tile(logits.clone(), preds, g, offsets,
                              z_scale=z_scale)
    torch.cuda.synchronize()
    assert accumulate_tta_tile.launches == before + 1
    want = accumulate_tta_tile_plain(logits.clone(), preds, g, offsets,
                                     z_scale)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
