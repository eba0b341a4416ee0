"""``conv_packing`` on the card (``cuda``-marked; they skip where PyTorch
sees no card) at the served forward's two sites, bf16: the stem (one
channel in, offset output, an 8-way TTA batch of (16, 320, 384) tiles)
and encoder stage 1's conv_1 (64 channels in, kd = 3, aligned output).
Each against the strided (kd, 4, 4) conv it stands for, in fp32 (TF32
off) on the same bf16 operands (0.04), and, under ``torch.profiler``, for
the kernels cuDNN runs: not its generic ``implicit_convolveNd_sgemm``,
which has no tensor cores (the strided form's stage-1 conv ran there,
68 ms a launch). No JAX here: the card's machine has none, so ``pytest
--noconftest -m cuda`` runs this file there."""

import pytest
import torch

from rehrseg_tpu_torch.ops import pack2d

# site: (x shape (B, D, H, W, Ci), weights (kd, 4, 4, Ci, 4 Co), offset_out)
SITES = {
    "stem": ((8, 16, 320, 384, 1), (1, 4, 4, 1, 128), True),
    "stage1_conv1": ((8, 16, 160, 192, 64), (3, 4, 4, 64, 256), False),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_names(fn):
    """Names of the device kernels ``fn()`` launches, from a profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_time_total > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SITES))
def test_packing_matches_fp32_off_the_generic_kernel(cuda_device,
                                                     monkeypatch, site):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x_shape, w_shape, offset_out = SITES[site]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    w4 = (torch.randn(w_shape, generator=gen, device=cuda_device)
          / (16 * w_shape[0] * w_shape[3]) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(w_shape[-1], generator=gen,
                           device=cuda_device)).to(torch.bfloat16)

    def packing():
        return pack2d.conv_packing(x, w4, b, offset_out=offset_out)

    got = packing()
    kd, p = w_shape[0], 2 if offset_out else 1
    want = pack2d.conv_general(x.float(), w4.float(), (1, 2, 2),
                               ((kd // 2, kd // 2), (p, p), (p, p)))
    want += b.float()
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want, rtol=0.04, atol=0.04)
    del got, want

    names = _kernel_names(packing)
    assert names, "the profiler recorded no device kernel"
    assert not [n for n in names if "convolveNd_sgemm" in n], names
