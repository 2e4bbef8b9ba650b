"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing of
JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from e4t_diffusion_torch.ops import flash_lowdim as fl


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 128, 257, 80),
                                        (2, 65, 33, 8), (2, 70, 90, 120)])
def test_cuda_kernel_matches_reference(bh, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=g).bfloat16()
               for s in (sq, sk, sk))
    before = fl.flash_fwd_lowdim.launches
    out, lse = fl.flash_fwd_lowdim(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert fl.flash_fwd_lowdim.launches == before + 1
    ro, rl = fl.flash_fwd_lowdim_reference(q.float(), k.float(), v.float(),
                                           d ** -0.5)
    # bf16 output rounding: rel-L2 ~2e-3 measured; lse stays f32
    assert ((out.float() - ro).norm() / ro.norm()).item() <= 1e-2
    assert (lse - rl).abs().max().item() <= 2e-3
