"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing of
JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from e4t_diffusion_torch.ops import flash_lowdim as fl


def _operands(seed, bh, d, *lengths):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=g).bfloat16()
            for s in lengths]


def _forward_matches_reference(bh, sq, sk, d, seed, route):
    q, k, v = _operands(seed, bh, d, sq, sk, sk)
    before = dict(fl.flash_fwd.launches)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    before[route] += 1
    assert fl.flash_fwd.launches == before
    ro, rl = fl.flash_fwd_reference(q.float(), k.float(), v.float(),
                                    d ** -0.5)
    # bf16 output rounding: rel-L2 ~2e-3 measured; lse stays f32
    assert ((out.float() - ro).norm() / ro.norm()).item() <= 1e-2
    assert (lse - rl).abs().max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 128, 257, 80),
                                        (2, 65, 33, 8), (2, 70, 90, 120)])
def test_cuda_kernel_matches_reference(bh, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _forward_matches_reference(bh, sq, sk, d, 0, "lowdim")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(2, 256, 77, 160), (2, 129, 300, 256),
                                        (2, 200, 90, 136)])
def test_cuda_wide_forward_matches_reference(bh, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _forward_matches_reference(bh, sq, sk, d, 1, "wide")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 256, 77, 160),
                                        (2, 65, 33, 8), (2, 129, 300, 256)])
def test_cuda_backward_matches_reference(bh, sq, sk, d):
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, dout = _operands(2, bh, d, sq, sk, sk, sq)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    before = fb.flash_bwd.launches
    grads = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    assert fb.flash_bwd.launches == before + 1
    refs = fb.flash_bwd_reference(q.float(), k.float(), v.float(),
                                  out.float(), lse, dout.float(), d ** -0.5)
    # bf16 rounding of p, ds and the outputs: rel-L2 ~2.4e-3 measured
    for got, want in zip(grads, refs):
        assert ((got.float() - want).norm() / want.norm()).item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("operand,bad,error", [
    ("q", dict(dtype=torch.float32), TypeError),
    ("q", dict(d=36), ValueError),
    ("q", dict(d=264), ValueError),
    ("q", dict(noncontiguous=True), ValueError),
    ("dout", dict(dtype=torch.float32), TypeError),
    ("dout", dict(noncontiguous=True), ValueError),
])
def test_cuda_wrappers_refuse_bad_operands(operand, bad, error):
    """What flash_fwd and flash_bwd refuse on CUDA tensors, before any
    launch: the kernels take contiguous bf16 with D a multiple of 8 up to
    256."""
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = bad.get("d", 40)
    good = torch.zeros(2, 64, d, device="cuda", dtype=torch.bfloat16)
    t = good.to(bad.get("dtype", torch.bfloat16))
    if bad.get("noncontiguous"):
        t = torch.zeros(2, d, 64, device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
    lse = torch.zeros(2, 64, device="cuda")
    before = dict(fl.flash_fwd.launches), fb.flash_bwd.launches
    if operand == "q":
        with pytest.raises(error):
            fl.flash_fwd(t, good, good, 0.1)
        with pytest.raises(error):
            fb.flash_bwd(t, good, good, good, lse, good, 0.1)
    else:
        with pytest.raises(error):
            fb.flash_bwd(good, good, good, good, lse, t, 0.1)
    assert (fl.flash_fwd.launches, fb.flash_bwd.launches) == before
