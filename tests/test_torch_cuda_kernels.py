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


def _int8_attention_inputs(seed, bh, sq, sk, d, mode):
    from e4t_diffusion_torch.ops.attention import int8_attention_operands

    q, k, v = _operands(seed, bh, d, sq, sk, sk)
    return int8_attention_operands(q, k + 0.7, v, d ** -0.5, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 128, 257, 80),
                                        (2, 65, 33, 8), (2, 70, 90, 120)])
def test_cuda_int8_flash_matches_reference(bh, sq, sk, d, mode):
    """The int8 kernel against its plain version at the kernel's kv tile on
    the same int8 operands."""
    from e4t_diffusion_torch.ops import flash_int8 as fi

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    qi, ki, v_op, sc = _int8_attention_inputs(3, bh, sq, sk, d, mode)
    before = fi.flash_fwd_int8.launches
    out, lse = fi.flash_fwd_int8(qi, ki, v_op, sc, mode, torch.bfloat16)
    torch.cuda.synchronize()
    assert fi.flash_fwd_int8.launches == before + 1
    ro, rl = fi.flash_fwd_int8_reference(qi, ki, v_op, sc, mode,
                                         torch.float32)
    # bf16 output rounding (~2e-3 rel-L2); exp2 in the kernel against exp in
    # the plain version moves a few round(p * 127) by one in "qkpv"
    assert ((out.float() - ro).norm() / ro.norm()).item() <= 1e-2
    assert (lse - rl).abs().max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,o,k,stride,pad,bias", [
    (2, 9, 7, 48, 40, 3, 1, 1, True),     # ragged pixels and channels
    (3, 11, 10, 32, 72, 3, 2, 1, True),   # a downsampler's stride 2
    (2, 5, 13, 16, 24, 1, 1, 0, False),   # 1x1, no bias
    (1, 8, 8, 2560, 1280, 3, 1, 1, True),  # the UNet's widest K
])
def test_cuda_int8_conv_matches_reference(n, h, w, c, o, k, stride, pad, bias,
                                          out_dtype):
    """The int8 conv kernel against its plain version: the int32 sums are
    exact and the epilogue rounds as the plain version does, so the two
    agree exactly."""
    from e4t_diffusion_torch.ops import int8_conv as ic

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randint(-127, 128, (n, h, w, c), device="cuda", generator=g,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (o, k, k, c), device="cuda", generator=g,
                       dtype=torch.int8)
    scale = torch.rand(o, device="cuda", generator=g) * 1e-4
    b = (torch.randn(o, device="cuda", generator=g).to(out_dtype)
         if bias else None)
    before = ic.int8_conv.launches
    out = ic.int8_conv(x, wt, scale, b, out_dtype, stride, pad)
    torch.cuda.synchronize()
    assert ic.int8_conv.launches == before + 1
    ref = ic.int8_conv_reference(x, wt, scale, b, out_dtype, stride, pad)
    assert out.shape == ref.shape and out.dtype == out_dtype
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 77 * 2, 4096])
def test_cuda_int8_linear_matches_cpu(rows):
    """torch._int_mm on the card (fewer than 17 rows padded, as
    time_emb_proj's batch rows are) gives the CPU's exact result."""
    from e4t_diffusion_torch.ops import quant

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(rows, 1280, generator=g)
    site = quant.quantize_kernel(torch.randn(320, 1280, generator=g))
    bias = torch.randn(320, generator=g)
    want = quant.int8_linear(x, site, bias)
    got = quant.int8_linear(x.cuda(), {k: v.cuda() for k, v in site.items()},
                            bias.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case,error", [
    ("q_float", TypeError), ("v_bf16_qkpv", TypeError),
    ("v_int8_qk", TypeError), ("d128", ValueError),
    ("noncontiguous", ValueError),
    ("conv_c24", ValueError), ("conv_x_float", TypeError),
    ("conv_out_fp16", TypeError),
])
def test_cuda_int8_wrappers_refuse_bad_operands(case, error):
    """What flash_fwd_int8 and int8_conv refuse on CUDA tensors, before any
    launch."""
    from e4t_diffusion_torch.ops import flash_int8 as fi
    from e4t_diffusion_torch.ops import int8_conv as ic

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = 128 if case == "d128" else 40
    i8 = torch.zeros(2, 64, d, device="cuda", dtype=torch.int8)
    bf = torch.zeros(2, 64, d, device="cuda", dtype=torch.bfloat16)
    sc = torch.ones(2, 2, device="cuda")
    before = fi.flash_fwd_int8.launches, ic.int8_conv.launches
    with pytest.raises(error):
        if case == "q_float":
            fi.flash_fwd_int8(bf, i8, bf, sc, "qk", torch.bfloat16)
        elif case == "v_bf16_qkpv":
            fi.flash_fwd_int8(i8, i8, bf, sc, "qkpv", torch.bfloat16)
        elif case == "v_int8_qk":
            fi.flash_fwd_int8(i8, i8, i8, sc, "qk", torch.bfloat16)
        elif case == "d128":
            fi.flash_fwd_int8(i8, i8, bf, sc, "qk", torch.bfloat16)
        elif case == "noncontiguous":
            t = torch.zeros(2, d, 64, device="cuda",
                            dtype=torch.int8).transpose(1, 2)
            fi.flash_fwd_int8(t, i8, bf, sc, "qk", torch.bfloat16)
        else:
            c = 24 if case == "conv_c24" else 32
            x = torch.zeros(1, 4, 4, c, device="cuda", dtype=torch.int8)
            if case == "conv_x_float":
                x = x.float()
            w = torch.zeros(8, 3, 3, c, device="cuda", dtype=torch.int8)
            out = torch.float16 if case == "conv_out_fp16" else torch.float32
            ic.int8_conv(x, w, torch.ones(8, device="cuda"), None, out, 1, 1)
    assert (fi.flash_fwd_int8.launches, ic.int8_conv.launches) == before
