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
@pytest.mark.parametrize("bh,sq,sk,d", [
    (4, 300, 200, 40), (2, 128, 257, 80), (2, 65, 33, 8), (2, 70, 90, 120),
    # the kv ring's edges: Sk below one stage, one stage plus one row, two
    # stages plus one, and a q tile of one row
    (2, 100, 63, 40), (2, 64, 65, 80), (3, 129, 129, 64), (2, 1, 200, 16),
    (2, 200, 1, 48)])
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


# the forward's wgmma kernel from DK 160: the tuning step's d160 sites (BH
# cut to 8), the grid shape's width at a shorter length, and ragged shapes
# at the edges of its k/v rings (4 stages at DK 160, 3 at 192 and 224, 2 at
# 256): Sk below one stage, one stage plus one row, one q row; DK 136 pads
# to 160
WGMMA_WIDE_FWD_CASES = [(8, 256, 256, 160), (8, 256, 77, 160),
                        (2, 1024, 1024, 160), (2, 100, 63, 136),
                        (2, 64, 65, 192), (2, 1, 200, 256), (2, 129, 300, 256),
                        (3, 200, 129, 224), (2, 257, 1, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", WGMMA_WIDE_FWD_CASES)
def test_cuda_wgmma_wide_forward_matches_reference_and_sync(bh, sq, sk, d):
    """The wgmma forward from d = 128 against the plain version and against
    the synchronous design it replaced there, within the same bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _forward_matches_reference(bh, sq, sk, d, 3, "wide")
    q, k, v = _operands(3, bh, d, sq, sk, sk)
    out, _ = fl.flash_fwd(q, k, v, d ** -0.5)
    sync, _ = fl.flash_fwd_sync(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert ((out.float() - sync.float()).norm()
            / sync.float().norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 256, 77, 160),
                                        (2, 65, 33, 8), (2, 129, 300, 256)])
def test_cuda_backward_matches_reference(bh, sq, sk, d):
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, dout = _operands(2, bh, d, sq, sk, sk, sq)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    before = fb.flash_bwd.launches["bf16"]
    grads = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    assert fb.flash_bwd.launches["bf16"] == before + 1
    refs = fb.flash_bwd_reference(q.float(), k.float(), v.float(),
                                  out.float(), lse, dout.float(), d ** -0.5)
    # bf16 rounding of p, ds and the outputs: rel-L2 ~2.4e-3 measured
    for got, want in zip(grads, refs):
        assert ((got.float() - want).norm() / want.norm()).item() <= 2e-2


# the d < 128 backward runs on wgmma kernels: the tuning step's sites (BH
# cut to 8), ragged Sq and Sk that are multiples of no tile, one q row, and
# BH 48 at Sk 1000, which takes the dk/dv kernel's blocks of several
# warpgroups at a ragged Sk (fewer heads or kv rows take 1 warpgroup a block)
WGMMA_BWD_CASES = [(8, 4096, 4096, 40), (8, 4096, 77, 40), (8, 1024, 1024, 80),
                   (8, 1024, 77, 80), (2, 300, 77, 40), (2, 129, 200, 80),
                   (2, 65, 257, 40), (3, 1, 130, 80), (48, 300, 1000, 40),
                   (48, 129, 1000, 80), (2, 200, 300, 64), (2, 100, 90, 112)]
# from d = 128: the tuning step's d160 sites (BH cut to 8), the grid shape's
# width at a shorter length, and ragged shapes at the edges of the rings
# (the dk/dv kernel's q/dO ring of 64-row tiles, 3 stages, 2 at DK 224 and
# 256; the dq kernel's k/v ring, 4 stages at DK 128, 3 at 160, 2 above): Sq
# or Sk below one tile, one tile plus one row, one q row, two kv rows (with
# one, dq = ds k is zero up to rounding, and its rel-L2 measures noise);
# DK 136 pads to 160
WGMMA_WIDE_BWD_CASES = [(8, 256, 256, 160), (8, 256, 77, 160),
                        (2, 1024, 1024, 160), (2, 63, 65, 136),
                        (2, 65, 63, 192), (3, 1, 130, 256), (2, 129, 300, 224),
                        (2, 200, 2, 128), (2, 300, 77, 256), (2, 257, 129, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", WGMMA_BWD_CASES + WGMMA_WIDE_BWD_CASES)
def test_cuda_wgmma_backward_matches_reference_and_sync(bh, sq, sk, d):
    """The wgmma backward against the plain version and against the
    synchronous design it replaced, within the same bound; two calls on the
    same inputs bit-identical (no atomics)."""
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, dout = _operands(12, bh, d, sq, sk, sk, sq)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    grads = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    again = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    sync = fb.flash_bwd_sync(q, k, v, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    refs = fb.flash_bwd_reference(q.float(), k.float(), v.float(),
                                  out.float(), lse, dout.float(), d ** -0.5)
    for got, rep, old, want in zip(grads, again, sync, refs):
        assert torch.equal(got, rep)
        assert ((got.float() - want).norm() / want.norm()).item() <= 2e-2
        assert ((got.float() - old.float()).norm()
                / old.float().norm()).item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("operand,bad,error", [
    ("q", dict(dtype=torch.float16), TypeError),
    ("q", dict(d=36), ValueError),
    ("q", dict(d=264), ValueError),
    ("q", dict(noncontiguous=True), ValueError),
    ("dout", dict(dtype=torch.float32), TypeError),
    ("dout", dict(noncontiguous=True), ValueError),
])
def test_cuda_wrappers_refuse_bad_operands(operand, bad, error):
    """What flash_fwd and flash_bwd refuse on CUDA tensors, before any
    launch: the kernels take contiguous bf16 or f32 (one type for every
    operand) with D a multiple of 8 up to 256."""
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
    before = dict(fl.flash_fwd.launches), dict(fb.flash_bwd.launches)
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
    before = fi.flash_fwd_int8.launches["bf16"]
    out, lse = fi.flash_fwd_int8(qi, ki, v_op, sc, mode, torch.bfloat16)
    torch.cuda.synchronize()
    assert fi.flash_fwd_int8.launches["bf16"] == before + 1
    ro, rl = fi.flash_fwd_int8_reference(qi, ki, v_op, sc, mode,
                                         torch.float32)
    # bf16 output rounding (~2e-3 rel-L2); exp2 in the kernel against exp in
    # the plain version moves a few round(p * 127) by one in "qkpv"
    assert ((out.float() - ro).norm() / ro.norm()).item() <= 1e-2
    assert (lse - rl).abs().max().item() <= 2e-3


# the int8 kernel at the route's quant tiles (128, 256, 512), ragged Sq and
# Sk (Sk 1100: a last quant tile of 76 rows), one q row, D 40, 80, 120
INT8_TILE_CASES = [(2, 300, 1100, 40, 512), (3, 129, 700, 80, 256),
                   (2, 65, 300, 120, 128), (2, 257, 1024, 80, 512),
                   (1, 1, 130, 40, 128), (3, 200, 4096, 40, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("bh,sq,sk,d,tile", INT8_TILE_CASES)
def test_cuda_int8_flash_tiles_match_reference_and_sync(bh, sq, sk, d, tile,
                                                        mode):
    """The int8 kernel at a quant tile against its plain version at that
    tile and against the synchronous design (which counts no launch); a
    second call equal to the first bit for bit."""
    from e4t_diffusion_torch.ops import flash_int8 as fi

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ops = _int8_attention_inputs(5, bh, sq, sk, d, mode)
    before = fi.flash_fwd_int8.launches["bf16"]
    out, lse = fi.flash_fwd_int8(*ops, mode, torch.bfloat16, tile)
    again, _ = fi.flash_fwd_int8(*ops, mode, torch.bfloat16, tile)
    sync, _ = fi.flash_fwd_int8_sync(*ops, mode, torch.bfloat16, tile)
    torch.cuda.synchronize()
    assert fi.flash_fwd_int8.launches["bf16"] == before + 2
    assert torch.equal(out, again)
    ro, rl = fi.flash_fwd_int8_reference(*ops, mode, torch.float32, tile)
    assert _rel(out, ro) <= 1e-2
    assert (lse - rl).abs().max().item() <= 2e-3
    assert _rel(out, sync.float()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,o,k,stride,pad,bias", [
    (2, 9, 7, 48, 40, 3, 1, 1, True),     # ragged pixels and channels
    (3, 11, 10, 32, 72, 3, 2, 1, True),   # a downsampler's stride 2
    (2, 5, 13, 16, 24, 1, 1, 0, False),   # 1x1, no bias
    (1, 8, 8, 2560, 1280, 3, 1, 1, True),  # the UNet's widest K (split)
    (8, 16, 16, 640, 1280, 3, 1, 1, True),  # a split in two parts
    (2, 64, 64, 320, 320, 3, 2, 1, True),  # a UNet downsampler
])
def test_cuda_int8_conv_matches_reference(n, h, w, c, o, k, stride, pad, bias,
                                          out_dtype):
    """The int8 conv kernel against its plain version and the synchronous
    design it replaced: the int32 sums are exact and the epilogue rounds as
    the plain version does, so the three agree exactly."""
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
    assert torch.equal(out, ic.int8_conv_sync(x, wt, scale, b, out_dtype,
                                              stride, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac", "sa_halfway"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,o,k,stride,pad", [
    (2, 9, 7, 48, 40, 3, 1, 1),     # ragged pixels and channels
    (3, 11, 10, 32, 72, 3, 2, 1),   # stride 2
    (2, 5, 13, 4, 24, 1, 1, 0),     # conv_in's 4 channels, zero-filled
    (8, 8, 8, 1280, 1280, 3, 1, 1),  # a split UNet site
])
def test_cuda_int8_conv_act_matches_reference(n, h, w, c, o, k, stride, pad,
                                              dtype, layout, mode):
    """The conv site's route (``quant.int8_conv2d``: the activation
    quantized in the kernel's loads) against the plain version
    (``quantize_activation_reference``, the NHWC permute, the conv's plain
    version) and, where C is a multiple of 16, the synchronous design on
    the same int8 operand: bit for bit. "sa_halfway" feeds exact half-way
    quotients x = (k + 0.5) s, which the kernel must round half to even
    through its IEEE fallback."""
    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(6)
    x = torch.randn(n, c, h, w, device="cuda", generator=g).to(dtype)
    if mode == "sa_halfway":  # exact in bf16 too: |k + 0.5| < 128
        x = ((torch.randint(-127, 127, x.shape, device="cuda", generator=g)
              + 0.5) / 16).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    site = quant.quantize_kernel(torch.randn(o, c, k, k, device="cuda",
                                             generator=g))
    site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
    if mode == "sa":
        site["sa"] = x.float().abs().amax() * 0.7 / 127.0
    elif mode == "sa_halfway":
        site["sa"] = torch.tensor(1 / 16, device="cuda")
    elif mode == "sac":
        site["sac"] = (x.float().abs().amax(dim=(0, 2, 3)) + 0.1) / 127.0
    bias = torch.randn(o, device="cuda", generator=g).to(dtype)
    before = ic.int8_conv_act.launches
    out = quant.int8_conv2d(x, site, bias, stride, pad)
    torch.cuda.synchronize()
    assert ic.int8_conv_act.launches == before + 1
    xq, sx = quant.quantize_activation_reference(x, site, 1)
    xq = xq.permute(0, 2, 3, 1)
    q = site["q"]
    if c % 16:
        xq, q = (torch.nn.functional.pad(t, (0, 16 - c % 16)) for t in (xq, q))
    scale = (sx * site["s"]).float()
    ref = ic.int8_conv_reference(xq, q, scale, bias, dtype, stride, pad)
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.equal(out, ref)
    if c % 16 == 0:
        assert torch.equal(out, ic.int8_conv_sync(xq.contiguous(), q, scale,
                                                  bias, dtype, stride, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 77, 768), (4096, 320), (3, 5, 36),
                                   (7, 1)])
def test_cuda_quantize_activation_matches_reference(shape, dtype, mode):
    """The linear sites' one-pass quantization kernel against its plain
    version, bit for bit, on inputs with exact half-way quotients (the
    rounding is half to even); (3, 5, 36) and (7, 1) take the kernel's
    one-element path."""
    from e4t_diffusion_torch.ops import quant

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(7)
    x = torch.randn(shape, device="cuda", generator=g)
    s = x.abs().amax() / 127.0
    half = (torch.randint(-130, 130, shape, device="cuda", generator=g)
            + 0.5) * s
    x = torch.where(torch.rand(shape, device="cuda", generator=g) < 0.3,
                    half, x).to(dtype)
    site = {"sa": {"sa": s}, "dynamic": {},
            "sac": {"sac": x.float().abs().amax(
                dim=tuple(range(x.dim() - 1))).clamp(min=1e-3) / 127.0}}[mode]
    before = quant.quantize_activation.launches
    q, sx = quant.quantize_activation(x, site, -1)
    torch.cuda.synchronize()
    assert quant.quantize_activation.launches == before + 1
    qr, sr = quant.quantize_activation_reference(x, site, -1)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert torch.equal(q, qr) and torch.equal(sx, sr)


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
    before = dict(fi.flash_fwd_int8.launches), ic.int8_conv.launches
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


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("n,c,h,w,groups,dtype,act", [
    (2, 320, 64, 64, 32, torch.bfloat16, "silu"),  # UNet level 0, cached
    (1, 960, 64, 64, 32, torch.bfloat16, None),    # 240 KB group: re-read
    (2, 128, 256, 256, 32, torch.bfloat16, "silu"),  # a VAE decode stage
    (3, 40, 7, 9, 8, torch.bfloat16, "silu"),      # odd H*W and C/G
    (2, 64, 5, 5, 64, torch.float32, "silu"),      # C/G = 1, odd H*W
    (1, 128, 16, 16, 32, torch.float32, None),     # f32, vectors
])
def test_cuda_group_norm_matches_reference(n, c, h, w, groups, dtype, act,
                                           layout):
    """The GroupNorm kernel against its plain version in f32 on the same
    inputs, NCHW and channels-last (the output keeps the layout)."""
    from e4t_diffusion_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(6)
    x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2 + 0.5).to(
        dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    # weight and bias in x's dtype, as the modules hold them
    weight = (torch.rand(c, device="cuda", generator=g) + 0.5).to(dtype)
    bias = torch.randn(c, device="cuda", generator=g).to(dtype)
    before = gn.fused_group_norm.launches
    out = gn.fused_group_norm(x, weight, bias, groups, 1e-5, act)
    torch.cuda.synchronize()
    assert gn.fused_group_norm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert out.stride() == x.stride()
    ref = gn.group_norm_reference(x.float(), weight, bias, groups, 1e-5, act)
    if dtype == torch.bfloat16:
        # bf16 output rounding: ~2e-3 rel-L2
        assert ((out.float() - ref).norm() / ref.norm()).item() <= 1e-2
    else:
        # f32 sums in another order than the plain version's
        assert (out - ref).abs().max().item() <= 1e-4


# The GroupNorm kernel at C/G 1, 3, 4, 5, 10, 40, 65 and 80, odd H*W, n
# from 1 to 16; channels-last x from 12 MB takes the cooperative kernel
# (every case here in f32, all but the two small ones in bf16), with pixels
# of more than one channel chunk at 2560 and 2600 channels (2600 leaves the
# last chunk a column short) and a tensor larger than the 50 MB L2 (2 x 128
# x 512 x 512 bf16, 134 MB)
GN_CASES = [(1, 32, 7, 9, 32), (3, 40, 7, 9, 8), (2, 320, 64, 64, 32),
            (8, 64, 129, 131, 64), (2, 96, 257, 255, 32),
            (16, 128, 64, 64, 32), (3, 40, 301, 299, 8),
            (8, 320, 64, 64, 32), (8, 1280, 32, 32, 32),
            (8, 2560, 32, 32, 32), (2, 2600, 40, 40, 40),
            (1, 128, 512, 256, 32), (2, 128, 512, 512, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("n,c,h,w,groups", GN_CASES)
def test_cuda_group_norm_matches_reference_and_sync(n, c, h, w, groups,
                                                    layout, dtype):
    """The GroupNorm kernel against its plain version in f32 and against its
    first design (group_norm_sync, the yardstick), both in the tolerance of
    the output type; two calls give the same bits (no float atomics)."""
    from e4t_diffusion_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(8)
    x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2 + 0.5).to(
        dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    weight = (torch.rand(c, device="cuda", generator=g) + 0.5).to(dtype)
    bias = torch.randn(c, device="cuda", generator=g).to(dtype)
    act = "silu" if c % 64 else None
    before = gn.fused_group_norm.launches
    out = gn.fused_group_norm(x, weight, bias, groups, 1e-5, act)
    again = gn.fused_group_norm(x, weight, bias, groups, 1e-5, act)
    sync = gn.group_norm_sync(x, weight, bias, groups, 1e-5, act)
    torch.cuda.synchronize()
    assert gn.fused_group_norm.launches == before + 2
    assert out.stride() == x.stride()
    assert torch.equal(out, again)
    ref = gn.group_norm_reference(x.float(), weight, bias, groups, 1e-5, act)
    for want in (ref, sync.float()):
        if dtype == torch.bfloat16:
            assert ((out.float() - want).norm() / want.norm()).item() <= 1e-2
        else:
            assert (out - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_fused_group_norm_gradients():
    """FusedGroupNorm on the card: the kernel forward, and gradients equal
    to autograd through F.group_norm + F.silu."""
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(7)
    x = torch.randn(2, 64, 16, 16, device="cuda", generator=g,
                    requires_grad=True)
    weight = (torch.rand(64, device="cuda", generator=g) + 0.5
              ).requires_grad_()
    bias = torch.randn(64, device="cuda", generator=g, requires_grad=True)
    cot = torch.randn(2, 64, 16, 16, device="cuda", generator=g)
    got = torch.autograd.grad(
        (gn.FusedGroupNorm.apply(x, weight, bias, 8, 1e-5, "silu") * cot)
        .sum(), (x, weight, bias))
    want = torch.autograd.grad(
        (F.silu(F.group_norm(x, 8, weight, bias, 1e-5)) * cot).sum(),
        (x, weight, bias))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,g", [
    (8, 257, 80, 8),    # the ViT-H site, scaled down
    (4, 129, 8, 2),     # the shortest routed sequence
    (2, 200, 40, 1),
    (2, 384, 64, 2),
    (2, 512, 120, 2),   # the longest sequence, the widest head
])
def test_cuda_shortseq_matches_reference(bh, s, d, g):
    """The short-sequence kernel against its plain version in f32 on the
    same bf16 inputs."""
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _operands(8, bh, d, s, s, s)
    before = shortseq.flash_fwd_shortseq.launches["bf16"]
    out = shortseq.flash_fwd_shortseq(q, k, v, d ** -0.5, g)
    torch.cuda.synchronize()
    assert shortseq.flash_fwd_shortseq.launches["bf16"] == before + 1
    ref = shortseq.flash_fwd_shortseq_reference(q.float(), k.float(),
                                                v.float(), d ** -0.5)
    # bf16 rounding of p and of the output: ~2e-3 rel-L2
    assert ((out.float() - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("s", [129, 257, 384, 512])
@pytest.mark.parametrize("bh,d", [(3, 8), (4, 80), (5, 120)])
def test_cuda_shortseq_matches_reference_and_sync(bh, s, d):
    """The short-sequence kernel against its plain version and the
    synchronous design (which counts no launch) on the same bf16 inputs; a
    second call equal to the first bit for bit."""
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _operands(11, bh, d, s, s, s)
    g = 1
    before = shortseq.flash_fwd_shortseq.launches["bf16"]
    out = shortseq.flash_fwd_shortseq(q, k, v, d ** -0.5, g)
    again = shortseq.flash_fwd_shortseq(q, k, v, d ** -0.5, g)
    sync = shortseq.flash_fwd_shortseq_sync(q, k, v, d ** -0.5, g)
    torch.cuda.synchronize()
    assert shortseq.flash_fwd_shortseq.launches["bf16"] == before + 2
    assert torch.equal(out, again)
    ref = shortseq.flash_fwd_shortseq_reference(q.float(), k.float(),
                                                v.float(), d ** -0.5)
    assert _rel(out, ref) <= 1e-2
    assert _rel(out, sync.float()) <= 1e-2


@pytest.mark.cuda
def test_cuda_attention_routes_vit_sites_to_shortseq(monkeypatch):
    """With E4T_SHORTSEQ_MH_ATTN set, a 257-token d=80 self-attention site
    on the card runs the short-sequence kernel, also under
    flash_threshold(0); without it, einsum (or flash under the override)."""
    from e4t_diffusion_torch.ops import attention, shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = (t.reshape(2, 4, 257, 80) for t in _operands(9, 8, 80, 257,
                                                           257, 257))
    counts = lambda: (shortseq.flash_fwd_shortseq.launches["bf16"],  # noqa: E731
                      fl.flash_fwd.launches["lowdim"])
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "8")
    before = counts()
    out = attention.dot_product_attention(q, k, v)
    with attention.flash_threshold(0):
        attention.dot_product_attention(q, k, v)
    assert counts() == (before[0] + 2, before[1])
    ref = attention.einsum_attention(q.float(), k.float(), v.float())
    assert ((out.float() - ref).norm() / ref.norm()).item() <= 1e-2
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "0")
    with attention.flash_threshold(0):
        attention.dot_product_attention(q, k, v)
    assert counts() == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case,error", [
    ("gn_fp16", TypeError), ("gn_noncontiguous", ValueError),
    ("ss_float", TypeError), ("ss_s513", ValueError),
    ("ss_d136", ValueError), ("ss_g3", ValueError),
])
def test_cuda_gn_shortseq_refuse_bad_operands(case, error):
    """What fused_group_norm and flash_fwd_shortseq refuse on CUDA tensors,
    before any launch."""
    from e4t_diffusion_torch.ops import groupnorm as gn
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = (gn.fused_group_norm.launches,
              dict(shortseq.flash_fwd_shortseq.launches))
    ones = torch.ones(32, device="cuda")
    with pytest.raises(error):
        if case.startswith("gn"):
            x = torch.zeros(2, 32, 8, 8, device="cuda")
            # fp16; or a layout neither NCHW nor channels-last
            x = x.half() if case == "gn_fp16" else x.transpose(2, 3)
            gn.fused_group_norm(x, ones, ones, 8, 1e-5)
        else:
            s = 513 if case == "ss_s513" else 257
            d = 136 if case == "ss_d136" else 80
            t = torch.zeros(4, s, d, device="cuda", dtype=torch.bfloat16)
            if case == "ss_float":  # f16: the kernels take bf16 or f32
                t = t.half()
            shortseq.flash_fwd_shortseq(t, t, t, 0.1,
                                        3 if case == "ss_g3" else 2)
    assert (gn.fused_group_norm.launches,
            shortseq.flash_fwd_shortseq.launches) == before


@pytest.mark.cuda
def test_cuda_launch_raises_on_entry_point_error():
    """A C entry point's non-zero return (here cudaErrorInvalidValue for
    BH = 0, which no wrapper passes) raises with the CUDA error's text."""
    import ctypes

    from e4t_diffusion_torch.ops import _build, shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with pytest.raises(RuntimeError, match="e4t_flash_fwd_shortseq launch "
                                           "failed: invalid argument"):
        _build.launch(shortseq.SOURCE, "e4t_flash_fwd_shortseq",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_float], torch.device("cuda"),
                      None, None, None, None, 0, 257, 80, 0.1)


# f32 kernels (csrc/attention_f32.cu) against their plain versions in f32:
# full f32 FFMA on both sides, the sums in another order
F32_REL_L2 = 1e-5
F32_CASES = [(2, 300, 200, 40), (2, 128, 257, 80), (2, 65, 33, 8),
             (2, 70, 90, 120), (2, 200, 77, 160), (2, 129, 300, 256),
             (2, 100, 63, 40), (2, 64, 65, 80), (2, 33, 97, 256)]


def _f32_operands(seed, bh, d, *lengths):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=g)
            for s in lengths]


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", F32_CASES)
def test_cuda_f32_forward_matches_reference(bh, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(10, bh, d, sq, sk, sk)
    route = fl.launch_route(d, torch.float32)
    before = dict(fl.flash_fwd.launches)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    before[route] += 1
    assert fl.flash_fwd.launches == before
    ro, rl = fl.flash_fwd_reference(q, k, v, d ** -0.5)
    assert out.dtype == torch.float32
    assert _rel(out, ro) <= F32_REL_L2 and _rel(lse, rl) <= F32_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", F32_CASES)
def test_cuda_f32_backward_matches_reference(bh, sq, sk, d):
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, dout = _f32_operands(11, bh, d, sq, sk, sk, sq)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    before = dict(fb.flash_bwd.launches)
    grads = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    before["f32"] += 1
    assert fb.flash_bwd.launches == before
    refs = fb.flash_bwd_reference(q, k, v, out, lse, dout, d ** -0.5)
    for got, want in zip(grads, refs):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= F32_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,g", [(8, 257, 80, 8), (4, 129, 8, 2),
                                      (2, 200, 40, 1), (2, 512, 120, 2),
                                      (2, 65, 64, 1)])
def test_cuda_f32_shortseq_matches_reference(bh, s, d, g):
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(12, bh, d, s, s, s)
    before = dict(shortseq.flash_fwd_shortseq.launches)
    out = shortseq.flash_fwd_shortseq(q, k, v, d ** -0.5, g)
    torch.cuda.synchronize()
    before["f32"] += 1
    assert shortseq.flash_fwd_shortseq.launches == before
    ref = shortseq.flash_fwd_shortseq_reference(q, k, v, d ** -0.5)
    assert _rel(out, ref) <= F32_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 200, 40), (2, 128, 257, 80),
                                        (2, 65, 33, 8), (2, 70, 90, 120)])
def test_cuda_int8_f32_matches_reference(bh, sq, sk, d, mode):
    """The int8 attention with an f32 output (and in "qk" an f32 v) against
    its plain version on the same int8 operands: "qk" in full f32 to
    F32_REL_L2; "qkpv" to the bf16 kernel's bound, since exp2 against exp
    moves a few round(p * 127) by one whatever the output type."""
    from e4t_diffusion_torch.ops.attention import int8_attention_operands
    from e4t_diffusion_torch.ops import flash_int8 as fi

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(13, bh, d, sq, sk, sk)
    ops = int8_attention_operands(q, k + 0.7, v, d ** -0.5, mode)
    before = dict(fi.flash_fwd_int8.launches)
    out, lse = fi.flash_fwd_int8(*ops, mode, torch.float32)
    torch.cuda.synchronize()
    before[f"{mode}_f32"] += 1
    assert fi.flash_fwd_int8.launches == before
    ro, rl = fi.flash_fwd_int8_reference(*ops, mode, torch.float32)
    assert out.dtype == torch.float32
    assert _rel(out, ro) <= (F32_REL_L2 if mode == "qk" else 1e-2)
    assert (lse - rl).abs().max().item() <= 1e-4


# the int8 "qk" f32 kernel at d 8, 40, 80 and 120, Sq and Sk one row either
# side of 64 and 128, Sk below one 64-row tile, one q row
INT8_F32_EDGE_CASES = [(2, 63, 65, 8), (2, 65, 63, 40), (2, 127, 129, 80),
                       (2, 129, 127, 120), (3, 65, 129, 40), (2, 1, 63, 80),
                       (2, 129, 33, 120), (2, 300, 200, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", INT8_F32_EDGE_CASES)
def test_cuda_int8_qk_f32_edges_match_reference_and_sync(bh, sq, sk, d):
    """The int8 "qk" attention with an f32 v and output against its plain
    version and against its synchronous design (the yardstick), out to
    F32_REL_L2 and lse to 1e-4; the yardstick counts no launch."""
    from e4t_diffusion_torch.ops.attention import int8_attention_operands
    from e4t_diffusion_torch.ops import flash_int8 as fi

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(17, bh, d, sq, sk, sk)
    ops = int8_attention_operands(q, k + 0.7, v, d ** -0.5, "qk")
    before = dict(fi.flash_fwd_int8.launches)
    out, lse = fi.flash_fwd_int8(*ops, "qk", torch.float32)
    sync_out, sync_lse = fi.flash_fwd_int8_sync(*ops, "qk", torch.float32)
    torch.cuda.synchronize()
    before["qk_f32"] += 1
    assert fi.flash_fwd_int8.launches == before
    ro, rl = fi.flash_fwd_int8_reference(*ops, "qk", torch.float32)
    for want_out, want_lse in ((ro, rl), (sync_out, sync_lse)):
        assert _rel(out, want_out) <= F32_REL_L2
        assert (lse - want_lse).abs().max().item() <= 1e-4


# the register-blocked f32 kernels at their tile edges: 64-row q and kv tiles
# (Sq and Sk at 63, 65, 127, 129) and D computed unpadded up to 128, by 32
# above (8, 40, 136, 256); held against the plain version and against the
# synchronous design they replaced (their yardstick), both to F32_REL_L2
F32_EDGE_CASES = [(2, 63, 65, 8), (2, 65, 63, 40), (2, 127, 129, 136),
                  (2, 129, 127, 256), (3, 65, 129, 40), (2, 129, 65, 80),
                  (2, 1, 63, 40), (2, 127, 1, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", F32_EDGE_CASES)
def test_cuda_f32_forward_edges_match_reference_and_sync(bh, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(14, bh, d, sq, sk, sk)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    sync_out, sync_lse = fl.flash_fwd_f32_sync(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ro, rl = fl.flash_fwd_reference(q, k, v, d ** -0.5)
    assert _rel(out, ro) <= F32_REL_L2 and _rel(lse, rl) <= F32_REL_L2
    assert _rel(out, sync_out) <= F32_REL_L2
    assert _rel(lse, sync_lse) <= F32_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", F32_EDGE_CASES)
def test_cuda_f32_backward_edges_match_reference_and_sync(bh, sq, sk, d):
    from e4t_diffusion_torch.ops import flash_bwd as fb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, dout = _f32_operands(15, bh, d, sq, sk, sk, sq)
    out, lse = fl.flash_fwd(q, k, v, d ** -0.5)
    grads = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    again = fb.flash_bwd(q, k, v, out, lse, dout, d ** -0.5)
    sync = fb.flash_bwd_f32_sync(q, k, v, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    refs = fb.flash_bwd_reference(q, k, v, out, lse, dout, d ** -0.5)
    for name, got, want, yard, rerun in zip("q k v".split(), grads, refs,
                                            sync, again):
        assert torch.equal(got, rerun)  # no atomics: deterministic
        # one kv row: p = 1, so ds = dP - delta = 0 and dq, dk are zero up
        # to rounding
        if sk > 1 or name == "v":
            assert _rel(got, want) <= F32_REL_L2
            assert _rel(got, yard) <= F32_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,g", [(2, 257, 80, 1), (2, 258, 80, 2),
                                      (4, 257, 40, 4), (2, 258, 8, 1),
                                      (2, 63, 128, 1), (2, 129, 120, 1)])
def test_cuda_f32_shortseq_edges_match_reference_and_sync(bh, s, d, g):
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = _f32_operands(16, bh, d, s, s, s)
    out = shortseq.flash_fwd_shortseq(q, k, v, d ** -0.5, g)
    sync = shortseq.flash_fwd_shortseq_f32_sync(q, k, v, d ** -0.5, g)
    torch.cuda.synchronize()
    ref = shortseq.flash_fwd_shortseq_reference(q, k, v, d ** -0.5)
    assert _rel(out, ref) <= F32_REL_L2
    assert _rel(out, sync) <= F32_REL_L2


@pytest.mark.cuda
def test_cuda_f32_yardsticks_refuse_bf16_and_count_no_launch():
    from e4t_diffusion_torch.ops import flash_bwd as fb
    from e4t_diffusion_torch.ops import shortseq

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q = torch.zeros(2, 64, 40, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(2, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fl.flash_fwd_f32_sync(q, q, q, 0.1)
    with pytest.raises(TypeError, match="float32"):
        fb.flash_bwd_f32_sync(q, q, q, q, lse, q, 0.1)
    with pytest.raises(TypeError, match="float32"):
        shortseq.flash_fwd_shortseq_f32_sync(q, q, q, 0.1, 2)
    q = q.float()
    counts = (dict(fl.flash_fwd.launches), dict(fb.flash_bwd.launches),
              dict(shortseq.flash_fwd_shortseq.launches))
    out, lse = fl.flash_fwd_f32_sync(q, q, q, 0.1)
    fb.flash_bwd_f32_sync(q, q, q, out, lse, q, 0.1)
    shortseq.flash_fwd_shortseq_f32_sync(q, q, q, 0.1, 2)
    torch.cuda.synchronize()
    assert counts == (fl.flash_fwd.launches, fb.flash_bwd.launches,
                      shortseq.flash_fwd_shortseq.launches)
