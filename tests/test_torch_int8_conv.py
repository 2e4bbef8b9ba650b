"""The int8 conv route with the activation quantized in the kernel's loads
(``ops/int8_conv.int8_conv_act``) and the linear sites' one-pass
quantization (``ops/quant.quantize_activation``), on the CPU, where each
runs its plain version: against the route they replace (the PyTorch
quantization, the NHWC permute, the conv's plain version), bit for bit, and
against the JAX package's ``quant.int8_conv`` / ``_quantize_activation``.
Inputs are numpy-seeded. The wrappers' refusals are checked before any
launch, on the CPU and on the meta device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e4t_diffusion_tpu.ops import quant as jq

from e4t_diffusion_torch.ops import int8_conv as ic
from e4t_diffusion_torch.ops import quant

from torch_parity import rel_l2

CONVS = [(3, 1, 1), (3, 2, 1), (1, 1, 0)]  # (kernel, stride, padding)


def _conv_site(rng, c, o, k, mode, x):
    """A port conv site (OHWI int8 weight) in scale mode ``mode``,
    calibrated on ``x`` (NCHW) as ``quantize_params`` would."""
    w = torch.from_numpy((rng.standard_normal((o, c, k, k)) / 9)
                         .astype(np.float32))
    amax_c = x.float().abs().amax(dim=(0, 2, 3))
    act_amax = {"s": {"amax": x.float().abs().amax() * 0.8,
                      "amax_c": amax_c * 0.8}}
    site = quant.quantize_params(
        {"s.weight": w}, act_amax=None if mode == "dynamic" else act_amax,
        exclude=(), static_exclude=(), act_pc=mode == "sac")["s"]
    return site


def _old_route(x, site, bias, stride, pad):
    """The route the fused kernel replaced: quantize_activation, the NHWC
    permute, channels zero-padded to 16, the conv's plain version."""
    xq, sx = quant.quantize_activation_reference(x, site, 1)
    xq = xq.permute(0, 2, 3, 1)
    q = site["q"]
    extra = -xq.shape[3] % ic.CHANNEL_ALIGN
    if extra:
        xq, q = F.pad(xq, (0, extra)), F.pad(q, (0, extra))
    return ic.int8_conv_reference(xq, q, (sx * site["s"]).float(), bias,
                                  x.dtype, stride, pad)


@pytest.mark.parametrize("c", [4, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,stride,pad", CONVS)
@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac"])
def test_int8_conv_act_reference_is_the_old_route(mode, k, stride, pad,
                                                  dtype, c):
    """``quant.int8_conv2d`` (through ``int8_conv_act``, whose CPU path is
    ``int8_conv_act_reference``) equals quantize_activation + the NHWC
    permute + int8_conv_reference bit for bit, C = 4 (zero-filled to 16)
    and 32, every scale mode, bf16 and f32 x."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, c, 9, 7))
                         .astype(np.float32)).to(dtype)
    site = _conv_site(rng, c, 24, k, mode, x)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32)
                            ).to(dtype)
    got = quant.int8_conv2d(x, site, bias, stride, pad)
    want = _old_route(x, site, bias, stride, pad)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    # and the entry point called directly, on the padded weight
    q = F.pad(site["q"], (0, -c % ic.CHANNEL_ALIGN))
    act = site.get("sac", site.get("sa"))
    if act is None:
        act = quant.dynamic_scale(x)
    direct = ic.int8_conv_act(x, q, act.reshape(-1), mode == "sac",
                              site["s"], bias, stride, pad)
    assert torch.equal(direct, want)


@pytest.mark.parametrize("k,stride,pad", CONVS)
@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac"])
def test_int8_conv_act_reference_matches_jax(mode, k, stride, pad):
    """``int8_conv_act_reference`` against the JAX package's
    ``quant.int8_conv`` on the same weights and scales: the int8 operands
    and the int32 sums are exact, the outputs agree to f32 rounding of the
    rescale."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, 7, 32)).astype(np.float32)  # NHWC
    w = (rng.standard_normal((k, k, 32, 40)) / 17).astype(np.float32)
    a = np.abs(x)
    calib = None if mode == "dynamic" else {"s": {
        "amax": jnp.float32(a.max() * 0.8),
        "amax_c": jnp.asarray(a.max(axis=(0, 1, 2)) * 0.8)}}
    jk = jq.quantize_params({"s": {"kernel": jnp.asarray(w)}}, act_amax=calib,
                            act_pc=mode == "sac", exclude=(),
                            static_exclude=())["s"]["kernel"]
    q = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jk["q"]).transpose(3, 0, 1, 2)))
    s = torch.from_numpy(np.array(jk["s"]))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if mode == "dynamic":
        act = quant.dynamic_scale(xt)
    else:
        act = torch.from_numpy(np.array(jk["sac" if mode == "sac" else "sa"]))
    pads = ((pad, pad), (pad, pad))
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jk, (stride, stride), pads,
                                  jnp.float32)).transpose(0, 3, 1, 2)
    got = ic.int8_conv_act_reference(xt, q, act.reshape(-1), mode == "sac",
                                     s, None, stride, pad)
    xq, _ = jq._quantize_activation(jnp.asarray(x), jk)
    shape = (1, -1, 1, 1) if mode == "sac" else ()
    port_xq = ic.quantize_values(xt, act.reshape(shape))
    np.testing.assert_array_equal(port_xq.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(xq))
    acc = jax.lax.conv_general_dilated(
        xq, jk["q"], (stride, stride), pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got_acc = ic.int8_conv_reference(port_xq.permute(0, 2, 3, 1), q,
                                     torch.ones(40), None, torch.float64,
                                     stride, pad)
    np.testing.assert_array_equal(got_acc.numpy(),
                                  np.asarray(acc).transpose(0, 3, 1, 2))
    assert rel_l2(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac"])
def test_quantize_activation_reference_matches_jax_half_way(mode, dtype):
    """``quantize_activation_reference`` (the CPU path of
    ``quantize_activation``) against JAX's ``_quantize_activation`` on
    inputs that hold exact half-way quotients x = (k + 0.5) s: both round
    half to even, so k + 0.5 goes to the even neighbour, and the clamp
    holds at +-127."""
    rng = np.random.default_rng(13)
    s = np.float32(0.0625)  # a power of two: (k + 0.5) s and x / s exact
    k = rng.integers(-127, 127, (7, 16))
    x = np.zeros((3, 7, 16), np.float32)
    x[0] = (k + 0.5) * s
    x[0, 0, 0] = 127 * s  # the largest |x|: the dynamic scale is s itself
    x[0, 0, 1] = -127 * s
    x[1] = rng.standard_normal((7, 16))
    if mode != "dynamic":  # quotients past 127, clamped
        x[2] = ((rng.integers(128, 140, (7, 16)) + 0.5) * s
                * rng.choice([-1, 1], (7, 16)))
    if dtype == torch.bfloat16:  # (k + 0.5) s is exact in bf16 for |k| < 128
        x = np.asarray(torch.from_numpy(x).bfloat16().float())
    kd = {"dynamic": {}, "sa": {"sa": jnp.float32(s)},
          "sac": {"sac": jnp.full((16,), s, jnp.float32)}}[mode]
    site = {key: torch.from_numpy(np.array(v)) for key, v in kd.items()}
    got, sx = quant.quantize_activation(
        torch.from_numpy(x).to(dtype), site, -1)
    want, wsx = jq._quantize_activation(jnp.asarray(x), kd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(sx) == float(wsx)
    # the half-way values went to the even neighbour
    halves = got.numpy()[0].astype(np.int64)
    even = np.where(k % 2 == 0, k, k + 1)
    even[0, :2] = (127, -127)
    np.testing.assert_array_equal(halves, even)
    if mode != "dynamic":
        assert set(np.abs(got.numpy()[2]).ravel()) == {127}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dynamic_scale_is_the_reference_scale(dtype):
    """``dynamic_scale`` (one reduction in x's own type) equals the plain
    version's scale from an f32 copy of x, exactly."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 6)) * 3).to(dtype)
    _, want = quant.quantize_activation_reference(x, {}, 1)
    got = quant.dynamic_scale(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _conv_operands(device="cpu"):
    x = torch.zeros(1, 32, 5, 5, device=device)
    w = torch.zeros(8, 3, 3, 32, dtype=torch.int8, device=device)
    return x, w, torch.ones(1, device=device), torch.ones(8, device=device)


@pytest.mark.parametrize("case,error", [
    ("w_float", TypeError), ("x_int8", TypeError), ("x_3d", ValueError),
    ("w_narrow", ValueError), ("act_numel", ValueError),
    ("sac_shape", ValueError), ("scale_shape", ValueError),
    ("bias_shape", ValueError), ("mixed_devices", ValueError),
    ("meta_device", ValueError)])
def test_int8_conv_act_refuses_bad_operands(case, error):
    """What ``int8_conv_act`` refuses before any kernel or plain version
    runs: types, shapes, and devices (tensors on two devices, or on one it
    has no kernel for)."""
    x, w, act, scale = _conv_operands()
    bias, per_channel = None, False
    if case == "w_float":
        w = w.float()
    elif case == "x_int8":
        x = x.to(torch.int8)
    elif case == "x_3d":
        x = x[0]
    elif case == "w_narrow":
        w = w[..., :16]
    elif case == "act_numel":
        act = torch.ones(2)
    elif case == "sac_shape":
        per_channel = True
    elif case == "scale_shape":
        scale = torch.ones(9)
    elif case == "bias_shape":
        bias = torch.ones(7)
    elif case == "mixed_devices":
        w = w.to("meta")
    else:
        x, w, act, scale = _conv_operands("meta")
    with pytest.raises(error):
        ic.int8_conv_act(x, w, act, per_channel, scale, bias, 1, 1)


@pytest.mark.parametrize("case,error", [
    ("cpu_sync", ValueError), ("meta_conv", ValueError),
    ("meta_quantize", ValueError)])
def test_int8_wrappers_refuse_devices_without_a_kernel(case, error):
    """``int8_conv_sync`` has no plain version (a CPU tensor raises), and
    ``int8_conv`` and ``quantize_activation`` refuse a device they have no
    kernel for."""
    x = torch.zeros(1, 5, 5, 16, dtype=torch.int8)
    w = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    with pytest.raises(error):
        if case == "cpu_sync":
            ic.int8_conv_sync(x, w, torch.ones(8), None, torch.float32, 1, 1)
        elif case == "meta_conv":
            ic.int8_conv(x.to("meta"), w.to("meta"),
                         torch.ones(8, device="meta"), None, torch.float32,
                         1, 1)
        else:
            quant.quantize_activation(torch.zeros(4, 16, device="meta"),
                                      {}, -1)


def test_int8_conv_act_counts_no_launch_on_the_cpu():
    """The CPU path runs the plain version and counts no kernel launch."""
    x, w, act, scale = _conv_operands()
    before = ic.int8_conv_act.launches, quant.quantize_activation.launches
    ic.int8_conv_act(x, w, act, False, scale, None, 1, 1)
    quant.quantize_activation(torch.zeros(4, 16), {}, -1)
    assert (ic.int8_conv_act.launches,
            quant.quantize_activation.launches) == before
