"""The port's GroupNorm(+SiLU) and its E4T_FUSED_GN route against JAX.

On the CPU the wrapper runs its plain version, which is held here against
the TPU kernel ``_fused_group_norm_impl`` (Pallas interpret mode, as the
JAX tests run it) on the same inputs in NHWC. The tiny UNet and VAE run
under the knob on both sides with the same weights; there the JAX side's
fused sites run its own plain version ``_gn_reference`` (the kernel in
interpret mode costs minutes at that size). The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda_kernels.py and by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from e4t_diffusion_tpu.ops import groupnorm as jax_gn

from e4t_diffusion_torch.models import norm
from e4t_diffusion_torch.ops import groupnorm as gn

from torch_parity import jax_tiny, port_tiny, rel_l2

# the reference's own tolerances (tests/test_groupnorm.py): f32 forward and
# gradients; bf16 rounds the output on both sides
F32_TOL = 2e-5
BF16_TOL = 1e-2
GRAD_TOL = 2e-4
# the conv stacks' f32 reductions sum in another order in XLA and PyTorch
CONV_TOL = 1e-4


def _inputs(shape, seed):
    """NHWC x (offset from 0, so the fast variance sees a mean), weight and
    bias, from numpy."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    scale = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups,dtype", [
    ((2, 8, 8, 32), 8, "float32"),
    ((1, 16, 16, 20), 4, "float32"),    # C/G = 5
    ((2, 8, 8, 320), 32, "float32"),    # SD-v1's C/G = 10
    ((2, 8, 8, 320), 32, "bfloat16"),
])
def test_plain_matches_tpu_kernel(shape, groups, dtype, act):
    x, scale, bias = _inputs(shape, 0)
    jx = jnp.asarray(x, dtype)
    ref = jax_gn.fused_group_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                                  groups=groups, eps=1e-5, act=act)
    tx = _nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = gn.fused_group_norm(tx, torch.from_numpy(scale),
                              torch.from_numpy(bias), groups, 1e-5, act)
    assert out.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("act", [None, "silu"])
def test_gradients_match_jax(act):
    """FusedGroupNorm's backward (autograd of the plain version on a
    recompute) against jax.grad through the TPU kernel's custom VJP."""
    shape, groups = (2, 8, 8, 32), 8
    x, scale, bias = _inputs(shape, 1)
    cot = np.random.default_rng(2).standard_normal(shape).astype(np.float32)

    def loss(x_, s_, b_):
        y = jax_gn.fused_group_norm(x_, s_, b_, groups=groups, eps=1e-5,
                                    act=act)
        return jnp.sum(y * cot)

    # jitted: one compile in place of one per op of the eager backward
    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx = _nchw(x).requires_grad_()
    ts, tb = (torch.from_numpy(t).requires_grad_() for t in (scale, bias))
    y = gn.FusedGroupNorm.apply(tx, ts, tb, groups, 1e-5, act)
    (y * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(ref[0]).transpose(0, 3, 1, 2),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for got, want in zip((ts.grad, tb.grad), ref[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_knob_parsing_matches_jax(monkeypatch):
    monkeypatch.delenv("E4T_FUSED_GN", raising=False)
    assert not gn.fused_gn_enabled() and not jax_gn.fused_gn_enabled()
    for value in ("0", "false", "False", "FALSE", "", "1", "true", "True",
                  "yes", "2"):
        monkeypatch.setenv("E4T_FUSED_GN", value)
        assert gn.fused_gn_enabled() == jax_gn.fused_gn_enabled(), value


def test_route_and_cpu_plain_version(monkeypatch):
    """The route depends on the knob, the dtype and C % groups only; on the
    CPU the wrapper runs the plain version and counts no launch."""
    x = torch.randn(2, 32, 4, 4)
    monkeypatch.delenv("E4T_FUSED_GN", raising=False)
    assert not norm.fused_gn_route(x, 8)
    monkeypatch.setenv("E4T_FUSED_GN", "1")
    assert norm.fused_gn_route(x, 8)
    assert norm.fused_gn_route(x.bfloat16(), 8)
    assert not norm.fused_gn_route(x.half(), 8)
    assert not norm.fused_gn_route(x, 5)
    layer = torch.nn.GroupNorm(8, 32, eps=1e-6)
    before = gn.fused_group_norm.launches
    out = norm.group_norm_act(x, layer, "silu")
    assert gn.fused_group_norm.launches == before
    torch.testing.assert_close(out, gn.group_norm_reference(
        x, layer.weight, layer.bias, 8, 1e-6, "silu"), rtol=0, atol=0)
    # the plain version reads any layout (the card's kernel takes NCHW and
    # channels-last): the UNet hands it both
    torch.testing.assert_close(
        gn.fused_group_norm(x.contiguous(memory_format=torch.channels_last),
                            layer.weight, layer.bias, 8, 1e-6, "silu"),
        out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        gn.fused_group_norm(x.to("meta"), layer.weight.to("meta"),
                            layer.bias.to("meta"), 8, 1e-6)


@pytest.fixture(scope="module")
def tiny():
    jm, params = jax_tiny(seed=4)
    modules, _ = port_tiny(params)
    return jm, params, modules


@pytest.fixture
def jax_fused_sites_plain(monkeypatch):
    """The JAX package's fused GroupNorm sites on its plain version
    ``_gn_reference`` (what its custom VJP differentiates), and the knob
    on for both packages."""
    monkeypatch.setattr(
        jax_gn, "_fused_group_norm_impl",
        lambda x, scale, bias, *, groups, eps, act=None:
        jax_gn._gn_reference(x, scale, bias, groups, eps, act))
    monkeypatch.setenv("E4T_FUSED_GN", "1")


def _count_fused(monkeypatch):
    calls = []
    apply = gn.FusedGroupNorm.apply
    monkeypatch.setattr(gn.FusedGroupNorm, "apply",
                        lambda *a: calls.append(a[3]) or apply(*a))
    return calls


def test_flagged_unet_matches_jax(tiny, jax_fused_sites_plain, monkeypatch):
    """The tiny UNet under E4T_FUSED_GN=1 in both packages, same weights:
    every GroupNorm site takes the fused route, the output agrees, and
    neither the port's state-dict keys nor JAX's parameter tree depend on
    the knob."""
    from e4t_diffusion_torch.models.unet import UNet2DConditionModel

    jm, params, modules = tiny
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 500])
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ref = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    calls = _count_fused(monkeypatch)
    out = modules.unet(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(ctx))
    sites = [m for m in modules.unet.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    assert len(calls) == len(sites)
    assert rel_l2(out.detach(), ref) <= CONV_TOL

    shapes_on = jax.eval_shape(jm.unet.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
                               jnp.zeros((1, 16, 32)))
    monkeypatch.delenv("E4T_FUSED_GN")
    shapes_off = jax.eval_shape(jm.unet.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
                                jnp.zeros((1, 16, 32)))
    assert shapes_on == shapes_off
    fresh = UNet2DConditionModel(modules.unet.config)
    assert list(fresh.state_dict()) == list(modules.unet.state_dict())


def test_flagged_vae_decode_matches_jax(tiny, jax_fused_sites_plain,
                                        monkeypatch):
    jm, params, modules = tiny
    z = np.random.default_rng(6).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    ref = jax.jit(lambda p, z_: jm.vae.apply(
        {"params": p}, z_, method=JaxAutoencoderKL.decode))(
            params["vae"], jnp.asarray(z))
    calls = _count_fused(monkeypatch)
    out = modules.vae.decode(torch.from_numpy(z))
    assert len(calls) == sum(isinstance(m, torch.nn.GroupNorm)
                             for m in modules.vae.decoder.modules())
    assert rel_l2(out.detach(), ref) <= CONV_TOL


def test_sites_each_package_routes():
    """At 512px the reference's VMEM gate (``fused_gn_fits``: 6 MB a
    sample in NHWC) routes 57 of the 61 GroupNorm sites of a UNet pass and
    none of the VAE's, where the port's route takes every site (the sites
    as chip_smoke.py reads them off meta-device forwards)."""
    import chip_smoke
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig

    sites = chip_smoke._group_norm_sites(UNetConfig(), VAEConfig(), 1, 512)
    counts = {}
    for part, found in sites.items():
        counts[part] = (sum(found.values()), sum(
            n for (c, h, w, *_), n in found.items()
            if jax_gn.fused_gn_fits((1, h, w, c), jnp.bfloat16)))
    assert counts == {"unet": (61, 57), "unet_tap": (27, 27),
                      "vae_decode": (30, 0), "vae_encode": (22, 0)}
