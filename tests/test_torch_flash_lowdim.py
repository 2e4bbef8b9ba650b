"""The port's flash forward and attention routing against JAX.

On the CPU the wrapper runs its plain version, which is held here against
the TPU kernel ``_flash_fwd_lowdim`` (run in Pallas interpret mode, as the
JAX tests run it) in f32. The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.ops import attention as jax_attention
from e4t_diffusion_tpu.ops.flash_kernels import _flash_fwd_lowdim

from e4t_diffusion_torch.ops import attention
from e4t_diffusion_torch.ops import flash_lowdim as fl

# f32 on both sides; the two differ only in summation order (online
# softmax over 128-wide kv blocks vs one softmax), a few ulp of O(1) values
ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("d", [8, 40, 80])
@pytest.mark.parametrize("sk", [256, 200])
def test_reference_matches_tpu_kernel(d, sk):
    q, k, v = _rand((2, 256, d), 0), _rand((2, sk, d), 1), _rand((2, sk, d), 2)
    scale = d ** -0.5
    jo, jl = _flash_fwd_lowdim(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale, 128, 128)
    to, tl = fl.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (1, 2, 256, 256, 40),    # the 4096/d40 site, scaled down
    (2, 2, 128, 128, 80),    # the 1024/d80 site's head dim
    (1, 2, 300, 200, 24),    # ragged q and kv
    (1, 1, 130, 77, 20),     # head dim padded 20 -> 24
])
def test_flash_attention_matches_jax(b, h, sq, sk, d):
    q, k, v = (_rand((b, h, s, d), i) for i, s in enumerate((sq, sk, sk)))
    ref = jax_attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), block_q=128,
                                        block_k=128)
    out = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_einsum_attention_causal_matches_jax():
    q, k, v = (_rand((2, 3, 77, 16), s) for s in (3, 4, 5))
    ref = jax_attention.einsum_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True)
    out = attention.einsum_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _jax_routes_to_flash(monkeypatch, q_shape, k_shape, bias, causal):
    """The JAX dispatcher's decision on a TPU backend, from shapes alone."""
    calls = []
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_attention, "_maybe_head_sharded_flash",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(jax_attention, "einsum_attention",
                        lambda *a, **kw: calls.append("einsum"))
    q = types.SimpleNamespace(shape=q_shape)
    k = types.SimpleNamespace(shape=k_shape)
    jax_attention.dot_product_attention(q, k, k, bias=bias, causal=causal)
    assert len(calls) == 1
    return calls[0] == "flash"


# (q shape, k shape, bias, causal, expected route on the card)
SITES = [
    ((8, 8, 4096, 40), (8, 8, 4096, 40), None, False, True),    # 512px d40
    ((4, 8, 4096, 40), (4, 8, 4096, 40), None, False, True),
    ((1, 8, 4096, 40), (1, 8, 4096, 40), None, False, True),
    ((8, 8, 1024, 80), (8, 8, 1024, 80), None, False, True),    # 512px d80
    ((5, 8, 1024, 80), (5, 8, 1024, 80), None, False, True),    # above 128 MiB
    ((4, 8, 1024, 80), (4, 8, 1024, 80), None, False, False),   # exactly 128 MiB
    ((8, 8, 256, 160), (8, 8, 256, 160), None, False, False),   # d160 sites
    ((8, 8, 4096, 40), (8, 8, 77, 40), None, False, False),     # cross-attn
    ((8, 16, 257, 80), (8, 16, 257, 80), None, False, False),   # ViT-H
    ((8, 12, 77, 64), (8, 12, 77, 64), None, True, False),      # CLIP text
    ((8, 8, 4096, 40), (8, 8, 4096, 40), "bias", False, False),
    ((64, 8, 64, 40), (64, 8, 8192, 40), None, False, False),   # seq < 128
]


@pytest.mark.parametrize("q_shape,k_shape,bias,causal,expected", SITES)
def test_routing_matches_jax_dispatcher(monkeypatch, q_shape, k_shape, bias,
                                        causal, expected):
    jax_flash = _jax_routes_to_flash(monkeypatch, q_shape, k_shape, bias,
                                     causal)
    ours = attention.flash_route(q_shape, k_shape, torch.device("cuda"),
                                 has_bias=bias is not None, causal=causal)
    assert ours == jax_flash == expected
    # off the card everything is einsum
    assert not attention.flash_route(q_shape, k_shape, torch.device("cpu"),
                                     has_bias=bias is not None, causal=causal)


def test_flash_attention_wide_heads_not_ported():
    """head_dim 160 (the d >= 128 route) is ported: it matches JAX's
    flash_attention; only heads wider than the kernels' 256 raise."""
    q, k, v = (_rand((1, 2, 130, 160), i) for i in (7, 8, 9))
    ref = jax_attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), block_q=128,
                                        block_k=128)
    out = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    wide = torch.zeros(1, 1, 128, 264)
    with pytest.raises(NotImplementedError, match="head_dim 264"):
        attention.flash_attention(wide, wide, wide)


def test_cpu_path_does_not_count_launches():
    before = dict(fl.flash_fwd.launches)
    for d in (40, 160):
        q = torch.from_numpy(_rand((2, 64, d), 6))
        fl.flash_fwd(q, q, q, 0.1)
    assert fl.flash_fwd.launches == before


@pytest.mark.parametrize("bad,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=36), ValueError),
    (dict(d=264), ValueError),
    (dict(noncontiguous=True), ValueError),
])
def test_kernel_input_checks(bad, error):
    """What flash_fwd refuses on CUDA tensors (bf16 and f32 pass, f16 does
    not), called on CPU tensors, which never reach it in the wrapper."""
    d = bad.get("d", 40)
    q = torch.zeros(2, 64, d, dtype=bad.get("dtype", torch.bfloat16))
    if bad.get("noncontiguous"):
        q = torch.zeros(2, d, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(error):
        fl._check_kernel_inputs(q, q, q)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_sync_yardsticks_run_on_cuda_tensors_only(direction):
    """flash_fwd_sync and flash_bwd_sync, the synchronous design kept as the
    wgmma kernels' yardstick, take no CPU tensors (they have no plain
    version to fall back to) and count no launch."""
    from e4t_diffusion_torch.ops import flash_bwd as fb

    q = torch.from_numpy(_rand((2, 64, 160), 7)).bfloat16()
    lse = torch.zeros(2, 64)
    before = dict(fl.flash_fwd.launches), dict(fb.flash_bwd.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if direction == "forward":
            fl.flash_fwd_sync(q, q, q, 0.1)
        else:
            fb.flash_bwd_sync(q, q, q, q, lse, q, 0.1)
    assert (fl.flash_fwd.launches, fb.flash_bwd.launches) == before
