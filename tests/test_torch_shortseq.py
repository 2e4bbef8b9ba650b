"""The port's short-sequence attention and its E4T_SHORTSEQ_MH_ATTN route
against JAX.

On the CPU the wrapper runs its plain version, which is held here against
the TPU kernel ``_flash_fwd_shortseq_mh`` (Pallas interpret mode, as the
JAX tests run it) in f32, with the reference's heads per cell set by
monkeypatching ``_SHORTSEQ_MH_G`` as tests/test_attention.py does. The
routing is held case by case against the JAX dispatcher on a TPU backend,
decided from shapes alone. The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.ops import attention as jax_attention

from e4t_diffusion_torch.ops import attention, shortseq

# f32 on both sides; the two differ in summation order only
ATOL = 1e-5


def _qkv(b, h, s, d, seed=30):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s,d,g", [(257, 80, 8), (257, 80, 4), (130, 40, 1),
                                   (130, 40, 2)])
def test_plain_matches_tpu_kernel(monkeypatch, s, d, g):
    """BH = 8: the ViT-H's 257-token d=80 site and a ragged one (S padded to
    256 lanes, d=40 to sublanes of 8 on the TPU), g in {1, 2, 4, 8}."""
    q, k, v = _qkv(2, 4, s, d)
    scale = 1.0 / np.sqrt(d)
    monkeypatch.setattr(jax_attention, "_SHORTSEQ_MH_G", g)
    ref = jax_attention.shortseq_mh_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", str(g))
    before = dict(shortseq.flash_fwd_shortseq.launches)
    out = attention.shortseq_mh_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert shortseq.flash_fwd_shortseq.launches == before  # the CPU: plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    flat = [torch.from_numpy(t.reshape(8, s, d)) for t in (q, k, v)]
    np.testing.assert_allclose(
        shortseq.flash_fwd_shortseq(*flat, scale, g).numpy(),
        np.asarray(ref).reshape(8, s, d), atol=ATOL)


def test_gradients_match_jax(monkeypatch):
    """The backward (autograd of einsum attention on a recompute) against
    jax.grad through the reference's custom VJP."""
    q, k, v = _qkv(2, 2, 130, 40, seed=31)
    scale = 1.0 / np.sqrt(40)
    monkeypatch.setattr(jax_attention, "_SHORTSEQ_MH_G", 4)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jax_attention.shortseq_mh_attention(
            q_, k_, v_, scale)))

    # jitted: one compile in place of one per op of the eager backward
    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(t) for t in (q, k, v)))
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "4")
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    torch.sin(attention.shortseq_mh_attention(tq, tk, tv, scale)
              ).sum().backward()
    for got, want in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=ATOL)


@pytest.mark.parametrize("bh", [2, 6, 8, 12, 128, 256])
def test_heads_per_cell_matches_jax(monkeypatch, bh):
    """The g the reference passes to its kernel, for each knob value."""
    seen = []

    def kernel(qt, k, vt, scale, kv_len, g):
        seen.append(g)
        return qt

    monkeypatch.setattr(jax_attention, "_flash_fwd_shortseq_mh", kernel)
    q = jnp.zeros((1, bh, 130, 8))
    for heads in (1, 2, 3, 4, 5, 8, 16):
        monkeypatch.setattr(jax_attention, "_SHORTSEQ_MH_G", heads)
        jax_attention._shortseq_mh_impl(q, q, q, 0.1)
        assert shortseq.heads_per_cell(bh, heads) == seen[-1], heads


def test_knob_off_raises_naming_it(monkeypatch):
    """A direct call with the knob off (or a count <= 0) raises a ValueError
    that names the knob, not the reference's bare max() error."""
    q = torch.zeros(1, 2, 130, 8)
    monkeypatch.delenv("E4T_SHORTSEQ_MH_ATTN", raising=False)
    with pytest.raises(ValueError, match="E4T_SHORTSEQ_MH_ATTN"):
        attention.shortseq_mh_attention(q, q, q)
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "-2")
    with pytest.raises(ValueError, match="E4T_SHORTSEQ_MH_ATTN"):
        attention.shortseq_mh_attention(q, q, q)
    with pytest.raises(ValueError, match="E4T_SHORTSEQ_MH_ATTN"):
        shortseq.heads_per_cell(2, 0)
    with pytest.raises(ValueError, match="divide"):
        shortseq.flash_fwd_shortseq(q[0], q[0], q[0], 0.1, 3)
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "4")  # read per call
    assert shortseq.heads_knob() == 4
    assert attention.shortseq_mh_attention(q, q, q).shape == q.shape


def _jax_route(monkeypatch, q_shape, k_shape, bias, causal, knob, override):
    """The JAX dispatcher's choice on a TPU backend, from shapes alone."""
    calls = []
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_attention, "_SHORTSEQ_MH_G", knob)
    for name, route in (("shortseq_mh_attention", "shortseq"),
                        ("_maybe_head_sharded_flash", "flash"),
                        ("einsum_attention", "einsum")):
        monkeypatch.setattr(jax_attention, name,
                            lambda *a, _r=route, **kw: calls.append(_r))
    q = types.SimpleNamespace(shape=q_shape)
    k = types.SimpleNamespace(shape=k_shape)
    with jax_attention.flash_threshold(override):
        jax_attention.dot_product_attention(q, k, k, bias=bias,
                                            causal=causal)
    assert len(calls) == 1
    return calls[0]


def _port_route(monkeypatch, q_shape, k_shape, bias, causal, knob, override,
                device):
    calls = []
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", str(knob))
    for name, route in (("shortseq_mh_attention", "shortseq"),
                        ("flash_attention", "flash"),
                        ("einsum_attention", "einsum")):
        monkeypatch.setattr(attention, name,
                            lambda *a, _r=route, **kw: calls.append(_r))
    q = types.SimpleNamespace(shape=q_shape, device=torch.device(device))
    k = types.SimpleNamespace(shape=k_shape, device=torch.device(device))
    with attention.flash_threshold(override):
        attention.dot_product_attention(q, k, k, bias=bias, causal=causal)
    assert len(calls) == 1
    return calls[0]


VIT_SAMPLING = (8, 16, 257, 80)
VIT_TUNING = (16, 16, 257, 80)
# (q shape, k shape, bias, causal, knob, threshold override, route)
SITES = [
    (VIT_SAMPLING, VIT_SAMPLING, None, False, 8, None, "shortseq"),
    (VIT_SAMPLING, VIT_SAMPLING, None, False, 0, None, "einsum"),
    (VIT_TUNING, VIT_TUNING, None, False, 8, 0, "shortseq"),  # before flash
    (VIT_TUNING, VIT_TUNING, None, False, 0, 0, "flash"),
    (VIT_TUNING, VIT_TUNING, None, False, 16, 0, "shortseq"),
    ((2, 4, 257, 120), (2, 4, 257, 120), None, False, 8, None, "shortseq"),
    ((2, 4, 257, 128), (2, 4, 257, 128), None, False, 8, None, "einsum"),
    ((2, 4, 257, 80), (2, 4, 77, 80), None, False, 8, 0, "flash"),  # cross
    ((2, 4, 257, 80), (2, 4, 257, 80), None, True, 8, None, "einsum"),
    ((2, 4, 257, 80), (2, 4, 257, 80), "bias", False, 8, 0, "einsum"),
    ((2, 4, 128, 80), (2, 4, 128, 80), None, False, 8, 0, "flash"),
    ((2, 4, 129, 80), (2, 4, 129, 80), None, False, 8, 0, "shortseq"),
    ((2, 4, 512, 40), (2, 4, 512, 40), None, False, 8, None, "shortseq"),
    ((2, 4, 513, 40), (2, 4, 513, 40), None, False, 8, 0, "flash"),
    ((1, 3, 257, 80), (1, 3, 257, 80), None, False, 8, None, "einsum"),
    ((8, 8, 4096, 40), (8, 8, 4096, 40), None, False, 8, None, "flash"),
]


@pytest.mark.parametrize("q_shape,k_shape,bias,causal,knob,override,route",
                         SITES)
def test_dispatch_matches_jax(monkeypatch, q_shape, k_shape, bias, causal,
                              knob, override, route):
    """The route and the dispatcher's order (short-sequence before flash)
    against the reference's, on the card; off it, everything is einsum."""
    args = (q_shape, k_shape, bias, causal, knob, override)
    assert _jax_route(monkeypatch, *args) == route
    assert _port_route(monkeypatch, *args, "cuda") == route
    assert attention.shortseq_route(
        q_shape, k_shape, torch.device("cuda"), has_bias=bias is not None,
        causal=causal) == (route == "shortseq")
    assert _port_route(monkeypatch, *args, "cpu") == "einsum"


def test_shortseq_sync_yardstick_runs_on_cuda_tensors_only():
    """flash_fwd_shortseq_sync, the synchronous design kept as the wgmma
    kernels' yardstick, takes no CPU tensors and counts no launch."""
    q = torch.zeros(2, 257, 80, dtype=torch.bfloat16)
    before = dict(shortseq.flash_fwd_shortseq.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        shortseq.flash_fwd_shortseq_sync(q, q, q, 0.1, 2)
    assert shortseq.flash_fwd_shortseq.launches == before


def test_shortseq_f32_yardstick_refuses_bf16_and_cpu_tensors():
    """flash_fwd_shortseq_f32_sync, the synchronous f32 design kept as the
    register-blocked kernel's yardstick: bf16 operands raise TypeError, f32
    CPU tensors ValueError (no plain version to fall back to), and neither
    counts a launch."""
    q = torch.zeros(2, 257, 80)
    before = dict(shortseq.flash_fwd_shortseq.launches)
    h = q.bfloat16()
    with pytest.raises(TypeError, match="float32"):
        shortseq.flash_fwd_shortseq_f32_sync(h, h, h, 0.1, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        shortseq.flash_fwd_shortseq_f32_sync(q, q, q, 0.1, 2)
    assert shortseq.flash_fwd_shortseq.launches == before
