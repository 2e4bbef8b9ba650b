"""The port's flash backward, its d >= 128 forward and the all-flash routing
against JAX.

On the CPU the wrappers run their plain versions, which are held here
against ``jax.grad`` of the JAX package's ``flash_attention`` (Pallas
interpret mode, as the JAX tests run it): the plain backward on its own,
and the autograd Function around both directions. d covers the UNet's
three head dims (40, 80, 160) with ragged kv (77, the text length, and 200,
not a multiple of the 128 block). The CUDA kernels are held against the
plain versions in tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.ops import attention as jax_attention
from e4t_diffusion_tpu.ops import flash_kernels as jax_flash_kernels

from e4t_diffusion_torch.ops import attention
from e4t_diffusion_torch.ops import flash_bwd as fb
from e4t_diffusion_torch.ops import flash_lowdim as fl

# f32 on both sides; the two differ in summation order only (online softmax
# and blocked reductions over 128-wide blocks in JAX, one softmax here), a
# few ulp of O(1) values
ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(d, sk, sq=128, seed=0):
    return (_rand((1, 2, sq, d), seed), _rand((1, 2, sk, d), seed + 1),
            _rand((1, 2, sk, d), seed + 2))


def _jax_grads(q, k, v):
    """d/d(q, k, v) of sum(sin(flash_attention)), and the output."""
    def loss(q, k, v):
        o = jax_attention.flash_attention(q, k, v, block_q=128, block_k=128)
        return jnp.sum(jnp.sin(o)), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(q, k, v):
    """The same through the port's autograd Function on the CPU."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.flash_attention(qt, kt, vt)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("sk", [77, 200])
def test_backward_matches_jax(d, sk):
    q, k, v = _inputs(d, sk, seed=d + sk)
    ref_out, ref_grads = _jax_grads(q, k, v)
    # the plain backward on its own, fed the plain forward's (out, lse)
    bh = (lambda x: torch.from_numpy(x.reshape(2, -1, d)))
    scale = d ** -0.5
    out, lse = fl.flash_fwd_reference(bh(q), bh(k), bh(v), scale)
    dout = torch.cos(out)
    plain = fb.flash_bwd(bh(q), bh(k), bh(v), out, lse, dout, scale)
    for got, want in zip(plain, ref_grads):
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   atol=ATOL)
    # the autograd Function
    got_out, got_grads = _port_grads(q, k, v)
    np.testing.assert_allclose(got_out, ref_out, atol=ATOL)
    for got, want in zip(got_grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("sk", [77, 200])
def test_wide_heads_against_jax_grid_and_blocked_paths(monkeypatch, sk):
    """d=160 once more with the JAX residency bounds at 0, so JAX takes its
    (bh, nq, nk)-grid forward and blocked backward: one Hopper kernel pair
    stands for both TPU variants."""
    for module in (jax_attention, jax_flash_kernels):
        monkeypatch.setattr(module, "_KVRES_MAX_ELEMS", 0)
        monkeypatch.setattr(module, "_QRES_MAX_ELEMS", 0)
    q, k, v = _inputs(160, sk, seed=sk)
    ref_out, ref_grads = _jax_grads(q, k, v)
    got_out, got_grads = _port_grads(q, k, v)
    np.testing.assert_allclose(got_out, ref_out, atol=ATOL)
    for got, want in zip(got_grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=ATOL)


def _jax_routes_to_flash(monkeypatch, q_shape, k_shape, causal):
    """The JAX dispatcher's decision on a TPU backend under its
    flash_threshold(0), from shapes alone."""
    calls = []
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_attention, "_maybe_head_sharded_flash",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(jax_attention, "einsum_attention",
                        lambda *a, **kw: calls.append("einsum"))
    q = types.SimpleNamespace(shape=q_shape)
    k = types.SimpleNamespace(shape=k_shape)
    with jax_attention.flash_threshold(0):
        jax_attention.dot_product_attention(q, k, k, causal=causal)
    assert len(calls) == 1
    return calls[0] == "flash"


# every attention site of one tuning step at 512px, batch 16:
# (q shape, k shape, causal, expected route)
TUNING_SITES = [
    ((16, 8, 4096, 40), (16, 8, 4096, 40), False, True),    # down0/up3 self
    ((16, 8, 4096, 40), (16, 8, 77, 40), False, True),      # down0/up3 cross
    ((16, 8, 1024, 80), (16, 8, 1024, 80), False, True),    # down1/up2 self
    ((16, 8, 1024, 80), (16, 8, 77, 80), False, True),      # down1/up2 cross
    ((16, 8, 256, 160), (16, 8, 256, 160), False, True),    # down2/up1 self
    ((16, 8, 256, 160), (16, 8, 77, 160), False, True),     # down2/up1 cross
    ((16, 8, 64, 160), (16, 8, 64, 160), False, False),     # mid self
    ((16, 8, 64, 160), (16, 8, 77, 160), False, False),     # mid cross
    ((16, 16, 257, 80), (16, 16, 257, 80), False, True),    # ViT-H
    ((16, 12, 77, 64), (16, 12, 77, 64), True, False),      # CLIP text
]


@pytest.mark.parametrize("q_shape,k_shape,causal,expected", TUNING_SITES)
def test_all_flash_routing_matches_jax(monkeypatch, q_shape, k_shape,
                                       causal, expected):
    jax_flash = _jax_routes_to_flash(monkeypatch, q_shape, k_shape, causal)
    with attention.flash_threshold(0):
        ours = attention.flash_route(q_shape, k_shape, torch.device("cuda"),
                                     causal=causal)
        assert attention.flash_threshold_bytes() == 0
        # off the card everything stays on einsum
        assert not attention.flash_route(q_shape, k_shape,
                                         torch.device("cpu"), causal=causal)
    assert ours == jax_flash == expected
    assert attention.flash_threshold_bytes() == attention.FLASH_SCORE_BYTES


def test_flash_threshold_nests_and_restores():
    big = ((16, 8, 256, 160), (16, 8, 256, 160))
    cuda = torch.device("cuda")
    assert not attention.flash_route(*big, cuda)
    with attention.flash_threshold(0):
        assert attention.flash_route(*big, cuda)
        with attention.flash_threshold(1 << 62):
            assert not attention.flash_route(*big, cuda)
        with attention.flash_threshold(None):  # None changes nothing
            assert attention.flash_route(*big, cuda)
    assert not attention.flash_route(*big, cuda)


def test_cpu_backward_does_not_count_launches():
    before = dict(fb.flash_bwd.launches), dict(fl.flash_fwd.launches)
    q = torch.from_numpy(_rand((2, 64, 160), 3)).requires_grad_()
    out = attention.FlashAttention.apply(q, q, q, 0.1)
    out.sum().backward()
    assert q.grad is not None
    assert (fb.flash_bwd.launches, fl.flash_fwd.launches) == before


@pytest.mark.parametrize("bad,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=36), ValueError),
    (dict(d=264), ValueError),
    (dict(noncontiguous=True), ValueError),
])
def test_kernel_operand_checks(bad, error):
    """The helpers flash_bwd runs on CUDA tensors before a launch, called
    directly (a CPU tensor takes the plain path and never reaches them):
    the q/k/v checks it shares with flash_fwd, and the same dtype and
    layout checks on out and dout (bf16 and f32 pass, f16 does not). The
    wrappers themselves meet bad CUDA operands in
    tests/test_torch_cuda_kernels.py."""
    d = bad.get("d", 160)
    q = torch.zeros(2, 64, d, dtype=bad.get("dtype", torch.bfloat16))
    if bad.get("noncontiguous"):
        q = torch.zeros(2, d, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(error):
        fl._check_kernel_inputs(q, q, q)
    if "d" not in bad:
        good = torch.zeros(2, 64, d, dtype=torch.bfloat16)
        with pytest.raises(error):
            fl.check_operands(out=good, dout=q)


def test_backward_shape_checks():
    q = torch.zeros(2, 64, 40)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_bwd(q, q, q, q, lse[:, :10], q, 0.1)
    with pytest.raises(ValueError, match="dout"):
        fb.flash_bwd(q, q, q, q, lse, q[:, :10], 0.1)


def test_f32_yardstick_refuses_bf16_and_cpu_tensors():
    """flash_bwd_f32_sync, the synchronous f32 design kept as the
    register-blocked kernels' yardstick: bf16 operands raise TypeError, f32
    CPU tensors ValueError (no plain version to fall back to), and neither
    counts a launch."""
    q = torch.from_numpy(_rand((2, 130, 40), 9))
    lse = torch.zeros(2, 130)
    before = dict(fb.flash_bwd.launches)
    h = q.bfloat16()
    with pytest.raises(TypeError, match="float32"):
        fb.flash_bwd_f32_sync(h, h, h, h, lse, h, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb.flash_bwd_f32_sync(q, q, q, q, lse, q, 0.1)
    assert fb.flash_bwd.launches == before
