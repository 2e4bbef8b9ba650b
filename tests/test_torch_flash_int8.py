"""The port's int8 flash attention against JAX's, on the CPU.

On the CPU the wrapper runs its plain version, at the kernel's kv tile
(64 rows). Here it is held against the TPU kernel ``_flash_fwd_lowdim_int8``
run through the JAX package's ``flash_attention`` under
``int8_flash_attention`` in Pallas interpret mode, as the JAX tests run it,
with the same kv tile passed; and directly at JAX's default tile. The CUDA
kernel itself is held against the plain version in
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.ops import attention as jax_attention

from e4t_diffusion_torch.ops import attention
from e4t_diffusion_torch.ops import flash_int8 as fi

from torch_parity import rel_l2


def _qkv(b, h, sq, sk, d, seed=10):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    # a channel mean on k, as transformer keys have: what the centring is for
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32) + 0.7
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mode,bound", [("qk", 0.03), ("qkpv", 0.05)])
@pytest.mark.parametrize("d", [40, 80])
def test_int8_flash_matches_jax(d, mode, bound):
    """Ragged Sk = 200. f32 on both sides, the int8 products exact: the two
    differ only where an f32 ulp of exp moves round(p * 127) ("qkpv") or
    the mean of k moves a rounding of k. The bounds against f32 einsum are
    the JAX tests' (tests/test_attention.py)."""
    q, k, v = _qkv(1, 2, 256, 200, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with jax_attention.int8_flash_attention(mode):
        ref = np.asarray(jax_attention.flash_attention(
            jq, jk, jv, block_q=128, block_k=fi.KERNEL_BLOCK_K))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with attention.int8_flash_attention(mode):
        out = attention.flash_attention(tq, tk, tv).numpy()
    assert rel_l2(out, ref) <= 1e-5
    if mode == "qkpv":  # where the tile matters: JAX's default tile, 512
        # capped at round_up(Sk, 128)
        with jax_attention.int8_flash_attention(mode):
            ref_default = np.asarray(jax_attention.flash_attention(
                jq, jk, jv))
        flat = [t.reshape(2, -1, d) for t in (tq, tk, tv)]
        ops = attention.int8_attention_operands(*flat, d ** -0.5, mode)
        out_default, _ = fi.flash_fwd_int8_reference(
            *ops, mode, torch.float32, block_k=256)
        assert rel_l2(out_default.reshape(out.shape).numpy(),
                      ref_default) <= 1e-5
    exact = np.asarray(jax_attention.einsum_attention(jq, jk, jv))
    assert rel_l2(out, exact) < bound


def test_int8_context_leaves_other_sites_alone():
    """Einsum sites and heads from 128 up run as without the context."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 77, 40, seed=11))
    plain = attention.dot_product_attention(q, k, v)
    wq, wk, wv = (torch.from_numpy(a) for a in _qkv(1, 1, 130, 130, 160, 12))
    wide = attention.flash_attention(wq, wk, wv)
    lowdim = attention.flash_attention(q, k, v)
    with attention.int8_flash_attention("qkpv"):
        torch.testing.assert_close(attention.dot_product_attention(q, k, v),
                                   plain, rtol=0, atol=0)
        torch.testing.assert_close(attention.flash_attention(wq, wk, wv),
                                   wide, rtol=0, atol=0)
        # a low-dim flash site does take the int8 route
        assert not torch.equal(attention.flash_attention(q, k, v), lowdim)


def test_int8_flash_is_forward_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 128, 128, 40, 13))
    with attention.int8_flash_attention("qk"):
        with pytest.raises(RuntimeError, match="forward-only"):
            attention.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="int8 attention mode"):
        with attention.int8_flash_attention("pv"):
            pass


def test_cpu_path_does_not_count_launches():
    before = dict(fi.flash_fwd_int8.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 128, 70, 40, 14))
    with attention.int8_flash_attention("qkpv"):
        attention.flash_attention(q, k, v)
    assert fi.flash_fwd_int8.launches == before


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_kernel_input_checks(mode):
    """What the wrapper refuses before a launch (the helper, called here
    on CPU tensors): the output in bf16 or f32, and in "qk" mode v in the
    output's type."""
    i8 = torch.zeros(2, 64, 40, dtype=torch.int8)
    bf = torch.zeros(2, 64, 40, dtype=torch.bfloat16)
    f32 = torch.zeros(2, 64, 40)
    sc = torch.ones(2, 2)
    for out_dtype, v in ((torch.bfloat16, bf), (torch.float32, f32)):
        good_v = i8 if mode == "qkpv" else v
        fi._check_kernel_inputs(i8, i8, good_v, sc, mode, out_dtype)
    good_v = i8 if mode == "qkpv" else bf
    with pytest.raises(TypeError):
        fi._check_kernel_inputs(i8, i8, bf if mode == "qkpv" else i8, sc,
                                mode, torch.bfloat16)
    with pytest.raises(TypeError):
        fi._check_kernel_inputs(i8, i8, good_v, sc, mode, torch.float16)
    if mode == "qk":  # a bf16 v under an f32 output is a mixed call
        with pytest.raises(TypeError):
            fi._check_kernel_inputs(i8, i8, bf, sc, mode, torch.float32)
    wide = torch.zeros(2, 64, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="head dim 128"):
        fi._check_kernel_inputs(wide, wide, wide, sc, mode, torch.bfloat16)
