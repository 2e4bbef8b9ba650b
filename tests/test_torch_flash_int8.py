"""The port's int8 flash attention against JAX's, on the CPU.

On the CPU the wrapper runs its plain version, at the route's kv tile
(``flash_int8.quant_tile``: ``E4T_FLASH_BLOCK_K``, 512 by default, capped at
round_up(Sk, 128), the JAX package's rule). Here it is held against the TPU
kernel ``_flash_fwd_lowdim_int8`` run through the JAX package's
``flash_attention`` under ``int8_flash_attention`` in Pallas interpret
mode, as the JAX tests run it, at the JAX package's default tile. The CUDA
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
    """Ragged Sk = 200, both packages at their default kv tile (256 here).
    f32 on both sides, the int8 products exact: the two differ only where
    an f32 ulp of exp moves round(p * 127) ("qkpv") or the mean of k moves
    a rounding of k. The bounds against f32 einsum are the JAX tests'
    (tests/test_attention.py)."""
    q, k, v = _qkv(1, 2, 256, 200, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with jax_attention.int8_flash_attention(mode):
        ref = np.asarray(jax_attention.flash_attention(jq, jk, jv))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with attention.int8_flash_attention(mode):
        out = attention.flash_attention(tq, tk, tv).numpy()
    assert rel_l2(out, ref) <= 1e-5
    exact = np.asarray(jax_attention.einsum_attention(jq, jk, jv))
    assert rel_l2(out, exact) < bound


def _route_against_jax(sk, d, jax_block_k=None, sq=128):
    """rel-L2 of the port's "qkpv" route against the JAX package's
    flash_attention at ``jax_block_k`` (its default tile when None), and
    of the port's kernel function on the route's int8 operands against the
    TPU kernel ``_flash_fwd_lowdim_int8`` on the same operands at that tile
    (interpret mode)."""
    q, k, v = _qkv(1, 2, sq, sk, d, seed=15)
    with jax_attention.int8_flash_attention("qkpv"):
        ref = np.asarray(jax_attention.flash_attention(
            *map(jnp.asarray, (q, k, v)), block_k=jax_block_k))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with attention.int8_flash_attention("qkpv"):
        out = attention.flash_attention(tq, tk, tv).numpy()
    # the same operands through both kernels, at the JAX package's tile
    tile = min(jax_block_k or 512, -(-sk // 128) * 128)
    qi, ki, vi, sc = attention.int8_attention_operands(
        *(t.reshape(2, -1, d) for t in (tq, tk, tv)), d ** -0.5, "qkpv")
    pad = -(-sk // tile) * tile - sk
    ki_p, vi_p = (np.pad(t.numpy(), ((0, 0), (0, pad), (0, 0)))
                  for t in (ki, vi))
    ot, _ = jax_attention._flash_fwd_lowdim_int8(
        jnp.asarray(qi.numpy().transpose(0, 2, 1)), jnp.asarray(ki_p),
        jnp.asarray(vi_p.transpose(0, 2, 1)), jnp.asarray(sc.numpy()),
        jnp.float32, sq, tile, sk, True)
    kernel, _ = fi.flash_fwd_int8(qi, ki, vi, sc, "qkpv", torch.float32)
    return (rel_l2(out, ref),
            rel_l2(kernel.numpy(), np.asarray(ot).transpose(0, 2, 1)))


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("sk,tile", [(200, 256), (1024, 512), (1100, 512)])
def test_int8_qkpv_route_at_jax_default_tile(sk, tile, d):
    """The "qkpv" route quantizes p against the running max of JAX's kv
    tiles, min(512, round_up(Sk, 128)): 256, 512, and 512 with a ragged
    last tile of 76 rows at Sk 1100. On the same int8 operands the two
    kernels agree to 1e-5. End to end the two routes agree to 1e-5 where
    their operands do; from Sk 1024 the f32 mean of k, summed in another
    order by PyTorch and by XLA, sits an ulp apart in most channels and
    moves an int8 k value now and then (2e-4 measured at 1024/d40), well
    below what a wrong tile gives (1.5e-2 at Sk 4096, 1.8e-2 at 1024/d80:
    tile 64 against 512)."""
    assert fi.quant_tile(sk) == tile
    route, kernel = _route_against_jax(sk, d)
    assert kernel <= 1e-5
    assert route <= (1e-5 if sk < 1024 else 1e-3)


def test_int8_qkpv_route_reads_block_k_knob(monkeypatch):
    """E4T_FLASH_BLOCK_K=256, read per call by the port; the JAX package
    reads it at import, so that side takes the tile as an argument."""
    monkeypatch.setenv(fi.BLOCK_K_KNOB, "256")
    assert fi.quant_tile(1100) == 256 and fi.quant_tile(100) == 128
    route, kernel = _route_against_jax(1100, 40, jax_block_k=256)
    assert kernel <= 1e-5 and route <= 1e-3


@pytest.mark.parametrize("value", ["0", "-64", "100", "5l2"])
def test_int8_block_k_knob_refuses_bad_values(monkeypatch, value):
    monkeypatch.setenv(fi.BLOCK_K_KNOB, value)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 128, 130, 40, 16))
    with pytest.raises(ValueError, match=fi.BLOCK_K_KNOB):
        with attention.int8_flash_attention("qkpv"):
            attention.flash_attention(q, k, v)


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


@pytest.mark.parametrize("mode,out_dtype", [
    pytest.param("qk", torch.bfloat16, id="qk"),
    pytest.param("qkpv", torch.bfloat16, id="qkpv"),
    pytest.param("qk", torch.float32, id="qk-f32"),
    pytest.param("qkpv", torch.float32, id="qkpv-f32"),
])
def test_int8_sync_yardstick_runs_on_cuda_tensors_only(mode, out_dtype):
    """flash_fwd_int8_sync, the synchronous designs kept as the kernels'
    yardsticks (the f32 "qk" one included), takes no CPU tensors and counts
    no launch; a kv tile that is not a positive multiple of 64 is refused
    first."""
    i8 = torch.zeros(2, 64, 40, dtype=torch.int8)
    v = i8 if mode == "qkpv" else torch.zeros(2, 64, 40, dtype=out_dtype)
    sc = torch.ones(2, 2)
    before = dict(fi.flash_fwd_int8.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fi.flash_fwd_int8_sync(i8, i8, v, sc, mode, out_dtype)
    with pytest.raises(ValueError, match="kv tile 96"):
        fi.flash_fwd_int8_sync(i8, i8, v, sc, mode, out_dtype, 96)
    assert fi.flash_fwd_int8.launches == before
