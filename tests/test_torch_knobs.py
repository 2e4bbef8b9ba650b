"""The reference's environment knobs in the port, and the attention
kernels' operand types, on the CPU.

- ``E4T_VIT_GELU=tanh``: the port's tiny ViT against the JAX tiny ViT under
  the knob, same weights, rel-L2 1e-5 (the models' transformer tolerance);
  ``--vit_gelu_tanh`` sets it for the run.
- ``E4T_FLASH_THRESHOLD_BYTES``: ``flash_threshold_bytes()`` case by case
  against the reference's rule (its override stack, else the knob, else 128
  MiB), with and without a ``flash_threshold`` context.
- ``E4T_FUSED_QKV``: building or running the port's UNet raises, naming
  the knob, wherever the reference's parse turns it on.
- The kernels' operand types (``flash_lowdim.operand_dtype``): bf16 or f32,
  never f16 or a mix; and the int8 attention's plain version with an f32 v
  and an f32 output against the JAX int8 path in f32.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.models import unet as jax_unet
from e4t_diffusion_tpu.models.vit import VisionTransformer
from e4t_diffusion_tpu.ops import attention as jax_attention

from e4t_diffusion_torch.models import unet, vit
from e4t_diffusion_torch.ops import attention
from e4t_diffusion_torch.ops import flash_int8 as fi
from e4t_diffusion_torch.ops import flash_lowdim as fl

from torch_parity import jax_tiny, port_tiny, rel_l2

MIB = 1024 ** 2


@pytest.fixture(scope="module")
def tiny():
    jm, params = jax_tiny(seed=5)
    modules, _ = port_tiny(params)
    return jm, params, modules


@pytest.mark.parametrize("knob", ["tanh", ""])
def test_vit_gelu_knob_matches_jax(knob, tiny, monkeypatch):
    """Under ``E4T_VIT_GELU=tanh`` both towers take the tanh GELU (and
    differ from the exact one); unset, both stay exact."""
    jm, params, modules = tiny
    x = np.random.default_rng(6).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    monkeypatch.setenv("E4T_VIT_GELU", knob)
    jpool, jtok = VisionTransformer(jm.e4t_encoder.config.vit).apply(
        {"params": params["e4t"]["clip_vision"]}, jnp.asarray(x))
    with torch.no_grad():
        tpool, ttok = modules.e4t_encoder.clip_vision(torch.from_numpy(x))
    assert vit.gelu_approximate() == (knob or "none")
    assert rel_l2(tpool, jpool) <= 1e-5
    assert rel_l2(ttok, jtok) <= 1e-5
    monkeypatch.setenv("E4T_VIT_GELU", "" if knob else "tanh")
    with torch.no_grad():
        other, _ = modules.e4t_encoder.clip_vision(torch.from_numpy(x))
    assert not torch.equal(other, tpool)


def test_vit_gelu_tanh_flag_sets_the_knob(tmp_path, monkeypatch):
    """``--vit_gelu_tanh`` sets ``E4T_VIT_GELU=tanh`` before anything is
    built; without it the knob is left alone."""
    from e4t_diffusion_torch import inference

    monkeypatch.setenv("E4T_VIT_GELU", "")

    def stop(*args):
        raise KeyboardInterrupt

    monkeypatch.setattr(inference, "resolve_dtype", stop)
    argv = ["--pretrained_model_name_or_path", str(tmp_path / "missing"),
            "--image_path_or_url", str(tmp_path / "in.png")]
    with pytest.raises(KeyboardInterrupt):
        inference.main(argv)
    assert os.environ["E4T_VIT_GELU"] == ""
    with pytest.raises(KeyboardInterrupt):
        inference.main(argv + ["--vit_gelu_tanh"])
    assert os.environ["E4T_VIT_GELU"] == "tanh"
    assert vit.gelu_approximate() == "tanh"


def _reference_threshold():
    """The reference's rule (e4t_diffusion_tpu/ops/attention.py:413): the
    innermost ``flash_threshold`` in force, else the knob as its import
    parses it, else 128 MiB."""
    if jax_attention._THRESHOLD_OVERRIDE:
        return jax_attention._THRESHOLD_OVERRIDE[-1]
    return int(os.environ.get("E4T_FLASH_THRESHOLD_BYTES", 128 * MIB))


@pytest.mark.parametrize("knob", [None, "0", str(64 * MIB), str(1 << 40)])
@pytest.mark.parametrize("context", [None, 0, 256 * MIB])
def test_flash_threshold_knob(knob, context, monkeypatch):
    """``flash_threshold_bytes()`` equals the reference's threshold in each
    case, and ``flash_route`` follows it on a 192 MiB score tensor."""
    if knob is None:
        monkeypatch.delenv("E4T_FLASH_THRESHOLD_BYTES", raising=False)
    else:
        monkeypatch.setenv("E4T_FLASH_THRESHOLD_BYTES", knob)
    shape = (1, 3, 4096, 40)  # 3 x 4096^2 x 4 bytes = 192 MiB of scores
    cuda = torch.device("cuda")
    with attention.flash_threshold(context), \
            jax_attention.flash_threshold(context):
        want = _reference_threshold()
        assert attention.flash_threshold_bytes() == want
        assert attention.flash_route(shape, shape, cuda) == (
            192 * MIB > want)
    assert attention.flash_threshold_bytes() == (
        128 * MIB if knob is None else int(knob))


@pytest.mark.parametrize("value", ["1", "true", "yes", "0", "false", ""])
def test_fused_qkv_knob_raises(value, monkeypatch):
    """The port has no fused-QKV layout: wherever the reference's parse
    turns ``E4T_FUSED_QKV`` on, building and running the UNet raise a
    ValueError naming it; elsewhere both go on."""
    ucfg = unet.UNetConfig.tiny()
    model = unet.UNet2DConditionModel(ucfg)
    x = torch.zeros(1, ucfg.in_channels, 8, 8)
    ctx = torch.zeros(1, 4, ucfg.cross_attention_dim)
    monkeypatch.setenv("E4T_FUSED_QKV", value)
    if jax_unet._fused_qkv_enabled():
        with pytest.raises(ValueError, match="E4T_FUSED_QKV"):
            unet.UNet2DConditionModel(ucfg)
        with pytest.raises(ValueError, match="E4T_FUSED_QKV"):
            model(x, torch.tensor([1]), ctx)
    else:
        unet.UNet2DConditionModel(ucfg)
        with torch.no_grad():
            assert model(x, torch.tensor([1]), ctx).shape == x.shape


@pytest.mark.parametrize("dtypes,want", [
    ((torch.bfloat16,) * 3, torch.bfloat16),
    ((torch.float32,) * 3, torch.float32),
    ((torch.float16,) * 3, TypeError),
    ((torch.float32, torch.bfloat16, torch.float32), TypeError),
    ((torch.bfloat16, torch.bfloat16, torch.float16), TypeError),
])
def test_operand_dtype(dtypes, want):
    """The attention kernels take all-bf16 or all-f32 operands; the error
    names both types they take."""
    named = dict(zip(("q", "k", "v"), dtypes))
    if want is TypeError:
        with pytest.raises(TypeError, match="bfloat16 or (all )?float32"):
            fl.operand_dtype(**named)
    else:
        assert fl.operand_dtype(**named) == want
        assert fl.launch_route(40, want) == (
            "lowdim_f32" if want == torch.float32 else "lowdim")
        assert fl.launch_route(160, want) == (
            "wide_f32" if want == torch.float32 else "wide")


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_int8_reference_f32_matches_jax(mode):
    """``flash_fwd_int8_reference`` with an f32 v ("qk") and an f32 output,
    the function the f32 kernels compute, against the JAX int8 path in f32
    (its Pallas kernel in interpret mode), both at their default kv tile:
    1e-5, as tests/test_torch_flash_int8.py holds the port's route."""
    rng = np.random.default_rng(21)
    b, h, sq, sk, d = 1, 2, 128, 90, 40
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32) + 0.7
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    with jax_attention.int8_flash_attention(mode):
        ref = np.asarray(jax_attention.flash_attention(
            *map(jnp.asarray, (q, k, v))))
    flat = [torch.from_numpy(t.reshape(b * h, -1, d)) for t in (q, k, v)]
    qi, ki, v_op, sc = attention.int8_attention_operands(*flat, d ** -0.5,
                                                         mode)
    assert v_op.dtype == (torch.int8 if mode == "qkpv" else torch.float32)
    out, lse = fi.flash_fwd_int8_reference(qi, ki, v_op, sc, mode,
                                           torch.float32)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert fi.launch_key(mode, torch.float32) == f"{mode}_f32"
    assert fi.launch_key(mode, torch.bfloat16) == "bf16"
    assert rel_l2(out.reshape(ref.shape), ref) <= 1e-5
