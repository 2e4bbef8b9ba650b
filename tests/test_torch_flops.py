"""The port's analytic FLOP counts (``e4t_diffusion_torch/utils/flops.py``)
against the JAX package's: the same integers for every supported
configuration, and on the tiny modules within [0.8, 1.02] of what
``torch.utils.flop_counter.FlopCounterMode`` counts on the einsum attention
path (the CPU takes no flash route), as ``tests/test_flops.py`` holds the
JAX counts to XLA's cost analysis. No JAX compile."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from e4t_diffusion_tpu.models import clip_text as jax_text
from e4t_diffusion_tpu.models import unet as jax_unet
from e4t_diffusion_tpu.models import vae as jax_vae
from e4t_diffusion_tpu.models import vit as jax_vit
from e4t_diffusion_tpu.utils import flops as jax_flops

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
from e4t_diffusion_torch.models.unet import UNetConfig
from e4t_diffusion_torch.models.vae import VAEConfig
from e4t_diffusion_torch.models.vit import ViTConfig, VisionTransformer
from e4t_diffusion_torch.utils import flops

# (name, the port's count, the JAX package's count), each a thunk
UNET_CASES = {
    "sd_v1_512": (lambda f, u: f.unet_forward(u.UNetConfig(), 64)),
    "sd_v1_256": (lambda f, u: f.unet_forward(u.UNetConfig(), 32)),
    "sd_v1_encoder_half": (lambda f, u: f.unet_forward(
        u.UNetConfig(), 64, encoder_half_only=True)),
    "sd2_768": (lambda f, u: f.unet_forward(u.UNetConfig.sd2(96), 96)),
    "sd2_encoder_half": (lambda f, u: f.unet_forward(
        u.UNetConfig.sd2(96), 96, ctx_len=77, encoder_half_only=True)),
    "sd2_unclip_768": (lambda f, u: f.unet_forward(u.UNetConfig.sd2_unclip(),
                                                   96)),
    "tiny_16": (lambda f, u: f.unet_forward(u.UNetConfig.tiny(), 16,
                                            ctx_len=16)),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_counts_equal_jax(case):
    from e4t_diffusion_torch.models import unet as port_unet

    got = UNET_CASES[case](flops, port_unet)
    want = UNET_CASES[case](jax_flops, jax_unet)
    assert isinstance(got, int) and got == want


@pytest.mark.parametrize("hw", [64, 96, 16])
def test_vae_decode_counts_equal_jax(hw):
    port_cfg = VAEConfig() if hw != 16 else VAEConfig.tiny()
    jax_cfg = jax_vae.VAEConfig() if hw != 16 else jax_vae.VAEConfig.tiny()
    got = flops.vae_decode(port_cfg, hw)
    assert isinstance(got, int) and got == jax_flops.vae_decode(jax_cfg, hw)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", ["vit_h_14", "tiny"])
def test_vit_counts_equal_jax(name, batch):
    got = flops.vit_forward(getattr(ViTConfig, name)(), batch)
    want = jax_flops.vit_forward(getattr(jax_vit.ViTConfig, name)(), batch)
    assert isinstance(got, int) and got == want


@pytest.mark.parametrize("name", ["clip_l", "sd2", "tiny"])
def test_text_encoder_counts_equal_jax(name):
    port_cfg, jax_cfg = ((CLIPTextConfig(), jax_text.CLIPTextConfig())
                         if name == "clip_l" else
                         (getattr(CLIPTextConfig, name)(),
                          getattr(jax_text.CLIPTextConfig, name)()))
    for batch in (1, 8):
        got = flops.text_encoder_forward(port_cfg, batch)
        assert isinstance(got, int)
        assert got == jax_flops.text_encoder_forward(jax_cfg, batch)


def test_building_blocks_equal_jax():
    for fn, args in (("conv2d", (64, 64, 320, 640)),
                     ("conv2d", (64, 64, 320, 320, 3, 2)),
                     ("dense", (77, 768, 320)),
                     ("attention", (4096, 77, 320, 8)),
                     ("transformer_block", (1024, 77, 640, 1024)),
                     ("resnet_block", (32, 32, 320, 640, 1280)),
                     ("tx2d", (16, 16, 1280, 77, 768, True))):
        assert getattr(flops, fn)(*args) == getattr(jax_flops, fn)(*args)


def test_peaks_are_the_h100s():
    """The card's datasheet peaks, no TPU constant."""
    assert (flops.H100_BF16_PEAK, flops.H100_INT8_PEAK,
            flops.H100_F32_PEAK) == (989e12, 1979e12, 67e12)
    assert not [n for n in vars(flops) if "V5E" in n or "TPU" in n]


def _counted(fn, *args):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return E4TModules.tiny(device="cpu")


def test_unet_flops_match_counter(tiny):
    cfg = tiny.unet.config
    hw, n_ctx = 16, tiny.text_encoder.config.max_position_embeddings
    got = _counted(tiny.unet, torch.zeros(1, 4, hw, hw),
                   torch.zeros(1, dtype=torch.long),
                   torch.zeros(1, n_ctx, cfg.cross_attention_dim))
    want = flops.unet_forward(cfg, hw, ctx_len=n_ctx)
    assert 0.8 < want / got <= 1.02, (want, got)


def test_vae_decode_flops_match_counter(tiny):
    hw = 16
    got = _counted(tiny.vae.decode, torch.zeros(1, 4, hw, hw))
    want = flops.vae_decode(tiny.vae.config, hw)
    assert 0.8 < want / got <= 1.05, (want, got)


def test_vit_flops_match_counter():
    """The bare tower (``encode_image`` adds the resize as a product whose
    cost depends on the input size)."""
    torch.manual_seed(0)
    cfg = ViTConfig.tiny()
    vit = VisionTransformer(cfg)
    got = _counted(vit, torch.zeros(2, 3, cfg.image_size, cfg.image_size))
    want = flops.vit_forward(cfg, batch=2)
    # tiny scale: the (uncounted) pooled-head LN is a visible slice
    assert 0.7 < want / got <= 1.05, (want, got)


def test_text_encoder_flops_match_counter(tiny):
    tcfg = tiny.text_encoder.config
    ids = torch.zeros(2, tcfg.max_position_embeddings, dtype=torch.long)
    got = _counted(tiny.text_encoder, ids)
    want = flops.text_encoder_forward(tcfg, batch=2)
    assert 0.8 < want / got <= 1.02, (want, got)


def test_sd_v1_headline_magnitudes():
    """The SD-v1 figures in TFLOP per image (ViT-H/14: 632M encoder
    parameters x 2 FLOPs a MAC x 257 tokens ~ 0.33T; the VAE decoder's
    128px/256px/512px stages each ~0.5-0.9T of 3x3x512 conv work, ~2.5T in
    all), and the SD 2.1 UNet at 768px."""
    unet = flops.unet_forward(UNetConfig(), 64) / 1e12
    assert 0.6 < unet < 1.0, unet
    enc_half = flops.unet_forward(UNetConfig(), 64,
                                  encoder_half_only=True) / 1e12
    assert 0.2 < enc_half < 0.45 and enc_half < unet / 2, enc_half
    vae = flops.vae_decode(VAEConfig(), 64) / 1e12
    assert 2.0 < vae < 3.0, vae
    vit = flops.vit_forward(ViTConfig.vit_h_14()) / 1e12
    assert 0.25 < vit < 0.45, vit
    text = flops.text_encoder_forward(CLIPTextConfig()) / 1e9
    assert 5 < text < 30, text
    sd2 = flops.unet_forward(UNetConfig.sd2(96), 96) / 1e12
    assert 1.8 < sd2 < 2.6, sd2
    # a batch-8 SD v1 UNet forward at the bf16 peak
    ms = 8 * flops.unet_forward(UNetConfig(), 64) / flops.H100_BF16_PEAK * 1e3
    assert np.isclose(ms, 6.5, atol=0.1), ms
