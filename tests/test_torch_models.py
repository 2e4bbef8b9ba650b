"""Each ported model against its JAX counterpart, f32 on the CPU, with the
JAX weights carried across by ``state_dicts_from_jax``.

Tolerances: rel-L2 1e-5 for the transformers (CLIP text, ViT, the E4T
head) and 1e-4 for the conv stacks (UNet, VAE), whose longer f32
reduction chains (3x3 convs, GroupNorm over many channels) sum in another
order in XLA and in PyTorch.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.models import weight_offsets as jax_wo
from e4t_diffusion_tpu.models.e4t_encoder import E4TEncoder as JaxE4TEncoder
from e4t_diffusion_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from e4t_diffusion_tpu.ops import resize as jax_resize

from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.models.unet import pool_encoder_features
from e4t_diffusion_torch.ops import resize

from torch_parity import jax_tiny, port_tiny, rel_l2

TRANSFORMER_TOL = 1e-5
CONV_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jm, params = jax_tiny(seed=0)
    modules, sds = port_tiny(params)
    return jm, params, modules, sds


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_clip_text_ids(tiny):
    jm, params, modules, _ = tiny
    ids = np.random.default_rng(0).integers(0, 1000, (2, 16))
    jh, jp = jm.text_encoder.apply({"params": params["text"]},
                                   jnp.asarray(ids))
    th, tp = modules.text_encoder(torch.from_numpy(ids))
    assert rel_l2(th.detach(), jh) <= TRANSFORMER_TOL
    assert rel_l2(tp.detach(), jp) <= TRANSFORMER_TOL


def test_clip_text_inputs_embeds(tiny):
    jm, params, modules, _ = tiny
    emb = _rand((2, 16, 32), 1)
    jh, _ = jm.text_encoder.apply({"params": params["text"]},
                                  inputs_embeds=jnp.asarray(emb))
    th, _ = modules.text_encoder(inputs_embeds=torch.from_numpy(emb))
    assert rel_l2(th.detach(), jh) <= TRANSFORMER_TOL


def test_embed_tokens(tiny):
    from e4t_diffusion_tpu.models.clip_text import embed_tokens

    _, params, modules, _ = tiny
    ids = np.array([[3, 999, 0, 42]])
    np.testing.assert_array_equal(
        modules.text_encoder.embed_tokens(torch.from_numpy(ids)).detach(),
        np.asarray(embed_tokens(params["text"], jnp.asarray(ids))))


def test_vit(tiny):
    jm, params, modules, _ = tiny
    from e4t_diffusion_tpu.models.vit import VisionTransformer

    cfg = jm.e4t_encoder.config.vit
    x = _rand((2, 3, 28, 28), 2)
    jpool, jtok = VisionTransformer(cfg).apply(
        {"params": params["e4t"]["clip_vision"]}, jnp.asarray(x))
    tpool, ttok = modules.e4t_encoder.clip_vision(torch.from_numpy(x))
    assert rel_l2(tpool.detach(), jpool) <= TRANSFORMER_TOL
    assert rel_l2(ttok.detach(), jtok) <= TRANSFORMER_TOL


@pytest.mark.parametrize("size", [32, 64])
def test_clip_preprocess(size):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 3, size, size)).astype(
        np.float32)
    ref = jax_resize.clip_preprocess(jnp.asarray(x), 28)
    out = resize.clip_preprocess(torch.from_numpy(x), 28)
    assert rel_l2(out, ref) <= TRANSFORMER_TOL


def test_e4t_encode_image_and_fuse(tiny):
    jm, params, modules, _ = tiny
    pixels = np.random.default_rng(4).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    feats = _rand((2, jm.e4t_encoder.config.unet_feature_dim), 5)
    variables = {"params": params["e4t"]}
    jclip = jm.e4t_encoder.apply(variables, jnp.asarray(pixels),
                                 method=JaxE4TEncoder.encode_image)
    tclip = modules.e4t_encoder.encode_image(torch.from_numpy(pixels))
    assert tclip.shape == (2, 3, 32)  # pooled + tokens[1::2] of a 2x2 grid
    assert rel_l2(tclip.detach(), jclip) <= TRANSFORMER_TOL
    jout = jm.e4t_encoder.apply(variables, jclip, jnp.asarray(feats),
                                method=JaxE4TEncoder.fuse)
    tout = modules.e4t_encoder.fuse(torch.from_numpy(np.asarray(jclip)),
                                    torch.from_numpy(feats))
    assert rel_l2(tout.detach(), jout) <= TRANSFORMER_TOL


def test_e4t_state_dict_keeps_reference_layout(tiny):
    _, _, modules, sds = tiny
    sd = modules.e4t_encoder.state_dict()
    assert set(sd) == set(sds["e4t"])
    assert "first_linears.2.weight" in sd and "first_linears_weight" not in sd
    modules.e4t_encoder.load_state_dict(sd, strict=True)
    missing = {k: v for k, v in sd.items() if k != "first_linears.0.bias"}
    with pytest.raises(RuntimeError, match="first_linears"):
        modules.e4t_encoder.load_state_dict(missing, strict=True)


def _unet_inputs():
    return (_rand((2, 4, 8, 8), 6), np.array([10, 500]), _rand((2, 16, 32), 7))


def _nhwc_to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def test_unet_eps(tiny):
    jm, params, modules, _ = tiny
    x, t, ctx = _unet_inputs()
    ref = jm.unet.apply({"params": params["unet"]}, jnp.asarray(x),
                        jnp.asarray(t), jnp.asarray(ctx))
    out = modules.unet(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(ctx))
    assert rel_l2(out.detach(), ref) <= CONV_TOL


@pytest.mark.parametrize("mode", [True, "with_eps"])
def test_unet_tap(tiny, mode):
    jm, params, modules, _ = tiny
    x, t, ctx = _unet_inputs()
    ref = jm.unet.apply({"params": params["unet"]}, jnp.asarray(x),
                        jnp.asarray(t), jnp.asarray(ctx),
                        return_encoder_outputs=mode)
    out = modules.unet(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(ctx), return_encoder_outputs=mode)
    if mode == "with_eps":
        (ref_eps, ref), (out_eps, out) = ref, out
        assert rel_l2(out_eps.detach(), ref_eps) <= CONV_TOL
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert rel_l2(o.detach(), _nhwc_to_nchw(r)) <= CONV_TOL
    from e4t_diffusion_tpu.models.unet import (
        pool_encoder_features as jax_pool)
    pooled = pool_encoder_features(out)
    assert pooled.shape == (2, 224)
    assert rel_l2(pooled.detach(), jax_pool(ref)) <= CONV_TOL


def test_vae_decode(tiny):
    jm, params, modules, _ = tiny
    z = _rand((2, 4, 8, 8), 8)
    ref = jm.vae.apply({"params": params["vae"]}, jnp.asarray(z),
                       method=JaxAutoencoderKL.decode)
    out = modules.vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 3, 16, 16)
    assert rel_l2(out.detach(), ref) <= CONV_TOL


def test_fold_offset_bank_matches_jax(tiny):
    """Folded weights equal JAX's folded kernels, transposed (1e-6: the
    same f32 products, batched the same way)."""
    _, params, modules, sds = tiny
    ref = jax_wo.fold_offset_bank(params["unet"], params["offsets"])
    folded = wo.fold_offset_bank(modules.unet, sds["offsets"])
    assert len(folded) == 3 * len(jax_wo.attention_sites(
        modules.unet.config))
    for name, w in folded.items():
        node = ref
        for part in re.sub(r"\.(\d+)", r"_\1", name).split(".")[:-1]:
            node = node[part]
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(node["kernel"]).T, atol=1e-6)


def test_offset_bank_keys(tiny):
    _, _, modules, sds = tiny
    wo.check_bank(sds["offsets"], modules.unet.config)
    fresh = wo.init_offset_bank(modules.unet.config,
                                torch.Generator().manual_seed(0))
    assert set(fresh) == set(sds["offsets"])
    for k, v in fresh.items():
        assert v.shape == sds["offsets"][k].shape, k
    with pytest.raises(KeyError, match="missing"):
        wo.check_bank({k: v for k, v in fresh.items()
                       if not k.endswith(".v")}, modules.unet.config)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_act(act):
    import flax.linen as nn

    from e4t_diffusion_torch.models.norm import group_norm_act

    x = _rand((2, 16, 4, 4), 9)
    norm = torch.nn.GroupNorm(4, 16, eps=1e-6)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    gn = nn.GroupNorm(num_groups=4, epsilon=1e-6)
    ref = gn.apply({"params": {"scale": jnp.asarray(norm.weight.detach()),
                               "bias": jnp.asarray(norm.bias.detach())}},
                   jnp.asarray(x.transpose(0, 2, 3, 1)))
    if act == "silu":
        ref = jax.nn.silu(ref)
    out = group_norm_act(torch.from_numpy(x), norm, act)
    assert rel_l2(out.detach(), _nhwc_to_nchw(ref)) <= TRANSFORMER_TOL


def _external(family):
    """(a module with a published checkpoint layout, the port's module)."""
    from torch_unet_oracle import TorchTinyUNet
    from torch_vae_oracle import TorchAutoencoderKL
    from torch_vit_oracle import TorchOpenClipVisionTower

    from e4t_diffusion_torch.models import clip_text, unet, vae, vit

    if family == "unet":
        return (TorchTinyUNet(ctx_dim=32),
                unet.UNet2DConditionModel(unet.UNetConfig.tiny()))
    if family == "vae":
        cfg = vae.VAEConfig.tiny()
        return (TorchAutoencoderKL(block_out_channels=cfg.block_out_channels,
                                   layers_per_block=cfg.layers_per_block,
                                   norm_num_groups=cfg.norm_num_groups),
                vae.AutoencoderKL(cfg))
    if family == "vit":
        return (TorchOpenClipVisionTower(28, 14, 32, 2, 4, 64),
                vit.VisionTransformer(vit.ViTConfig.tiny()))
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel as HFModel

    hf = HFModel(HFConfig(vocab_size=100, hidden_size=32,
                          intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=16,
                          hidden_act="quick_gelu"))
    return hf, clip_text.CLIPTextModel(clip_text.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position_embeddings=16))


@pytest.mark.parametrize("family", ["unet", "vae", "vit", "text"])
def test_published_layouts_load_strictly(family):
    """diffusers / open_clip / transformers state dicts (through the
    repo's independent torch oracles and HF transformers) load into the
    port with strict=True, and both compute the same function."""
    from e4t_diffusion_torch.utils import artifacts

    torch.manual_seed(0)
    src, dst = _external(family)
    src.eval()
    sd = src.state_dict()
    if family == "text":
        sd = artifacts._text_state_dict(sd)
    dst.load_state_dict(sd, strict=True)
    with torch.no_grad():
        if family == "unet":
            args = (torch.randn(2, 4, 8, 8), torch.tensor([17, 901]),
                    torch.randn(2, 7, 32))
            pairs = [(dst(*args), src(*args))]
        elif family == "vae":
            z = torch.randn(2, 4, 8, 8)
            pairs = [(dst.decode(z), src.decode(z))]
        elif family == "vit":
            x = torch.randn(2, 3, 28, 28)
            pairs = list(zip(dst(x), src(x)))
        else:
            ids = torch.randint(0, 100, (2, 16))
            pairs = [(dst(ids)[0], src(input_ids=ids).last_hidden_state)]
    tol = CONV_TOL if family in ("unet", "vae") else TRANSFORMER_TOL
    for ours, theirs in pairs:
        assert rel_l2(ours, theirs) <= tol


def test_vae_encode_and_sample_latent(tiny):
    """encode -> (mean, logvar) and the posterior draw with the same
    injected noise (the JAX draw's normal deviates, fed to the port)."""
    from e4t_diffusion_tpu.models.vae import sample_latent as jax_sample
    from e4t_diffusion_torch.models.vae import sample_latent

    jm, params, modules, _ = tiny
    x = np.random.default_rng(9).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    jmean, jlogvar = jm.vae.apply({"params": params["vae"]}, jnp.asarray(x),
                                  method=JaxAutoencoderKL.encode)
    mean, logvar = modules.vae.encode(torch.from_numpy(x))
    assert mean.shape == logvar.shape == (2, 4, 16, 16)
    assert rel_l2(mean.detach(), jmean) <= CONV_TOL
    assert rel_l2(logvar.detach(), jlogvar) <= CONV_TOL
    key = jax.random.PRNGKey(4)
    noise = jax.random.normal(key, jmean.shape, jmean.dtype)
    ref = jax_sample(jmean, jlogvar, key)
    got = sample_latent(mean, logvar, torch.from_numpy(np.asarray(noise)))
    assert rel_l2(got.detach(), ref) <= CONV_TOL


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedules_match_optax(name, warmup):
    from e4t_diffusion_tpu.training.setup import (
        make_lr_schedule as jax_schedule)
    from e4t_diffusion_torch.training.setup import make_lr_schedule

    # optax evaluates in f32: near a cosine's end 1 + cos(pi x) cancels to
    # ~1e-6 relative error, so 1e-5 of the peak lr absolute
    lr = 2e-4
    want = np.asarray(jax_schedule(name, lr, warmup, 20)(jnp.arange(25)))
    got = make_lr_schedule(name, lr, warmup, 20)
    np.testing.assert_allclose([got(n) for n in range(25)], want, rtol=1e-6,
                               atol=1e-5 * lr)


def test_template_sampler_and_transform_draw_like_jax(tmp_path):
    """The same seed gives the JAX package's template draws, crops and
    flips (numpy default_rng in the same order), resize included."""
    from e4t_diffusion_tpu.data.dataset import make_transform as jax_tf
    from e4t_diffusion_tpu.training.setup import (
        TemplateSampler as JaxSampler)
    from e4t_diffusion_tpu.utils.tokenizer import (
        CLIPTokenizer as JaxTokenizer, make_tiny_tokenizer_files)
    from e4t_diffusion_torch.data.dataset import make_transform
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training.setup import TemplateSampler
    from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

    tok_dir = make_tiny_tokenizer_files(str(tmp_path),
                                        extra_words=["photo", "of", "a"])
    templates = resolve_templates("a photo of {placeholder_token}") + [
        "a {placeholder_token}", "{placeholder_token} photo"]
    samplers = []
    for cls in (JaxTokenizer, CLIPTokenizer):
        tok = cls.from_pretrained(tok_dir, model_max_length=16)
        tok.add_tokens("*s")
        sampler_cls = JaxSampler if cls is JaxTokenizer else TemplateSampler
        samplers.append(sampler_cls(templates, tok, "*s",
                                    tok.convert_tokens_to_ids("*s"), seed=3))
    np.testing.assert_array_equal(samplers[0].uncond_ids,
                                  samplers[1].uncond_ids)
    for _ in range(3):
        (jids, jph), (ids, ph) = (s.sample(5) for s in samplers)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(ph, jph)

    image = np.random.default_rng(2).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8)
    for crop in (True, False):
        jt, tt = (f(32, random_crop_flag=crop, seed=11)
                  for f in (jax_tf, make_transform))
        for _ in range(4):
            np.testing.assert_array_equal(tt(image), jt(image))
