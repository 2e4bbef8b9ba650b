"""The port's Stable-unCLIP slice against the JAX package, on the CPU.

The same weights (numpy, from a seed) go through both packages' modules;
inputs are made with numpy from a seed. Tolerances, all in f32:

- SD2-flavour UNet (per-block head counts, linear projections, projection
  class embedding): eps rel-L2 <= 1e-5;
- the Hugging Face CLIP vision tower, with its projection, and
  E4TEncoderLegacy: rel-L2 <= 1e-5;
- ``noise_image_embeddings`` at levels 0, 500 and 999: max-abs <= 1e-6;
- the tiny pipeline end to end (DPM-Solver++ with v-prediction, 3 steps,
  JAX's latents and augmentation noise passed in), CFG 10 and 1.0, noise
  levels 0 and 500: final latents rel-L2 <= 1e-5, images max-abs <= 1e-4;
- ``load_sd_unclip`` on one diffusers-format directory read by both
  packages: the same images (max-abs <= 1e-4); a stray key raises;
- the augmentation CLI: ``geometric`` writes the JAX script's file names,
  ``unclip`` runs on the tiny directory.

The JAX pipeline is built once (module scope): one compile per CFG value.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.diffusion import unclip_pipeline as jax_pipe_mod
from e4t_diffusion_tpu.diffusion.schedulers import (
    DPMSolverMultistepScheduler as JaxDPM)
from e4t_diffusion_tpu.diffusion.schedulers import (
    NoiseScheduleConfig as JaxNoiseCfg)
from e4t_diffusion_tpu.models import e4t_encoder_legacy as jax_legacy
from e4t_diffusion_tpu.models import unclip as jax_unclip
from e4t_diffusion_tpu.models import unet as jax_unet
from e4t_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from e4t_diffusion_tpu.utils import artifacts as jax_artifacts
from e4t_diffusion_tpu.utils import convert as jax_convert
from e4t_diffusion_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer

from e4t_diffusion_torch import image_variation_augmentation as aug_cli
from e4t_diffusion_torch.diffusion import unclip_pipeline as pipe_mod
from e4t_diffusion_torch.models import e4t_encoder_legacy as legacy
from e4t_diffusion_torch.models import unclip
from e4t_diffusion_torch.models import unet as unet_mod
from e4t_diffusion_torch.utils import artifacts, convert
from e4t_diffusion_torch.utils.tokenizer import (
    CLIPTokenizer, make_tiny_tokenizer_files)

from torch_parity import _fill, rel_l2

UNET_REL_L2 = 1e-5
VISION_REL_L2 = 1e-5
NOISE_AUG_MAX_ABS = 1e-6
LATENTS_REL_L2 = 1e-5
IMAGES_MAX_ABS = 1e-4
STEPS = 3
BATCH = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init_shapes(module, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(functools.partial(module.init, **kwargs), key,
                          *args)["params"]


def _sd2_unet_config():
    """Tiny SD2 flavour: 8-dim heads at level 0, 32-dim at level 1 (the up
    blocks read the tuple reversed), linear projections, class
    embedding."""
    return dataclasses.replace(
        jax_unet.UNetConfig.tiny(), attention_head_dim=(4, 2),
        use_linear_projection=True, class_embed_type="projection",
        projection_class_embeddings_input_dim=24)


def _port_unet_config(cfg):
    return unet_mod.UNetConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(unet_mod.UNetConfig)})


def test_sd2_unet_matches_jax():
    cfg = _sd2_unet_config()
    jm = jax_unet.UNet2DConditionModel(cfg)
    rng = np.random.default_rng(0)
    params = _fill(_init_shapes(jm, jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
                                jnp.zeros((1, 7, 32)),
                                class_labels=jnp.zeros((1, 24))), rng)
    model = unet_mod.UNet2DConditionModel(_port_unet_config(cfg)).eval()
    model.load_state_dict(convert.unet_from_jax(_np(params)), strict=True)
    assert isinstance(model.down_blocks[0].attentions[0].proj_in,
                      torch.nn.Linear)
    heads = [model.down_blocks[0].attentions[0].transformer_blocks[0]
             .attn1.heads, model.mid_block.attentions[0]
             .transformer_blocks[0].attn1.heads,
             model.up_blocks[1].attentions[0].transformer_blocks[0]
             .attn1.heads]
    assert heads == [4, 2, 4]

    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([3, 800])
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    cls = rng.standard_normal((2, 24)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                             jnp.asarray(t), jnp.asarray(ctx),
                             class_labels=jnp.asarray(cls))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx), class_labels=torch.from_numpy(cls))
        assert rel_l2(got, want) <= UNET_REL_L2
        with pytest.raises(ValueError, match="class_labels required"):
            model(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(ctx))


def test_sd2_configs_match_jax():
    """The full-width SD2 / SD2-unclip UNet and the SD2 text encoder configs
    are the JAX package's, and the port's SD2-unclip UNet holds the
    diffusers keys the JAX converter writes (on the meta device)."""
    from e4t_diffusion_tpu.models.clip_text import CLIPTextConfig as JaxText

    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig

    for name in ("sd2", "sd2_unclip"):
        assert dataclasses.asdict(getattr(unet_mod.UNetConfig, name)()) == \
            dataclasses.asdict(getattr(jax_unet.UNetConfig, name)())
    assert dataclasses.asdict(CLIPTextConfig.sd2()) == \
        dataclasses.asdict(JaxText.sd2())
    cfg = unet_mod.UNetConfig.sd2_unclip()
    with torch.device("meta"):
        keys = set(unet_mod.UNet2DConditionModel(cfg).state_dict())
    assert {"class_embedding.linear_1.weight",
            "down_blocks.0.attentions.0.proj_in.weight",
            "up_blocks.3.attentions.2.proj_out.bias"} <= keys
    v1 = unet_mod.UNetConfig()
    assert (not isinstance(cfg.attention_head_dim, int)
            and cfg.use_linear_projection)
    assert (isinstance(v1.attention_head_dim, int)
            and not v1.use_linear_projection)


def _vision_config_pair():
    return jax_legacy.CLIPVisionConfig.tiny(), legacy.CLIPVisionConfig.tiny()


def test_clip_vision_models_match_jax():
    """The HF vision tower (pooled and every hidden state) and the tower
    with its projection, same weights, rel-L2 <= 1e-5."""
    jcfg, cfg = _vision_config_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)

    jm = jax_legacy.CLIPVisionModel(jcfg)
    params = _fill(_init_shapes(jm, jnp.zeros((1, 3, 28, 28))), rng)
    model = legacy.CLIPVisionModel(cfg).eval()
    model.load_state_dict(convert.clip_vision_hf_from_jax(
        _np(params), cfg.num_layers), strict=True)
    jpooled, jhidden = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        pooled, hidden = model(torch.from_numpy(x))
    assert rel_l2(pooled, jpooled) <= VISION_REL_L2
    assert len(hidden) == len(jhidden) == cfg.num_layers + 1
    assert max(rel_l2(a, b) for a, b in zip(hidden, jhidden)) <= VISION_REL_L2

    jpcfg = jax_unclip.CLIPVisionProjectionConfig.tiny()
    jpm = jax_unclip.CLIPVisionModelWithProjection(jpcfg)
    pparams = _fill(_init_shapes(jpm, jnp.zeros((1, 3, 28, 28))), rng)
    pmodel = unclip.CLIPVisionModelWithProjection(
        unclip.CLIPVisionProjectionConfig.tiny()).eval()
    pmodel.load_state_dict(convert.clip_vision_with_projection_from_jax(
        _np(pparams), cfg.num_layers), strict=True)
    want = jpm.apply({"params": pparams}, jnp.asarray(x))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x))
    assert got.shape == (2, 16)
    assert rel_l2(got, want) <= VISION_REL_L2


def test_legacy_encoder_matches_jax():
    """E4TEncoderLegacy on the same weights, image and UNet features (NHWC
    in JAX, NCHW in the port), rel-L2 <= 1e-5."""
    jcfg = jax_legacy.E4TEncoderLegacyConfig.tiny()
    jm = jax_legacy.E4TEncoderLegacy(jcfg)
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((2, 5, 5, c)).astype(np.float32)
             for c in jcfg.block_out_channels]
    params = _fill(_init_shapes(jm, jnp.zeros((2, 3, 40, 40)),
                                [jnp.asarray(f) for f in feats]), rng)
    model = legacy.E4TEncoderLegacy(legacy.E4TEncoderLegacyConfig.tiny())
    model.load_state_dict(convert.e4t_encoder_legacy_from_jax(
        _np(params), jcfg.vision.num_layers), strict=True)
    x = rng.uniform(-1, 1, (2, 3, 40, 40)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), [
            torch.from_numpy(f.transpose(0, 3, 1, 2)) for f in feats])
    assert got.shape == (2, 32)
    assert rel_l2(got, want) <= VISION_REL_L2


def _normalizer_np(rng, d):
    return {"mean": rng.standard_normal(d).astype(np.float32),
            "std": rng.uniform(0.5, 1.5, d).astype(np.float32)}


@pytest.mark.parametrize("level", [0, 500, 999])
def test_noise_image_embeddings_matches_jax(level):
    rng = np.random.default_rng(level)
    d = 16
    embeds = rng.standard_normal((2, d)).astype(np.float32)
    noise = rng.standard_normal((2, d)).astype(np.float32)
    norm = _normalizer_np(rng, d)
    levels = np.array([level, level], np.int32)
    want = jax_unclip.noise_image_embeddings(
        jnp.asarray(embeds), jnp.asarray(levels), jnp.asarray(noise),
        {k: jnp.asarray(v) for k, v in norm.items()})
    normalizer = unclip.StableUnCLIPImageNormalizer(d)
    normalizer.load_state_dict(convert.image_normalizer_from_jax(norm))
    with torch.no_grad():
        got = unclip.noise_image_embeddings(
            torch.from_numpy(embeds), torch.from_numpy(levels),
            torch.from_numpy(noise), normalizer)
    assert got.shape == (2, 2 * d)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= NOISE_AUG_MAX_ABS


# ---------------------------------------------------------------------------
# the tiny pipeline, end to end
# ---------------------------------------------------------------------------

def _jax_unclip_params(jm, seed):
    tcfg = jm.text_encoder.config
    icfg = jm.image_encoder.config
    rng = np.random.default_rng(seed)
    shapes = {
        "unet": _init_shapes(
            jm.unet, jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
            jnp.zeros((1, tcfg.max_position_embeddings, tcfg.hidden_size)),
            class_labels=jnp.zeros((1, 2 * icfg.projection_dim))),
        "vae": jax.eval_shape(jm.vae.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 3, 16, 16)),
                              jax.random.PRNGKey(0))["params"],
        "text": _init_shapes(jm.text_encoder, jnp.zeros(
            (1, tcfg.max_position_embeddings), jnp.int32)),
        "image_encoder": _init_shapes(jm.image_encoder, jnp.zeros(
            (1, 3, icfg.vision.image_size, icfg.vision.image_size)))}
    params = {k: _fill(v, rng) for k, v in shapes.items()}
    params["image_normalizer"] = {
        k: jnp.asarray(v)
        for k, v in _normalizer_np(rng, icfg.projection_dim).items()}
    return params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX tiny pipeline and the port's on the same weights, with one
    tokenizer directory."""
    jm = jax_pipe_mod.UnCLIPModules.tiny()
    params = _jax_unclip_params(jm, seed=3)
    tok_dir = make_tiny_tokenizer_files(
        str(tmp_path_factory.mktemp("tok")), extra_words=["photo"])
    length = jm.text_encoder.config.max_position_embeddings
    sched_cfg = JaxNoiseCfg(prediction_type="v_prediction")
    jpipe = jax_pipe_mod.StableUnCLIPImg2ImgPipeline(
        jm, params, JaxTokenizer.from_pretrained(
            tok_dir, model_max_length=length), scheduler=JaxDPM(sched_cfg))
    modules = pipe_mod.UnCLIPModules.tiny(device="cpu")
    modules.load_state_dicts(convert.unclip_state_dicts_from_jax(
        _np(params), modules))
    pipe = pipe_mod.StableUnCLIPImg2ImgPipeline(
        modules, CLIPTokenizer.from_pretrained(tok_dir,
                                               model_max_length=length))
    # a non-square source: both pipelines center-crop it for the encoder
    image = np.random.default_rng(4).integers(0, 256, (40, 32, 3),
                                              dtype=np.uint8)
    return {"jax": jpipe, "port": pipe, "image": image, "params": params,
            "tok_dir": tok_dir}


def _jax_run(jpipe, image, guidance, level, seed, latents):
    """JAX's final latents and images: the latents from the pipeline, the
    decode as its sampler does it (one compile per CFG value)."""
    lat = jpipe(image, num_inference_steps=STEPS, guidance_scale=guidance,
                noise_level=level, num_images_per_prompt=BATCH, seed=seed,
                latents=latents, output_type="latent")
    vae = jpipe.modules.vae
    images = _jax_decode(vae)({"params": jpipe.params["vae"]},
                              jnp.asarray(lat) / vae.config.scaling_factor)
    return np.asarray(lat), np.asarray(jnp.clip(images / 2.0 + 0.5, 0, 1))


@functools.lru_cache(maxsize=None)
def _jax_decode(vae):
    return jax.jit(functools.partial(vae.apply, method=JaxVAE.decode))


def _jax_aug_noise(seed, d):
    """The JAX pipeline's augmentation draw for ``seed``."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), 0x51AB1E)
    return np.asarray(jax.random.normal(rng, (BATCH, d), jnp.float32))


@pytest.mark.parametrize("guidance,level", [(10.0, 0), (10.0, 500),
                                            (1.0, 0), (1.0, 500)])
def test_pipeline_matches_jax(world, guidance, level):
    seed = 5
    latents = np.random.default_rng(6).standard_normal(
        (BATCH, 4, 8, 8)).astype(np.float32)
    want_lat, want_img = _jax_run(world["jax"], world["image"], guidance,
                                  level, seed, latents)
    pipe = world["port"]
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=guidance,
                  noise_level=level, num_images_per_prompt=BATCH,
                  latents=latents, aug_noise=_jax_aug_noise(seed, 16))
    lat = pipe(world["image"], output_type="latent", **kwargs)
    img = pipe(world["image"], output_type="np", **kwargs)
    assert img.shape == (BATCH, 3, 16, 16)
    assert rel_l2(lat, want_lat) <= LATENTS_REL_L2
    assert np.abs(img - want_img).max() <= IMAGES_MAX_ABS


def test_pipeline_seeded_draws(world):
    """Without latents / aug_noise the draws come from the seed: the same
    seed gives the same images, another seed others, noise level matters,
    and "pil" gives uint8 images of the "np" output."""
    pipe, image = world["port"], world["image"]
    kwargs = dict(num_inference_steps=2, guidance_scale=5.0,
                  num_images_per_prompt=BATCH, output_type="np")
    a = pipe(image, seed=1, **kwargs)
    assert np.array_equal(a, pipe(image, seed=1, **kwargs))
    assert np.abs(a - pipe(image, seed=2, **kwargs)).max() > 1e-6
    assert np.abs(a - pipe(image, seed=1, noise_level=500,
                           **kwargs)).max() > 1e-6
    pil = pipe(image, seed=1, **{**kwargs, "output_type": "pil"})
    assert len(pil) == BATCH and pil[0].size == (16, 16)
    assert np.array_equal(np.asarray(pil[0]),
                          (a[0].transpose(1, 2, 0) * 255).round()
                          .astype(np.uint8))


# ---------------------------------------------------------------------------
# load_sd_unclip and the CLI
# ---------------------------------------------------------------------------

def _write_unclip_dir(root, world):
    """A diffusers-format stable-diffusion-2-1-unclip directory holding the
    world's weights (written through the JAX package's and the port's
    converters), with keys of the real configs that the readers ignore."""
    jm = world["jax"].modules
    params = world["params"]
    ucfg, vcfg = jm.unet.config, jm.vae.config
    tcfg, icfg = jm.text_encoder.config, jm.image_encoder.config

    def folder(name, cfg, weights, file):
        os.makedirs(os.path.join(root, name))
        if cfg is not None:
            cfg_file = ("scheduler_config.json" if "scheduler" in name
                        else "config.json")
            with open(os.path.join(root, name, cfg_file), "w") as f:
                json.dump(cfg, f)
        if weights is not None:
            torch.save({k: torch.as_tensor(np.array(v, np.float32))
                        for k, v in weights.items()},
                       os.path.join(root, name, file))

    folder("unet", {
        "_class_name": "UNet2DConditionModel", "act_fn": "silu",
        "sample_size": ucfg.sample_size,
        "down_block_types": list(ucfg.down_block_types),
        "up_block_types": list(ucfg.up_block_types),
        "block_out_channels": list(ucfg.block_out_channels),
        "layers_per_block": ucfg.layers_per_block,
        "attention_head_dim": ucfg.attention_head_dim,
        "cross_attention_dim": ucfg.cross_attention_dim,
        "norm_num_groups": ucfg.norm_num_groups,
        "use_linear_projection": True, "class_embed_type": "projection",
        "projection_class_embeddings_input_dim":
            ucfg.projection_class_embeddings_input_dim,
        "num_class_embeds": None, "upcast_attention": False},
        jax_convert.unet_to_torch(params["unet"]),
        "diffusion_pytorch_model.bin")
    folder("vae", {"_class_name": "AutoencoderKL",
                   "block_out_channels": list(vcfg.block_out_channels),
                   "layers_per_block": vcfg.layers_per_block,
                   "norm_num_groups": vcfg.norm_num_groups,
                   "sample_size": vcfg.sample_size},
           jax_convert.vae_to_torch(params["vae"]),
           "diffusion_pytorch_model.bin")
    folder("text_encoder", {
        "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
        "num_hidden_layers": tcfg.num_layers,
        "num_attention_heads": tcfg.num_heads,
        "intermediate_size": tcfg.intermediate_size,
        "max_position_embeddings": tcfg.max_position_embeddings,
        "hidden_act": tcfg.hidden_act, "projection_dim": 512},
        jax_convert.clip_text_to_torch(params["text"], tcfg.num_layers),
        "pytorch_model.bin")
    vis = icfg.vision
    img_sd = convert.clip_vision_with_projection_from_jax(
        _np(params["image_encoder"]), vis.num_layers)
    img_sd["vision_model.embeddings.position_ids"] = torch.arange(
        vis.num_positions)[None]
    folder("image_encoder", {
        "hidden_size": vis.hidden_size, "num_hidden_layers": vis.num_layers,
        "num_attention_heads": vis.num_heads,
        "intermediate_size": vis.intermediate_size,
        "image_size": vis.image_size, "patch_size": vis.patch_size,
        "projection_dim": icfg.projection_dim, "hidden_act": vis.hidden_act,
        "dropout": 0.0}, img_sd, "pytorch_model.bin")
    folder("image_normalizer", {"embedding_dim": icfg.projection_dim},
           convert.image_normalizer_from_jax(
               _np(params["image_normalizer"])),
           "diffusion_pytorch_model.bin")
    folder("scheduler", {"beta_start": 0.00085, "beta_end": 0.012,
                         "beta_schedule": "scaled_linear",
                         "num_train_timesteps": 1000, "steps_offset": 1,
                         "prediction_type": "v_prediction",
                         "_class_name": "DDIMScheduler"}, None, None)
    folder("image_noising_scheduler", {
        "beta_schedule": "squaredcos_cap_v2", "num_train_timesteps": 1000,
        "_class_name": "DDPMScheduler"}, None, None)
    shutil.copytree(world["tok_dir"], os.path.join(root, "tokenizer"))
    return root


@pytest.fixture(scope="module")
def unclip_dir(world, tmp_path_factory):
    return _write_unclip_dir(str(tmp_path_factory.mktemp("m") / "unclip"),
                             world)


def test_load_sd_unclip_matches_jax(world, unclip_dir):
    """One directory, read by both packages' ``load_sd_unclip``: the same
    configs, and the same images from the JAX pipeline on the JAX reader's
    weights and the CLI's pipeline on the port's."""
    jl = jax_artifacts.load_sd_unclip(unclip_dir)
    pl = artifacts.load_sd_unclip(unclip_dir)
    for key in ("unet_config", "vae_config", "text_config",
                "schedule_config", "noise_aug_schedule"):
        assert dataclasses.asdict(pl[key]) == dataclasses.asdict(jl[key]), key
    assert dataclasses.asdict(pl["image_encoder_config"]) == \
        dataclasses.asdict(jl["image_encoder_config"])

    jpipe = world["jax"]
    saved = jpipe.params
    jpipe.params = {"unet": jl["unet"], "vae": jl["vae"], "text": jl["text"],
                    "image_encoder": jl["image_encoder"],
                    "image_normalizer": jl["image_normalizer"]}
    latents = np.random.default_rng(7).standard_normal(
        (BATCH, 4, 8, 8)).astype(np.float32)
    try:
        _, want = _jax_run(jpipe, world["image"], 10.0, 100, 9, latents)
    finally:
        jpipe.params = saved
    pipe = aug_cli.build_unclip_pipeline(unclip_dir, "cpu")
    got = pipe(world["image"], num_inference_steps=STEPS,
               guidance_scale=10.0, noise_level=100,
               num_images_per_prompt=BATCH, latents=latents,
               aug_noise=_jax_aug_noise(9, 16), output_type="np")
    assert np.abs(got - want).max() <= IMAGES_MAX_ABS


@pytest.mark.parametrize("folder,file", [
    ("image_encoder", "pytorch_model.bin"),
    ("image_normalizer", "diffusion_pytorch_model.bin")])
def test_load_sd_unclip_stray_key_raises(unclip_dir, tmp_path, folder, file):
    root = str(tmp_path / "unclip")
    shutil.copytree(unclip_dir, root)
    path = os.path.join(root, folder, file)
    sd = torch.load(path, weights_only=True)
    sd["stray.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="stray.weight"):
        aug_cli.build_unclip_pipeline(root, "cpu")


def test_e4t_loader_refuses_sd2_base(unclip_dir):
    """``load_sd_base`` reads the Stable-unCLIP directory (an SD v2-family
    base), as the JAX package's loader does; an E4T pipeline on its UNet,
    whose projection class embedding needs ``class_labels``, raises the
    JAX package's ValueError at its first UNet call in both packages and
    returns no images."""
    from e4t_diffusion_tpu.config import AttributeDict as JaxAttributeDict
    from e4t_diffusion_tpu.diffusion.pipeline import E4TModules as JaxMods
    from e4t_diffusion_tpu.diffusion.pipeline import (
        StableDiffusionE4TPipeline as JaxE4TPipeline)
    from e4t_diffusion_tpu.models import weight_offsets as jax_wo
    from e4t_diffusion_tpu.models.e4t_encoder import (
        E4TEncoderConfig as JaxEncoderConfig)

    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.diffusion.pipeline import (
        E4TModules, StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.models import weight_offsets as wo

    base = artifacts.load_sd_base(unclip_dir)
    ucfg = base["unet_config"]
    assert (ucfg.class_embed_type == "projection"
            and ucfg.use_linear_projection)
    width = base["text_config"].hidden_size
    enc_cfg = artifacts.e4t_encoder_config_from_args(
        AttributeDict({"vit_config": "tiny"}), word_embedding_dim=width,
        unet_config=ucfg)
    e4t_config = {"placeholder_token": "*s", "domain_class_token": "photo",
                  "domain_embed_scale": 0.1}
    length = base["text_config"].max_position_embeddings
    image = np.random.default_rng(5).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    modules = E4TModules.create(ucfg, base["vae_config"],
                                base["text_config"], enc_cfg,
                                dtype=torch.float32, device="cpu")
    modules.load_state_dicts({k: base[k] for k in ("unet", "vae", "text")})
    pipe = StableDiffusionE4TPipeline(
        modules, wo.init_offset_bank(ucfg, torch.Generator().manual_seed(0)),
        CLIPTokenizer.from_pretrained(base["tokenizer_dir"],
                                      model_max_length=length),
        AttributeDict(e4t_config))
    with pytest.raises(ValueError, match="class_labels required"):
        pipe("a photo of *s", image, num_inference_steps=1)

    jl = jax_artifacts.load_sd_base(unclip_dir)
    jm = JaxMods.create(jl["unet_config"], jl["vae_config"],
                        jl["text_config"], JaxEncoderConfig.tiny(
                            word_embedding_dim=width,
                            unet_feature_dim=enc_cfg.unet_feature_dim))
    rng = np.random.default_rng(6)
    params = {k: jl[k] for k in ("unet", "vae", "text")}
    params["e4t"] = _fill(_init_shapes(
        jm.e4t_encoder, jnp.zeros((1, 3, 32, 32)),
        jnp.zeros((1, enc_cfg.unet_feature_dim))), rng)
    params["offsets"] = jax_wo.init_offset_bank(jax.random.PRNGKey(0),
                                                jl["unet_config"])
    jpipe = JaxE4TPipeline(jm, params, JaxTokenizer.from_pretrained(
        jl["tokenizer_dir"], model_max_length=length),
        JaxAttributeDict(e4t_config))
    with pytest.raises(ValueError, match="class_labels required"):
        jpipe("a photo of *s", image, num_inference_steps=1)


def _write_sources(folder):
    os.makedirs(folder)
    from PIL import Image

    rng = np.random.default_rng(8)
    for i, (h, w) in enumerate(((48, 40), (40, 40), (36, 52))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(folder, f"{i}.png"))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_image_variation_augmentation",
        os.path.join(REPO, "scripts", "image_variation_augmentation.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_geometric_matches_jax_script(tmp_path, monkeypatch, capsys):
    src = str(tmp_path / "src")
    _write_sources(src)
    common = ["--train_image_dataset", src, "--num_images_per_image", "3",
              "--resolution", "32", "--seed", "11"]
    monkeypatch.setattr(sys, "argv", ["x", *common, "--save_dir",
                                      str(tmp_path / "jax")])
    _jax_script().main()
    jax_out = capsys.readouterr().out
    aug_cli.main([*common, "--save_dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 9
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert port_out.replace("port", "jax") == jax_out


def test_cli_unclip_runs_on_tiny_dir(unclip_dir, tmp_path, capsys):
    src = str(tmp_path / "src")
    _write_sources(src)
    out = str(tmp_path / "out")
    aug_cli.main(["--train_image_dataset", src, "--save_dir", out,
                  "--num_images_per_image", "2", "--resolution", "24",
                  "--mode", "unclip", "--unclip_model_path", unclip_dir,
                  "--num_inference_steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["3 source images", f"wrote 6 images to {out}"]
    names = os.listdir(out)
    assert len(names) == 6 and all(n.endswith(".jpg") for n in names)
    with pytest.raises(SystemExit, match="requires --unclip_model_path"):
        aug_cli.main(["--train_image_dataset", src, "--save_dir", out,
                      "--mode", "unclip"])


@pytest.mark.parametrize("batch,per_pass,routes", [
    (8, 15, False), (4, 10, False), (8, 15, True)])
def test_chip_smoke_unclip_launches(batch, per_pass, routes):
    """``chip_smoke.py``'s derivation of the unCLIP call's attention
    launches at 768px: with CFG (batch 8) 5 self-attention sites at each of
    96², 48² and 24² reach the low-dim kernel; at batch 4 the 576-token
    sites' f32 scores (106 MB) fall under 128 MiB; cross-attention stays
    on einsum, and so does the mid block's 144-token self-attention unless
    ``E4T_SHORTSEQ_MH_ATTN`` sends it to the short-sequence kernel."""
    import chip_smoke

    want = chip_smoke._expected_unclip_launches(
        unet_mod.UNetConfig.sd2_unclip(), batch, 768, 20, routes=routes)
    assert want == chip_smoke._want(flash_fwd_lowdim=per_pass * 20,
                                    flash_fwd_shortseq=20 if routes else 0)
