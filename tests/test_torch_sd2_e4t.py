"""E4T on an SD v2-family base in the port against the JAX package, on the
CPU.

One tiny SD2 E4T world, module-scoped: the tiny UNet with SD 2.x's options
(per-block head counts, 8-dim heads at level 0 and 32-dim at level 1, and
linear ``proj_in`` / ``proj_out``), a cross width equal to the text width,
a text tower on "gelu" (OpenCLIP-H's activation), v-prediction, a 224-wide
tap and 8 offset sites. Its weights are drawn with numpy from a seed and
cross over through ``convert.state_dicts_from_jax``; latents, pixels and
noise are made with numpy and passed to both packages.

Tolerances, f32 on the CPU:

- sampling, DDIM and DPM++ 2M under v-prediction (3 steps, CFG 7.5):
  final latents rel-L2 <= 1e-5, images max-abs <= 1e-4, as
  ``tests/test_torch_unclip.py`` holds unCLIP;
- one tuning step (UNet, offsets and encoder trained, clip 1.0) and one
  pretraining step (offsets and encoder): loss terms rel 1e-5, gradients
  rel-L2 1e-4 per group, the AdamW update rel-L2 1e-3, the tolerances of
  ``tests/test_torch_train_step.py``. The JAX step is compiled once: the
  pretraining step's gradients are the tuning step's raw gradients of the
  two groups both phases train (the loss is the same function of them),
  and its update is the JAX package's pretraining optimizer applied to
  them outside the step;
- ``offset_linear_apply``: value rel-L2 <= 1e-6, gradients 1e-5;
- the artifacts the port's CLIs write on a tiny SD2 diffusers directory
  (pretrain, then tune, then sample) load strictly in the JAX package, and
  the JAX package's in the port, to the same tensors; a 23-layer text tower
  and a 1024-wide encoder round-trip both ways.
"""
import dataclasses
import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.config import AttributeDict as JaxAttributeDict
from e4t_diffusion_tpu.config import load_config as jax_load_config
from e4t_diffusion_tpu.diffusion.pipeline import E4TModules as JaxModules
from e4t_diffusion_tpu.diffusion.pipeline import (
    StableDiffusionE4TPipeline as JaxPipeline)
from e4t_diffusion_tpu.diffusion import schedulers as jax_sched
from e4t_diffusion_tpu.models import weight_offsets as jax_wo
from e4t_diffusion_tpu.models.clip_text import CLIPTextConfig as JaxText
from e4t_diffusion_tpu.models.e4t_encoder import (
    E4TEncoderConfig as JaxEncoderConfig)
from e4t_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from e4t_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from e4t_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from e4t_diffusion_tpu.ops import quant as jax_quant
from e4t_diffusion_tpu.training import train_step as jax_ts
from e4t_diffusion_tpu.utils import artifacts as jax_artifacts
from e4t_diffusion_tpu.utils import convert as jax_convert
from e4t_diffusion_tpu.utils import hub as jax_hub
from e4t_diffusion_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer

from e4t_diffusion_torch import inference, pretrain_e4t, tuning_e4t
from e4t_diffusion_torch.config import AttributeDict
from e4t_diffusion_torch.diffusion import schedulers
from e4t_diffusion_torch.diffusion.pipeline import (
    E4TModules, StableDiffusionE4TPipeline)
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
from e4t_diffusion_torch.models.vae import VAEConfig
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.training import train_step as ts
from e4t_diffusion_torch.training.setup import default_resolution
from e4t_diffusion_torch.utils import artifacts, convert, hub
from e4t_diffusion_torch.utils.tokenizer import (
    CLIPTokenizer, make_tiny_tokenizer_files)

from test_artifacts import _write_sd_base
from test_torch_train_step import _first_update, _keep_grads, _port_names
from torch_parity import _fill, _offset_leaf, rel_l2

LATENTS_REL_L2 = 1e-5
IMAGES_MAX_ABS = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
OFFSET_LINEAR_REL_L2 = 1e-6
# the hypernetwork's gradients sum over every element of the offset (the
# seed v's over all of them): one reduction's order, as the loss terms
OFFSET_LINEAR_GRAD_REL_L2 = 1e-5
# the int8 UNet's error against f32 on one input: above it a scale or a
# layout is wrong, not quantization (chip_smoke.INT8_VS_BF16_REL_L2)
INT8_REL_L2 = 0.25
LR = 1e-4
STEPS = 3
E4T_CONFIG = {"placeholder_token": "*s", "domain_class_token": "face",
              "domain_embed_scale": 0.1}
WORDS = ["photo", "of", "a", "the", "face"]
PROMPTS = ["a photo of *s", "a *s face"]
V_PRED = dict(prediction_type="v_prediction")
TUNE_CFG = dict(train_unet=True, max_grad_norm=1.0, reg_lambda=0.01,
                domain_embed_scale=0.1)
PRETRAIN_CFG = dict(TUNE_CFG, train_unet=False, max_grad_norm=None)
REGISTRY_NAME = "e4t-diffusion-ffhq-celebahq-v1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sd2_configs():
    """The tiny SD2 flavour in both packages: (JAX UNet, text, encoder
    configs; the port's)."""
    ucfg = dataclasses.replace(JaxUNetConfig.tiny(),
                               attention_head_dim=(4, 2),
                               use_linear_projection=True)
    tcfg = dataclasses.replace(JaxText.tiny(), hidden_act="gelu")
    ecfg = JaxEncoderConfig.tiny(word_embedding_dim=tcfg.hidden_size)
    port = (UNetConfig(**dataclasses.asdict(ucfg)),
            CLIPTextConfig(**dataclasses.asdict(tcfg)),
            E4TEncoderConfig.tiny(word_embedding_dim=tcfg.hidden_size))
    return (ucfg, tcfg, ecfg), port


def _shapes(jm, text_len):
    tcfg = jm.text_encoder.config
    ecfg = jm.e4t_encoder.config
    key = jax.random.PRNGKey(0)
    return {
        "unet": jax.eval_shape(
            jm.unet.init, key, jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
            jnp.zeros((1, text_len, tcfg.hidden_size)))["params"],
        "vae": jax.eval_shape(jm.vae.init, key, jnp.zeros((1, 3, 32, 32)),
                              key)["params"],
        "text": jax.eval_shape(
            jm.text_encoder.init, key,
            jnp.zeros((1, text_len), jnp.int32))["params"],
        "e4t": jax.eval_shape(
            jm.e4t_encoder.init, key, jnp.zeros((1, 3, 32, 32)),
            jnp.zeros((1, ecfg.unet_feature_dim)))["params"]}


def _jax_params(jm, seed):
    rng = np.random.default_rng(seed)
    params = {k: _fill(v, rng) for k, v in _shapes(
        jm, jm.text_encoder.config.max_position_embeddings).items()}
    bank = jax.eval_shape(functools.partial(
        jax_wo.init_offset_bank, unet_config=jm.unet.config),
        jax.random.PRNGKey(0))
    params["offsets"] = jax.tree_util.tree_map_with_path(
        lambda path, s: _offset_leaf(str(path[-1].key), s.shape, rng), bank)
    return params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_modules(port_cfgs, params):
    ucfg, tcfg, ecfg = port_cfgs
    modules = E4TModules.create(ucfg, VAEConfig.tiny(), tcfg, ecfg,
                                dtype=torch.float32, device="cpu")
    sds = convert.state_dicts_from_jax(_np(params), modules)
    modules.load_state_dicts({k: sds[k]
                              for k in ("unet", "vae", "text", "e4t")})
    return modules, sds


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jax_cfgs, port_cfgs = _sd2_configs()
    jm = JaxModules.create(jax_cfgs[0], JaxVAEConfig.tiny(), *jax_cfgs[1:])
    params = _jax_params(jm, seed=17)
    modules, sds = _port_modules(port_cfgs, params)
    tok_dir = make_tiny_tokenizer_files(
        str(tmp_path_factory.mktemp("tok")), extra_words=WORDS)
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    return {"jm": jm, "params": params, "modules": modules, "sds": sds,
            "tok_dir": tok_dir, "image": image}


def test_sd2_world_is_the_sd2_flavour(world):
    """The world's UNet takes per-block heads and linear projections, the
    tap is 224 wide in both packages, the bank has 8 sites (24 offsets) in
    both, and the hypernetworks' inner width is each block's width."""
    jm, modules = world["jm"], world["modules"]
    ucfg = modules.unet.config
    assert (not isinstance(ucfg.attention_head_dim, int)
            and ucfg.use_linear_projection
            and ucfg.class_embed_type is None)
    assert tap_feature_dim(ucfg) == 224
    assert modules.e4t_encoder.config.unet_feature_dim == 224
    assert isinstance(modules.unet.down_blocks[0].attentions[0].proj_in,
                      torch.nn.Linear)
    sites = wo.attention_sites(ucfg)
    assert len(sites) == len(jax_wo.attention_sites(jm.unet.config)) == 8
    bank = world["sds"]["offsets"]
    wo.check_bank(bank, ucfg)
    for path, qdim, kvdim in sites:
        attn = modules.unet.get_submodule(path)
        assert attn.to_q.weight.shape == (qdim, qdim)
        assert attn.to_k.weight.shape == (qdim, kvdim)
        assert bank[f"{path}.wo_k.linear2.weight"].shape == (qdim, 1)
    # the bank's key set and shapes are those of the port's own init
    fresh = wo.init_offset_bank(ucfg, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in bank.items()}


def test_offset_bank_at_sd2_widths_matches_jax(monkeypatch):
    """The bank at SD 2.1's full widths (sites of 320, 640 and 1280
    channels, cross sites reading the 1024-wide text): the JAX package's
    bank, carried through ``convert.offsets_from_jax``, has the port's
    keys and shapes (both on shapes alone: the meta device and
    ``jax.eval_shape``)."""
    ucfg = UNetConfig.sd2()
    bank = jax.eval_shape(functools.partial(
        jax_wo.init_offset_bank, unet_config=JaxUNetConfig.sd2()),
        jax.random.PRNGKey(0))
    monkeypatch.setattr(convert, "_tensor", lambda x: torch.empty(
        x.shape, device="meta"))
    monkeypatch.setattr(convert, "_t", lambda x: torch.empty(
        x.shape[::-1], device="meta"))
    got = convert.offsets_from_jax(bank)
    want = wo.init_offset_bank(ucfg, device="meta")
    wo.check_bank(got, ucfg)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    sites = wo.attention_sites(ucfg)
    assert len(sites) == 32
    assert {q for _, q, _ in sites} == {320, 640, 1280}
    assert {kv for p, _, kv in sites if p.endswith("attn2")} == {1024}
    assert want["mid_block.attentions.0.transformer_blocks.0.attn2.wo_k"
                ".linear_column.weight"].shape == (1024, 1024)


# ---------------------------------------------------------------------------
# sampling under v-prediction
# ---------------------------------------------------------------------------

def _latents(n, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 4, 8, 8)).astype(np.float32)


def _port_pipe(world, scheduler_type, **kwargs):
    return StableDiffusionE4TPipeline(
        world["modules"], world["sds"]["offsets"],
        CLIPTokenizer.from_pretrained(world["tok_dir"], model_max_length=16),
        AttributeDict(E4T_CONFIG),
        scheduler=schedulers.SCHEDULER_MAPPING[scheduler_type](
            schedulers.NoiseScheduleConfig(**V_PRED)), **kwargs)


@functools.lru_cache(maxsize=None)
def _jax_decode(vae):
    return jax.jit(functools.partial(vae.apply, method=JaxVAE.decode))


@pytest.mark.parametrize("scheduler_type", ["ddim", "dpm_solver++"])
def test_sampling_matches_jax(world, scheduler_type):
    """The E4T loop (uncond tap pass, fuse, CLIP text on the injected
    embedding, cond pass, CFG on the v output, the sampler) on the same
    latents: JAX's latents from its pipeline, its images from its VAE
    decode of them (one compile a sampler and one decode)."""
    jm, params = world["jm"], world["params"]
    jpipe = JaxPipeline(
        jm, params, JaxTokenizer.from_pretrained(world["tok_dir"],
                                                 model_max_length=16),
        JaxAttributeDict(E4T_CONFIG),
        scheduler=jax_sched.SCHEDULER_MAPPING[scheduler_type](
            jax_sched.NoiseScheduleConfig(**V_PRED)))
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=7.5,
                  num_images_per_prompt=2, latents=_latents(4))
    want_lat = np.asarray(jpipe(PROMPTS, world["image"],
                                output_type="latent", **kwargs))
    scale = jm.vae.config.scaling_factor
    want_img = np.asarray(jnp.clip(_jax_decode(jm.vae)(
        {"params": params["vae"]}, jnp.asarray(want_lat) / scale)
        / 2.0 + 0.5, 0.0, 1.0))
    pipe = _port_pipe(world, scheduler_type)
    lat = pipe(PROMPTS, world["image"], output_type="latent", **kwargs)
    img = pipe(PROMPTS, world["image"], **kwargs)
    assert img.shape == (4, 3, 16, 16)
    assert rel_l2(lat, want_lat) <= LATENTS_REL_L2
    assert np.abs(img - want_img).max() <= IMAGES_MAX_ABS
    assert not np.allclose(img[0], img[2])  # the two prompts differ


@pytest.mark.parametrize("scheduler_type",
                         ["plms", "lms", "euler", "euler_ancestral"])
def test_other_samplers_run_on_the_v_schedule(world, scheduler_type):
    """The four other samplers on the SD2 world (their v-prediction steps
    are held against JAX's in tests/test_torch_schedulers_more.py): finite
    images in [0, 1], the same seed the same images, and the prediction
    type read from the pipeline's schedule also when ``scheduler_type``
    picks the sampler at the call."""
    pipe = _port_pipe(world, scheduler_type)
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=7.5, seed=4)
    a = pipe(PROMPTS[0], world["image"], **kwargs)
    assert a.shape == (1, 3, 16, 16) and np.isfinite(a).all()
    assert a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(a, pipe(PROMPTS[0], world["image"],
                                          **kwargs))
    picked = _port_pipe(world, "ddim")(PROMPTS[0], world["image"],
                                       scheduler_type=scheduler_type,
                                       **kwargs)
    np.testing.assert_array_equal(a, picked)


def test_int8_unet_sites_match_jax(world):
    """int8 serving on the SD2 UNet: the port quantizes the sites the JAX
    package quantizes, the linear proj_in / proj_out among them, with the
    same weight scales; a static int8 run calibrates every one of them and
    stays within the int8 error bound of the f32 images."""
    sds, params = world["sds"], world["params"]
    port_sites = quant.quantize_params(world["modules"].unet.state_dict())
    jq = jax_quant.quantize_params(params["unet"])
    jax_sites = {}

    def visit(tree, path):
        if isinstance(tree, dict) and "q" in tree and "s" in tree:
            jax_sites["/".join(path[:-1])] = tree  # the kernel's module
        elif isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, path + [k])

    visit(jq, [])
    got = {quant.jax_path(name): site for name, site in port_sites.items()}
    assert set(got) == set(jax_sites)
    assert any(p.endswith("proj_in") for p in got)
    assert isinstance(world["modules"].unet.down_blocks[0].attentions[0]
                      .proj_out, torch.nn.Linear)
    for path, site in got.items():
        np.testing.assert_allclose(site["s"].numpy(),
                                   np.asarray(jax_sites[path]["s"]).ravel(),
                                   rtol=1e-6, err_msg=path)
    kwargs = dict(num_inference_steps=2, guidance_scale=7.5,
                  num_images_per_prompt=2, latents=_latents(2, seed=5))
    ref = _port_pipe(world, "ddim")(PROMPTS[0], world["image"], **kwargs)
    pipe8 = _port_pipe(world, "ddim", int8="static")
    out8 = pipe8(PROMPTS[0], world["image"], **kwargs)
    assert {quant.jax_path(n) for n in pipe8.act_amax} >= {
        p for p in got if p.endswith(("proj_in", "proj_out"))}
    assert 0.0 < rel_l2(out8, ref) <= INT8_REL_L2
    assert sds["offsets"]  # the offsets were folded before quantizing


# ---------------------------------------------------------------------------
# one tuning step and one pretraining step under the v target
# ---------------------------------------------------------------------------

def _batch(seed=0, bsz=2):
    """A batch without latents: both phases' steps VAE-encode the pixels,
    the posterior, noise and timesteps drawn from the step's keys."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (bsz, 16))
    ph = np.array([3, 5][:bsz])
    ids[np.arange(bsz), ph] = 999
    return {
        "pixel_values": rng.uniform(-1, 1, (bsz, 3, 32, 32)).astype(
            np.float32),
        "input_ids": ids.astype(np.int32),
        "placeholder_idx": ph.astype(np.int32),
        "uncond_ids": rng.integers(0, 1000, (1, 16)).astype(np.int32),
        "class_token_id": np.asarray(5, np.int32),
    }


@pytest.fixture(scope="module")
def steps(world):
    """The JAX tuning step, jitted once, with its draws, raw and clipped
    gradients and updated parameters; and the JAX package's pretraining
    optimizer applied to the raw gradients of the offsets and the
    encoder head."""
    jm, params = world["jm"], world["params"]
    jcfg = jax_ts.E4TTrainConfig(**TUNE_CFG)
    tx = optax.chain(_keep_grads(), jax_ts.make_optimizer(LR, jcfg))
    state, frozen = jax_ts.create_train_state(params, jcfg, tx)
    batch, rng = _batch(), jax.random.PRNGKey(9)
    ddpm = jax_sched.DDPMScheduler(jax_sched.NoiseScheduleConfig(**V_PRED))
    step = jax.jit(jax_ts.make_train_step(jm, ddpm, jcfg, tx))
    new_state, metrics = step(state, frozen,
                              jax.tree_util.tree_map(jnp.asarray, batch), rng)
    k_noise, k_t, k_vae = jax.random.split(jax.random.fold_in(rng, 0), 3)
    shape = (2, 4, 16, 16)
    draws = {
        "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(
            k_t, (2,), 0, ddpm.config.num_train_timesteps)),
        "posterior_noise": np.array(jax.random.normal(k_vae, shape,
                                                      jnp.float32))}
    raw = _np(new_state.opt_state[0].grads)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    pre_groups = ("offsets", "e4t")
    pre_raw = {g: raw[g] for g in pre_groups}
    # no clip: the norm is the raw gradients' global norm
    pre_norm, pre_after = _first_update(
        jax_ts.make_optimizer(LR, jax_ts.E4TTrainConfig(**PRETRAIN_CFG)),
        pre_raw, {g: state.trainable[g] for g in pre_groups})
    n_text = jm.text_encoder.config.num_layers
    n_vit = jm.e4t_encoder.config.vit.num_layers

    def port_named(tree):
        tree = _np(tree)
        return {g: _port_names(g, tree[g], frozen, n_text, n_vit)
                for g in tree}

    return {"batch": batch, "draws": draws,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "tune": {"grads": port_named(jax.tree_util.tree_map(
                         lambda m: m / (1 - 0.9), adam.mu)),
                     "before": port_named(state.trainable),
                     "after": port_named(new_state.trainable)},
            "pretrain": {"grads": port_named(pre_raw),
                         "grad_norm": pre_norm,
                         "after": port_named(pre_after)}}


def _port_step(world, cfg_kwargs, batch):
    """One port step from the world's weights: (trainable groups before,
    their tensors, the gradients AdamW applied, metrics)."""
    _, port_cfgs = _sd2_configs()
    modules, sds = _port_modules(port_cfgs, world["params"])
    cfg = ts.E4TTrainConfig(**cfg_kwargs)
    trainable, _ = ts.split_trainable(modules, sds["offsets"], cfg,
                                      torch.float32)
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    flat = [t for g in trainable.values() for t in g.values()]
    optimizer = ts.make_optimizer(flat, LR)
    seen = {}
    optimizer.register_step_pre_hook(lambda *_: seen.update(
        {g: {k: t.grad.clone() for k, t in group.items()}
         for g, group in trainable.items()}))
    step = ts.make_train_step(
        modules, schedulers.DDPMScheduler(
            schedulers.NoiseScheduleConfig(**V_PRED)), cfg, trainable,
        optimizer, lambda n: LR)
    metrics = {k: float(v) for k, v in step(batch).items()}
    return before, trainable, seen, metrics


def _flat(group, keys):
    return np.concatenate([group[k].detach().numpy().ravel() for k in keys])


def _check_step(ref, before, trainable, seen):
    for g, group in seen.items():
        keys = sorted(group)
        assert set(keys) == set(ref["grads"][g])
        assert rel_l2(_flat(group, keys), _flat(ref["grads"][g], keys)) \
            <= GRAD_TOL, g
    for g, group in trainable.items():
        keys = sorted(group)
        start = _flat(before[g], keys)
        got = _flat(group, keys) - start
        want = _flat(ref["after"][g], keys) - start
        assert np.abs(got).max() > 0, g
        assert rel_l2(got, want) <= UPDATE_TOL, g


def _batch_with_draws(steps):
    out = {k: torch.from_numpy(np.asarray(v))
           for k, v in {**steps["batch"], **steps["draws"]}.items()}
    for k in ("input_ids", "placeholder_idx", "uncond_ids", "class_token_id",
              "timesteps"):
        out[k] = out[k].long()
    return out


def test_tuning_step_matches_jax(world, steps):
    """Tuning on the SD2 world (the whole UNet, the offsets and the encoder
    head; the v target; the fold in f32; the tap and the full pass under
    checkpointing): losses, clipped gradients and the AdamW update."""
    before, trainable, seen, metrics = _port_step(
        world, TUNE_CFG, _batch_with_draws(steps))
    assert set(trainable) == {"unet", "e4t", "offsets"}
    for g, group in before.items():
        for k, t in group.items():
            torch.testing.assert_close(t, steps["tune"]["before"][g][k],
                                       msg=k)
    for k in ("loss", "loss_diff", "loss_reg", "grad_norm"):
        assert metrics[k] == pytest.approx(steps["metrics"][k],
                                           rel=LOSS_TOL), k
    assert steps["metrics"]["grad_norm"] > 1.0  # the clip was active
    _check_step(steps["tune"], before, trainable, seen)


def test_pretraining_step_matches_jax(world, steps):
    """Pretraining on the SD2 world (offsets and encoder head, no clip):
    the gradients JAX's step gives those groups, and the update the JAX
    package's pretraining optimizer makes of them."""
    before, trainable, seen, metrics = _port_step(
        world, PRETRAIN_CFG, _batch_with_draws(steps))
    assert set(trainable) == {"e4t", "offsets"}
    for k in ("loss", "loss_diff", "loss_reg"):
        assert metrics[k] == pytest.approx(steps["metrics"][k],
                                           rel=LOSS_TOL), k
    ref = steps["pretrain"]
    assert metrics["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=GRAD_TOL)
    _check_step(ref, before, trainable, seen)


# ---------------------------------------------------------------------------
# offset_linear_apply
# ---------------------------------------------------------------------------

def test_offset_linear_apply_matches_jax(world):
    """y = x (W * (1 + O))^T + b at one cross site of the world's bank
    (the port's (out, in) layout; JAX's (in, out)): the value, and the
    gradients in x, W, b and every hypernetwork tensor."""
    params = world["params"]
    site = "mid_block.attentions_0.transformer_blocks_0.attn2"
    torch_site = "mid_block.attentions.0.transformer_blocks.0.attn2"
    wo_params = params["offsets"][site]["wo_k"]
    rng = np.random.default_rng(3)
    row, col = wo_params["linear1"]["kernel"].shape[1], \
        wo_params["linear2"]["kernel"].shape[1]
    kernel = rng.standard_normal((row, col)).astype(np.float32) / 8
    bias = rng.standard_normal(col).astype(np.float32)
    x = rng.standard_normal((2, 5, row)).astype(np.float32)
    g = rng.standard_normal((2, 5, col)).astype(np.float32)

    def jax_loss(p, k, x_, b):
        return jnp.sum(jax_wo.offset_linear_apply(p, k, x_, b) * g)

    want_y = np.asarray(jax_wo.offset_linear_apply(
        wo_params, jnp.asarray(kernel), jnp.asarray(x), jnp.asarray(bias)))
    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        wo_params, jnp.asarray(kernel), jnp.asarray(x), jnp.asarray(bias))

    bank = {k: v.clone().requires_grad_(True)
            for k, v in world["sds"]["offsets"].items()
            if k.startswith(f"{torch_site}.wo_k.")}
    weight = torch.from_numpy(kernel.T.copy()).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = wo.offset_linear_apply(bank, f"{torch_site}.wo_k", weight, xt, bt)
    assert rel_l2(y.detach(), want_y) <= OFFSET_LINEAR_REL_L2
    (y * torch.from_numpy(g)).sum().backward()
    assert rel_l2(xt.grad, want[2]) <= OFFSET_LINEAR_GRAD_REL_L2
    assert rel_l2(bt.grad, want[3]) <= OFFSET_LINEAR_GRAD_REL_L2
    assert rel_l2(weight.grad.T, want[1]) <= OFFSET_LINEAR_GRAD_REL_L2
    want_bank = convert.offsets_from_jax(_np({site: {"wo_k": want[0]}}))
    assert set(want_bank) == set(bank)
    for k, t in bank.items():
        assert rel_l2(t.grad, want_bank[k]) <= OFFSET_LINEAR_GRAD_REL_L2, k
    # the same fold as fold_offset_bank's at that site
    folded = wo.fold_offset_bank(world["modules"].unet, bank)
    with torch.no_grad():
        at_site = wo.offset_linear_apply(
            bank, f"{torch_site}.wo_k",
            world["modules"].unet.get_submodule(torch_site).to_k.weight, xt)
        torch.testing.assert_close(
            at_site, xt @ folded[f"{torch_site}.to_k.weight"].T)


# ---------------------------------------------------------------------------
# the artifacts and the CLIs on an SD2 diffusers directory
# ---------------------------------------------------------------------------

def _write_sd2_base(path, world):
    """A diffusers-format tiny SD2 directory of the world's weights: the
    SD v1 writer's folders with SD 2.x's keys (linear projections, the
    text tower's gelu, the v-prediction schedule) and a tokenizer."""
    sd = _write_sd_base(path, world["jm"], _np(world["params"]))
    for sub, name, extra in (
            ("unet", "config.json", {"use_linear_projection": True}),
            ("text_encoder", "config.json", {"hidden_act": "gelu"}),
            ("scheduler", "scheduler_config.json", V_PRED)):
        file = os.path.join(sd, sub, name)
        with open(file, encoding="utf-8") as f:
            cfg = json.load(f)
        with open(file, "w", encoding="utf-8") as f:
            json.dump(dict(cfg, **extra), f)
    make_tiny_tokenizer_files(os.path.join(sd, "tokenizer"),
                              extra_words=WORDS)
    return sd


@pytest.fixture(scope="module")
def sd2_dir(world, tmp_path_factory):
    root = tmp_path_factory.mktemp("sd2")
    sd = _write_sd2_base(str(root / "sd"), world)
    os.makedirs(root / "data")
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 36), (30, 50), (32, 32), (60, 44)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(root / "data" / f"{i}.png")
    Image.fromarray(world["image"]).save(root / "in.png")
    return root, sd


def test_load_sd_base_reads_the_sd2_base_as_jax(world, sd2_dir):
    """Both packages' loaders read the directory to the same configs (the
    per-block heads, linear projections, gelu, v-prediction); the port's
    state dicts load strictly and equal the world's."""
    _, sd = sd2_dir
    pl, jl = artifacts.load_sd_base(sd), jax_artifacts.load_sd_base(sd)
    for key in ("unet_config", "vae_config", "text_config",
                "schedule_config"):
        assert dataclasses.asdict(pl[key]) == dataclasses.asdict(jl[key]), key
    assert pl["unet_config"].attention_head_dim == (4, 2)
    assert pl["schedule_config"].prediction_type == "v_prediction"
    assert default_resolution(pl["unet_config"], pl["vae_config"]) == 16
    for name in ("unet", "vae", "text"):
        for k, v in world["sds"][name].items():
            torch.testing.assert_close(pl[name][k], v, msg=k)


def test_cli_chain_on_the_sd2_base(world, sd2_dir, tmp_path, monkeypatch):
    """The port's pretraining CLI (2 steps, a checkpoint and an in-loop
    sample at 2), its tuning CLI from that artifact reached by its registry
    name under ``$E4T_MODELS_DIR``, and its inference CLI from the tuned
    artifact, also by name: every size defaults from the UNet's
    sample_size (16 px here), and each artifact loads strictly in the JAX
    package to the tensors the port wrote."""
    root, sd = sd2_dir
    pre_out = tmp_path / "pre"
    pre = pretrain_e4t.main([
        "--pretrained_model_name_or_path", sd,
        "--train_image_dataset", str(root / "data"),
        "--domain_class_token", "face",
        "--prompt_template", "a photo of {placeholder_token}",
        "--train_batch_size", "2", "--max_train_steps", "2",
        "--checkpointing_steps", "2", "--log_steps", "1",
        "--n_save_sample", "1",
        "--save_inference_steps", "2", "--save_sample_prompt",
        "a photo of *s", "--report_to", "tensorboard", "--output_dir",
        str(pre_out), "--vit_config", "tiny", "--seed", "0",
        "--device", "cpu"])
    assert pre["global_step"] == 2 and pre["sampled"] == [1, 2]
    assert pre["last_samples"].shape == (1, 3, 16, 16)
    assert all(np.isfinite(m["loss"]) for m in pre["metrics"])
    run = pre_out / "2"
    assert jax_load_config(str(run)).resolution == 16

    mirror = tmp_path / "mirror_pre"
    shutil.copytree(run, mirror / REGISTRY_NAME)
    monkeypatch.setenv(hub.MIRROR_ENV, str(mirror))
    tuning_e4t.main([
        "--pretrained_model_name_or_path", REGISTRY_NAME,
        "--train_image_path", str(root / "in.png"),
        "--prompt_template", "a photo of {placeholder_token}",
        "--train_batch_size", "2", "--max_train_steps", "1",
        "--output_dir", str(tmp_path / "tune"), "--seed", "0",
        "--device", "cpu"])
    tuned = tmp_path / "tune" / "1"
    assert Image.open(tuned / "domain.png").size == (16, 16)
    with open(tuned / "config.json", encoding="utf-8") as f:
        config = json.load(f)
    assert config["resolution"] == 16
    assert config["pretrained_model_name_or_path"] == str(
        mirror / REGISTRY_NAME)

    mirror = tmp_path / "mirror_tuned"
    shutil.copytree(tuned, mirror / REGISTRY_NAME)
    monkeypatch.setenv(hub.MIRROR_ENV, str(mirror))
    inference.main([
        "--pretrained_model_name_or_path", REGISTRY_NAME,
        "--image_path_or_url", str(root / "in.png"),
        "--prompt", "::".join(PROMPTS), "--num_inference_steps", "2",
        "--guidance_scale", "2.0", "--seed", "1", "--device", "cpu",
        "--scheduler_type", "dpm_solver++",
        "--output", str(tmp_path / "grid.png")])
    assert Image.open(tmp_path / "grid.png").size == (16, 32)

    # both artifacts in the JAX package, strictly, to the same tensors
    base = jax_artifacts.load_sd_base(sd)
    for art, pretrained in ((run, config["pretrained_args"]),
                            (tuned, config["pretrained_args"])):
        enc_cfg = jax_artifacts.e4t_encoder_config_from_args(
            JaxAttributeDict(pretrained),
            word_embedding_dim=base["text_config"].hidden_size,
            unet_config=base["unet_config"])
        loaded = jax_artifacts.load_e4t_weights(str(art), base, enc_cfg)
        offsets = convert.offsets_from_jax(_np(loaded["offsets"]))
        saved = (torch.load(art / "weight_offsets.pt") if art == run else
                 {k: v for k, v in torch.load(art / "unet.pt").items()
                  if ".wo_" in k})
        assert set(offsets) == set(saved)
        assert all(torch.equal(offsets[k], saved[k]) for k in saved)
        enc = convert.e4t_encoder_from_jax(_np(loaded["e4t"]),
                                           enc_cfg.vit.num_layers)
        saved = torch.load(art / "encoder.pt")
        assert set(enc) == set(saved)
        assert all(torch.equal(enc[k], saved[k]) for k in saved)
        if art == tuned:
            unet = convert.unet_from_jax(_np(loaded["unet"]))
            saved = torch.load(art / "unet.pt")
            assert all(torch.equal(unet[k], saved[k]) for k in unet)


def test_jax_artifact_loads_into_the_port(world, sd2_dir, tmp_path):
    """A tuned artifact the JAX package writes on the SD2 base (the whole
    UNet with its offsets, the encoder and the text tower) loads strictly
    into the port's modules to the world's tensors, and samples."""
    root, sd = sd2_dir
    jm, params = world["jm"], _np(world["params"])
    config = {"pretrained_args": dict(
        E4T_CONFIG, pretrained_model_name_or_path=sd, vit_config="tiny")}
    out = jax_artifacts.save_e4t_weights(
        str(tmp_path), 7, config, params["e4t"], jm.e4t_encoder.config,
        offsets=params["offsets"], unet_params=params["unet"],
        text_params=params["text"],
        text_num_layers=jm.text_encoder.config.num_layers)
    base = artifacts.load_sd_base(sd)
    loaded = artifacts.load_e4t_weights(out, base)
    _, port_cfgs = _sd2_configs()
    modules = E4TModules.create(base["unet_config"], base["vae_config"],
                                base["text_config"], port_cfgs[2],
                                dtype=torch.float32, device="cpu")
    modules.load_state_dicts({k: loaded[k]
                              for k in ("unet", "vae", "text", "e4t")})
    wo.check_bank(loaded["offsets"], base["unet_config"])
    for name in ("unet", "text", "e4t", "offsets"):
        for k, v in world["sds"][name].items():
            torch.testing.assert_close(loaded[name][k], v, msg=k)
    inference.main([
        "--pretrained_model_name_or_path", out, "--image_path_or_url",
        str(root / "in.png"), "--num_inference_steps", "2",
        "--device", "cpu", "--output", str(tmp_path / "grid.png")])
    assert Image.open(tmp_path / "grid.png").size == (16, 16)


# the LoRA fold against the JAX package's on the same numpy weights (the
# tolerance of tests/test_torch_lora.py) and its scale
LORA_FOLD_TOL = 1e-6
LORA_SCALE = 0.7


def test_serve_every_flag_on_the_sd2_base(world, sd2_dir, tmp_path):
    """The batch server on the SD2 base with ``--int8 --int8_pc_act
    --int8_aux_static --lora_weights`` (a seeded LoRA file whose k/v
    adapters take the tiny SD2 cross width): three prompts at batch 2, the
    first batch calibrating. The LoRA fold's UNet weights (offsets folded
    first) against the JAX package's ``fold_lora_bank`` of the same numpy
    weights, as plain functions; the served PNGs against the served
    pipeline called directly on each batch, within one level of 255."""
    from e4t_diffusion_tpu.models import lora as jax_lora

    from e4t_diffusion_torch import serve_e4t
    from e4t_diffusion_torch.diffusion.pipeline import _folded_apply

    root, sd = sd2_dir
    jm, params = world["jm"], _np(world["params"])
    art = jax_artifacts.save_e4t_weights(
        str(tmp_path / "art"), 1, {"pretrained_args": dict(
            E4T_CONFIG, pretrained_model_name_or_path=sd,
            vit_config="tiny")},
        params["e4t"], jm.e4t_encoder.config, offsets=params["offsets"])
    rng = np.random.default_rng(19)
    bank = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        jax.eval_shape(functools.partial(
            jax_lora.init_lora_bank, unet_config=jm.unet.config, rank=2),
            jax.random.PRNGKey(0)))
    lora_file = tmp_path / "pytorch_lora_weights.bin"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in jax_lora.lora_to_torch(bank).items()}, lora_file)
    prompts = [PROMPTS[0], PROMPTS[1], "a photo of the *s"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n",
                                          encoding="utf-8")
    out = tmp_path / "served"
    pipe, record = serve_e4t.main([
        "--pretrained_model_name_or_path", art,
        "--image_path", str(root / "in.png"),
        "--prompts_file", str(tmp_path / "prompts.txt"), "--batch_size",
        "2", "--num_inference_steps", "2", "--guidance_scale", "2.0",
        "--seed", "3", "--device", "cpu", "--output_dir", str(out),
        "--int8", "--int8_pc_act", "--int8_aux_static",
        "--lora_weights", str(lora_file), "--lora_scale", str(LORA_SCALE)])
    assert (pipe.int8, pipe.int8_aux) == ("static_pc", "static")
    assert record["images"] == 3 and len(record["batch_walls_s"]) == 2
    assert any("amax_c" in site for site in pipe.act_amax.values())
    # the cross-attention adapters' k/v take the text width
    cross = jm.unet.config.cross_attention_dim
    assert cross == jm.text_encoder.config.hidden_size
    assert {layers[k]["down"].shape[1] for site, layers in
            pipe.lora_bank.items() if site.endswith("attn2")
            for k in ("to_k_lora", "to_v_lora")} == {cross}

    want = jax_convert.unet_to_torch(_np(jax_lora.fold_lora_bank(
        jax_wo.fold_offset_bank(params["unet"], params["offsets"]), bank,
        LORA_SCALE)))
    folded, _ = _folded_apply(pipe.modules.unet, pipe.offsets,
                              pipe.lora_bank, pipe.lora_scale)
    lora_names = {f"{site}.{proj}.weight" for site in pipe.lora_bank
                  for proj in ("to_q", "to_k", "to_v", "to_out.0")}
    assert len(lora_names) == 4 * len(bank)
    assert lora_names <= set(folded)
    for name in lora_names:
        np.testing.assert_allclose(folded[name].numpy(),
                                   np.asarray(want[name]),
                                   atol=LORA_FOLD_TOL, rtol=0, err_msg=name)

    image = Image.open(root / "in.png").convert("RGB")
    for start in (0, 2):
        batch = prompts[start:start + 2]
        batch += [batch[-1]] * (2 - len(batch))
        alone = pipe(batch, image, num_inference_steps=2,
                     guidance_scale=2.0, seed=3 + start, output_type="pil")
        for i in range(min(2, len(prompts) - start)):
            served = np.asarray(Image.open(out / f"{start + i:05d}.png"))
            assert served.shape == (16, 16, 3)
            diff = np.abs(served.astype(np.int16)
                          - np.asarray(alone[i]).astype(np.int16))
            assert diff.max() <= 1, (start, i)


def test_sd2_widths_round_trip_both_ways(tmp_path):
    """SD 2.x's depths and widths where the converters and artifacts key
    them: a 23-layer text tower and an encoder writing a 1024-wide word
    embedding (narrow elsewhere, so the test stays small) go through the
    port's ``save_e4t_weights`` into the JAX package's loader strictly, and
    the JAX package's writer into the port's modules."""
    tcfg = dataclasses.replace(JaxText.tiny(), num_layers=23,
                               hidden_act="gelu")
    ecfg = JaxEncoderConfig.tiny(word_embedding_dim=1024)
    jm = JaxModules.create(JaxUNetConfig.tiny(), JaxVAEConfig.tiny(), tcfg,
                           ecfg)
    shapes = _shapes(jm, tcfg.max_position_embeddings)
    rng = np.random.default_rng(23)
    params = _np({k: _fill(shapes[k], rng) for k in ("text", "e4t")})
    port_t = CLIPTextConfig(**dataclasses.asdict(tcfg))
    port_e = E4TEncoderConfig.tiny(word_embedding_dim=1024)
    modules = E4TModules.create(UNetConfig.tiny(), VAEConfig.tiny(), port_t,
                                port_e, dtype=torch.float32, device="cpu")
    text_sd = convert.clip_text_from_jax(params["text"], 23)
    enc_sd = convert.e4t_encoder_from_jax(params["e4t"],
                                          ecfg.vit.num_layers)
    modules.text_encoder.load_state_dict(text_sd, strict=True)
    modules.e4t_encoder.load_state_dict(enc_sd, strict=True)
    assert modules.e4t_encoder.final_linear.weight.shape[0] == 1024
    assert len(modules.text_encoder.text_model.encoder.layers) == 23
    bank = wo.init_offset_bank(modules.unet.config,
                               torch.Generator().manual_seed(0))
    out = artifacts.save_e4t_weights(
        str(tmp_path / "port"), 1, {"vit_config": "tiny"},
        modules.e4t_encoder.state_dict(), None, bank,
        text_state=modules.text_encoder.state_dict())
    base = {"unet_config": jm.unet.config, "text_config": tcfg}
    loaded = jax_artifacts.load_e4t_weights(out, base, ecfg)
    jax_leaves = jax.tree_util.tree_leaves(
        {"text": params["text"], "e4t": params["e4t"]})
    got_leaves = jax.tree_util.tree_leaves(
        {"text": loaded["text"], "e4t": loaded["e4t"]})
    assert len(jax_leaves) == len(got_leaves)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax_leaves, got_leaves))
    want = jax_convert.clip_text_to_torch(params["text"], 23)
    assert set(want) == set(text_sd)
    assert all(np.array_equal(np.asarray(want[k]), text_sd[k].numpy())
               for k in text_sd)

    jout = jax_artifacts.save_e4t_weights(
        str(tmp_path / "jax"), 1, {"vit_config": "tiny"}, params["e4t"],
        ecfg, offsets=jax_wo.init_offset_bank(jax.random.PRNGKey(0),
                                              jm.unet.config),
        text_params=params["text"], text_num_layers=23)
    ploaded = artifacts.load_e4t_weights(jout, {})
    fresh = E4TModules.create(UNetConfig.tiny(), VAEConfig.tiny(), port_t,
                              port_e, dtype=torch.float32, device="cpu")
    fresh.text_encoder.load_state_dict(ploaded["text"], strict=True)
    fresh.e4t_encoder.load_state_dict(ploaded["e4t"], strict=True)
    for k, v in text_sd.items():
        torch.testing.assert_close(ploaded["text"][k], v, msg=k)
    for k, v in modules.e4t_encoder.state_dict().items():
        torch.testing.assert_close(fresh.e4t_encoder.state_dict()[k], v,
                                   msg=k)


# ---------------------------------------------------------------------------
# utils/hub.py
# ---------------------------------------------------------------------------

def test_hub_resolves_as_jax(tmp_path, monkeypatch):
    """The registry and ``resolve_model_dir`` as the JAX package's (and
    ``tests/test_utils_misc.py``): a local path as given, a registry name
    against ``$E4T_MODELS_DIR``, an unknown name refused; without a mirror
    and without ``huggingface_hub`` the download raises JAX's staging
    message (no network is tried)."""
    assert hub.MODELS == jax_hub.MODELS and hub.FILES == jax_hub.FILES
    p = tmp_path / "model"
    os.makedirs(p)
    for h in (hub, jax_hub):
        assert h.resolve_model_dir(str(p)) == str(p)
    mirror = tmp_path / "mirror"
    os.makedirs(mirror / REGISTRY_NAME)
    monkeypatch.setenv("E4T_MODELS_DIR", str(mirror))
    out = hub.resolve_model_dir(REGISTRY_NAME)
    assert out == jax_hub.resolve_model_dir(REGISTRY_NAME)
    assert out.endswith(REGISTRY_NAME)
    for h in (hub, jax_hub):
        with pytest.raises(AssertionError):
            h.resolve_model_dir("not-a-model")
    monkeypatch.setenv("E4T_MODELS_DIR", str(tmp_path / "empty"))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    messages = []
    for h in (hub, jax_hub):
        with pytest.raises(RuntimeError) as err:
            h.resolve_model_dir(REGISTRY_NAME)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "E4T_MODELS_DIR" in messages[0]


# ---------------------------------------------------------------------------
# the text tower at SD 2.x's depth, and the tokenizer's padding
# ---------------------------------------------------------------------------

def test_text_tower_at_sd2_depth_matches_jax():
    """A 23-layer gelu text tower (SD 2.x's depth, narrow): the placeholder
    row added by ``resize_token_embeddings``, the domain embedding written
    into the placeholder slot of ``inputs_embeds``, and both outputs
    against the JAX tower on the same weights, rel-L2 <= 1e-5."""
    from e4t_diffusion_tpu.models.clip_text import (
        CLIPTextModel as JaxTextModel)

    from e4t_diffusion_torch.models.clip_text import CLIPTextModel

    tcfg = dataclasses.replace(JaxText.tiny(), num_layers=23,
                               hidden_act="gelu", max_position_embeddings=77)
    jm = JaxTextModel(tcfg)
    rng = np.random.default_rng(11)
    params = _np(_fill(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 77), jnp.int32))["params"], rng))
    model = CLIPTextModel(CLIPTextConfig(**dataclasses.asdict(tcfg))).eval()
    model.load_state_dict(convert.clip_text_from_jax(params, 23),
                          strict=True)
    model.resize_token_embeddings(tcfg.vocab_size + 1,
                                  torch.Generator().manual_seed(0))
    table = model.text_model.embeddings.token_embedding.weight.detach()
    params["token_embedding"] = table.numpy()
    ids = rng.integers(0, tcfg.vocab_size + 1, (2, 77))
    ids[:, 3] = tcfg.vocab_size  # the placeholder's row
    word = rng.standard_normal((2, tcfg.hidden_size)).astype(np.float32)
    embeds = table.numpy()[ids]
    embeds[:, 3] = word
    grown = JaxTextModel(dataclasses.replace(
        tcfg, vocab_size=tcfg.vocab_size + 1))
    want = grown.apply({"params": params},
                       inputs_embeds=jnp.asarray(embeds))
    with torch.no_grad():
        got = model(inputs_embeds=torch.from_numpy(embeds))
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= LATENTS_REL_L2


def test_tokenizer_pads_with_end_of_text_as_jax(world):
    """The port's tokenizer on the SD2 world's files, the placeholder
    added: the prompt's ids, padded to 77 with the end-of-text id as the
    JAX tokenizer pads (SD2's own pads with "!"), and the class token."""
    from e4t_diffusion_torch.training.setup import resolve_class_token

    port = CLIPTokenizer.from_pretrained(world["tok_dir"])
    jax_tok = JaxTokenizer.from_pretrained(world["tok_dir"])
    assert port.add_tokens("*s") == jax_tok.add_tokens("*s") == 1
    for prompt in PROMPTS + [""]:
        ids = port(prompt, padding="max_length", truncation=True,
                   max_length=77)["input_ids"][0]
        assert ids == jax_tok(prompt, padding="max_length", truncation=True,
                              max_length=77)["input_ids"][0]
        end = ids.index(port.eos_token_id)
        assert set(ids[end:]) == {port.eos_token_id}
    assert resolve_class_token(port, "face") == jax_tok(
        "face", add_special_tokens=False, padding=None)["input_ids"][0][0]


def test_chip_smoke_sd2_launches():
    """``chip_smoke.py``'s derivation of the SD 2.1 path's launches from the
    port's own routes at 768px: a batch-8 CFG sampling run sends the 5
    self-attention sites at each of 96², 48² and 24² to the low-dim kernel
    twice a step (cross-attention, the 144-token mid block and the ViT-H
    stay on einsum); an all-flash training step at batch 16 runs every
    UNet site, the mid block's included, and the ViT-H's 32 layers: 124
    forward and 46 backward launches, 7 backward at each level-0 shape."""
    import chip_smoke

    from e4t_diffusion_torch.models.vit import ViTConfig

    ucfg, vit = UNetConfig.sd2(), ViTConfig.vit_h_14()
    assert chip_smoke._expected_sampling_launches(
        ucfg, vit, 8, 768, 4) == chip_smoke._want(flash_fwd_lowdim=120)
    assert chip_smoke._expected_tuning_launches(ucfg, vit, 768) == \
        chip_smoke._want(flash_fwd_lowdim=124, flash_bwd=46)
    shapes = chip_smoke._sd2_step_shapes(ucfg, vit, 16, 768)
    assert sum(f for f, _ in shapes.values()) == 124
    assert sum(b for _, b in shapes.values()) == 46
    assert shapes["80x9216x9216x64"] == shapes["80x9216x77x64"] == [14, 7]
    assert shapes["320x144x144x64"] == [4, 2]
    assert shapes["256x257x257x80"] == [32, 0]
