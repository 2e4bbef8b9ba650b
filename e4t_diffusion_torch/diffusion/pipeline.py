"""StableDiffusionE4TPipeline: E4T sampling on PyTorch.

Counterpart of ``e4t_diffusion_tpu/diffusion/pipeline.py`` on its bf16/f32
and int8 paths. Per sampling run: the E4T weight offsets are folded into the
UNet's attention projections once, the ViT-H image branch is encoded once,
and the "" text states are computed once. Per denoise step: the uncond UNet
pass also yields the E4T tap (``return_encoder_outputs="with_eps"``), the
E4T encoder fuses it into the domain embedding, that embedding is written
into the placeholder slot of the prompt embeddings, CLIP text encodes them,
the cond UNet pass runs, then CFG and the scheduler step. The VAE decodes
at the end. With int8 serving the folded UNet weights are quantized once
per run, after the fold (``ops/quant.py``), and the static modes calibrate
their activation ranges once, on the pipeline's first call.

Entry points run on ``cuda`` unless the caller passes another device
(``device="cpu"``); without a GPU and without that request they raise.

Beyond that path: the six schedulers of ``diffusion/schedulers.py``, LoRA
adapters folded after the offsets (``models/lora.py``), the int8 ViT-H and
VAE decode (``int8_aux``, dynamic or calibrated) and per-step trajectories
(``make_trajectory_fn``).

Several ranks (``parallel/mesh.py``): a UNet split over tp
(``mesh.apply_tensor_parallel``) samples as it is; with ``data_parallel``
each dp rank draws the whole batch's initial latents and per-step noise
from the seed, keeps its rows, and the images are gathered, so the ranks
render one card's images. Every rank quantizes int8 sites by the same
scales: a live activation abs-max is the MAX over every rank
(``quant.amax_reduction``), calibrated ranges are MAX-reduced
(``mesh.reduce_calibration``, per-channel ranges gathered to the
unsplit layout), a row-parallel shard's weight scales are the whole
kernel's (``mesh.kernel_scale_reducer``) and its per-channel activation
scales the slice of the whole vector's at its input columns
(``mesh.channel_scale_shard``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from e4t_diffusion_torch.diffusion.schedulers import (
    DDIMScheduler, NoiseScheduleConfig, SCHEDULER_MAPPING)
from e4t_diffusion_torch.models import lora as lora_mod
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from e4t_diffusion_torch.models.e4t_encoder import E4TEncoder, E4TEncoderConfig
from e4t_diffusion_torch.models.unet import (
    UNet2DConditionModel, UNetConfig, pool_encoder_features, tap_feature_dim)
from e4t_diffusion_torch.models.vae import AutoencoderKL, VAEConfig
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.ops.attention import (batch_shards,
                                               int8_flash_attention)
from e4t_diffusion_torch.parallel import mesh as pmesh


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names a device; raises if CUDA is asked
    for and absent, so nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """``auto`` is bf16 on the GPU and f32 on the CPU; ``bf16`` and
    ``fp32`` name their type on either (f32 on the GPU runs the f32
    attention kernels)."""
    if name == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


@dataclasses.dataclass
class E4TModules:
    """The four networks of E4T sampling, weights included."""
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    e4t_encoder: E4TEncoder

    @classmethod
    def create(cls, unet_config: UNetConfig = None,
               vae_config: VAEConfig = None,
               text_config: CLIPTextConfig = None,
               e4t_config: E4TEncoderConfig = None,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device, None] = None
               ) -> "E4TModules":
        """Randomly initialised modules (seed with ``torch.manual_seed``),
        built directly on ``device`` and cast to ``dtype``."""
        dev = resolve_device(device)
        with torch.device(dev):
            mods = cls(
                unet=UNet2DConditionModel(unet_config or UNetConfig()),
                vae=AutoencoderKL(vae_config or VAEConfig()),
                text_encoder=CLIPTextModel(text_config or CLIPTextConfig()),
                e4t_encoder=E4TEncoder(e4t_config or E4TEncoderConfig()),
            )
        for m in mods.all():
            m.to(dtype).eval().requires_grad_(False)
        return mods

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device, None] = None) -> "E4TModules":
        """Matched tiny configs for tests: the UNet tap feeds the encoder."""
        ucfg = UNetConfig.tiny()
        tcfg = CLIPTextConfig.tiny()
        ecfg = E4TEncoderConfig.tiny(word_embedding_dim=tcfg.hidden_size,
                                     unet_feature_dim=tap_feature_dim(ucfg))
        return cls.create(ucfg, VAEConfig.tiny(), tcfg, ecfg, dtype, device)

    def all(self):
        return (self.unet, self.vae, self.text_encoder, self.e4t_encoder)

    def load_state_dicts(self, sds: Dict[str, Dict[str, torch.Tensor]]
                         ) -> None:
        """Strictly load {"unet", "vae", "text", "e4t"} state dicts (any
        subset), each cast to the module's dtype and device."""
        targets = {"unet": self.unet, "vae": self.vae,
                   "text": self.text_encoder, "e4t": self.e4t_encoder}
        for name, sd in sds.items():
            targets[name].load_state_dict(sd, strict=True)


def preprocess_image(image) -> np.ndarray:
    """PIL / uint8 HWC array -> float32 NCHW in [-1, 1]."""
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    arr = arr.astype(np.float32) / 255.0
    return 2.0 * arr.transpose(0, 3, 1, 2) - 1.0


def _step_noise(shape, generator, device, dtype) -> torch.Tensor:
    """A stochastic sampler's per-step standard normal noise, drawn from the
    run's generator."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype)


def _build_denoise_loop(modules: E4TModules, scheduler, num_steps: int,
                        guidance_scale: float, domain_embed_scale: float,
                        eta: float) -> Callable:
    """The one denoise loop of sampling, calibration and trajectories:
    ``run_loop(unet_apply, latents, pixel_values, inputs_embeds,
    placeholder_idx, uncond_ids, class_embed, generator, on_step=None,
    batch_rows=None) -> latents``, where ``unet_apply`` calls the UNet on the
    run's folded weights. The model is evaluated once per entry of the
    scheduler's ``timesteps`` (PNDM: ``num_steps + 1``), its carry comes
    from ``init_carry``, and every step of a stochastic scheduler (and of
    DDIM at eta > 0) takes noise from ``generator``. ``on_step(latents)``
    sees each post-step latent. ``batch_rows`` (first row, whole batch): the
    latents are those rows of a larger batch (data-parallel serving); each
    step's noise is drawn for the whole batch and cut to them."""
    do_cfg = guidance_scale > 1.0
    step_kwargs = ({"eta": eta} if eta > 0.0
                   and isinstance(scheduler, DDIMScheduler) else {})
    stochastic = getattr(scheduler, "stochastic", False) or bool(step_kwargs)
    text, e4t = modules.text_encoder, modules.e4t_encoder

    def run_loop(unet_apply, latents, pixel_values, inputs_embeds,
                 placeholder_idx, uncond_ids, class_embed, generator,
                 on_step=None, batch_rows=None):
        device = latents.device
        state = scheduler.init(num_steps, device)
        if hasattr(scheduler, "init_noise_sigma"):
            latents = latents * scheduler.init_noise_sigma(state)
        if hasattr(scheduler, "init_carry"):
            state = scheduler.init_carry(state, latents.shape, latents.dtype)
        bsz = latents.shape[0]
        uncond_states, _ = text(uncond_ids)
        uncond_b = uncond_states.expand(bsz, -1, -1)
        clip_feats = e4t.encode_image(
            pixel_values.expand(bsz, -1, -1, -1))
        rows = torch.arange(bsz, device=device)
        for i, t in enumerate(state["timesteps"]):
            t_b = t.expand(bsz)
            latents_in = scheduler.scale_model_input(state, i, latents)
            if do_cfg:
                eps_u, tap = unet_apply(latents_in, t_b, uncond_b,
                                        return_encoder_outputs="with_eps")
            else:  # the tap pass exits after the mid block
                tap = unet_apply(latents_in, t_b, uncond_b,
                                 return_encoder_outputs=True)
            domain_embed = e4t.fuse(clip_feats, pool_encoder_features(tap))
            word = class_embed[None] + domain_embed_scale * domain_embed
            embeds = inputs_embeds.expand(bsz, -1, -1).clone()
            embeds[rows, placeholder_idx] = word.to(embeds.dtype)
            cond_states, _ = text(inputs_embeds=embeds)
            eps_c = unet_apply(latents_in, t_b,
                               cond_states.to(uncond_b.dtype))
            eps = eps_u + guidance_scale * (eps_c - eps_u) if do_cfg else eps_c
            noise = None
            if stochastic:
                row0, whole = batch_rows or (0, bsz)
                noise = _step_noise((whole,) + tuple(latents.shape[1:]),
                                    generator, device,
                                    latents.dtype)[row0:row0 + bsz]
            state, latents = scheduler.step(state, i, eps, latents,
                                            noise=noise, **step_kwargs)
            if on_step is not None:
                on_step(latents)
        return latents

    return run_loop


INT8_MODES = (False, True, "static", "static_pc")
INT8_AUX_MODES = (False, True, "static")
INT8_ATTN_MODES = (False, True, "qk", "qkpv")


def _static_exclude_for(act_pc: bool) -> Optional[tuple]:
    """Which UNet sites keep dynamic activation scales under static-act
    int8: ``quant.UNET_STATIC_EXCLUDE`` in every regime (the JAX package's
    measured serving default), none under the per-channel flavor (which
    serves every site on its static scale), and ``None`` (so
    ``quantize_params`` reads it) when ``E4T_INT8_STATIC_EXCLUDE`` is set."""
    if "E4T_INT8_STATIC_EXCLUDE" in os.environ:
        return None
    return () if act_pc else quant.UNET_STATIC_EXCLUDE


def _serving_int8_mode(int8: Union[bool, str]) -> Union[bool, str]:
    """The static-int8 flavor a pipeline serves: ``int8="static"`` becomes
    ``"static_pc"`` or stays ``"static"`` as ``E4T_INT8_ACT_PC`` says, when
    that is set; every other mode is served as given."""
    if int8 == "static" and "E4T_INT8_ACT_PC" in os.environ:
        return "static_pc" if quant.env_truthy("E4T_INT8_ACT_PC") else "static"
    return int8


def _check_modes(int8, int8_aux, int8_attn) -> None:
    for name, value, modes in (("int8", int8, INT8_MODES),
                               ("int8_aux", int8_aux, INT8_AUX_MODES),
                               ("int8_attn", int8_attn, INT8_ATTN_MODES)):
        if value not in modes:
            raise ValueError(f"{name}={value!r}: one of {modes}")


def _check_extra(what: str, wanted: bool, given) -> None:
    if wanted != (given is not None):
        raise ValueError(f"{what} is {'required' if wanted else 'not taken'}"
                         f" by this function's flags")


def _folded_apply(unet, offsets, lora_bank=None, lora_scale=None):
    """The run's effective UNet weights: the offsets folded in, then the
    LoRA adapters (both in f32, cast once to each weight's type; each cut
    to this rank's shard on a UNet split over tp), and a ``unet_apply``
    that calls the UNet on them."""
    if lora_bank is None:
        folded = wo.fold_offset_bank(unet, offsets)
    else:
        params = dict(unet.named_parameters())
        folded = wo.fold_offset_bank(unet, offsets, dtype=torch.float32)
        folded.update(lora_mod.fold_lora_bank({**params, **folded},
                                              lora_bank, lora_scale, unet))
        folded = {k: v.to(params[k].dtype) for k, v in folded.items()}

    def unet_apply(*args, **kwargs):
        return torch.func.functional_call(unet, folded, args, kwargs)

    return folded, unet_apply


def _unet_sites(unet, folded, int8, act_amax):
    """The int8 sites of the folded UNet weights (none when ``int8`` is
    off); on a UNet split over tp a row-parallel shard takes the whole
    kernel's scales and its input columns' slice of the per-channel
    activation scales."""
    if not int8:
        return {}
    return quant.quantize_params(
        {**dict(unet.named_parameters()), **folded}, act_amax=act_amax,
        act_pc=int8 == "static_pc",
        static_exclude=_static_exclude_for(int8 == "static_pc"),
        kernel_reduce=pmesh.kernel_scale_reducer(unet),
        act_shard=pmesh.channel_scale_shard(unet))


def _parallel_contexts(stack: contextlib.ExitStack, mesh, rows) -> None:
    """A sampling run's parallel contexts: the routes count the whole
    batch where the rows are split over dp, and every live int8 activation
    abs-max is the MAX over every rank."""
    if mesh is None or not mesh.distributed:
        return
    if rows is not None:
        stack.enter_context(batch_shards(mesh.dp))

    def world_max(amax):
        amax = amax.reshape(1).clone()
        return mesh.all_reduce(amax, torch.distributed.ReduceOp.MAX)[0]

    stack.enter_context(quant.amax_reduction(world_max))


def _aux_sites(modules: E4TModules, aux_amax) -> list:
    """[(tower, its int8 sites)] of the auxiliary towers, as the JAX
    package quantizes them: the ViT-H with the default exclusions (so its
    patch conv ``conv1`` is int8), the VAE with ``DEFAULT_EXCLUDE`` plus the
    encoder and ``quant_conv`` (its decoder's ``conv_in`` / ``conv_out``
    stay in the compute type, ``post_quant_conv`` is int8). ``aux_amax``
    ({"e4t", "vae"} from ``make_aux_calibration_fn``) gives static scales."""
    aux = aux_amax or {}
    vit = modules.e4t_encoder.clip_vision
    vae = modules.vae
    return [
        (vit, quant.quantize_params(dict(vit.named_parameters()),
                                    act_amax=aux.get("e4t"),
                                    path_of=quant.vit_path)),
        (vae, quant.quantize_params(
            dict(vae.named_parameters()), act_amax=aux.get("vae"),
            exclude=quant.DEFAULT_EXCLUDE + ("encoder", "quant_conv"),
            path_of=quant.vae_path)),
    ]


def make_sample_fn(modules: E4TModules, scheduler, num_inference_steps: int,
                   guidance_scale: float, domain_embed_scale: float,
                   return_latents: bool = False, eta: float = 0.0,
                   int8: Union[bool, str] = False,
                   int8_aux: Union[bool, str] = False,
                   int8_attn: Union[bool, str] = False,
                   lora_scale: Optional[float] = None,
                   mesh: Optional[pmesh.Mesh] = None,
                   rows: Optional[tuple] = None) -> Callable:
    """The end-to-end sampling function ``sample(offsets, latents,
    pixel_values, inputs_embeds, placeholder_idx, uncond_ids, class_embed,
    generator=None, act_amax=None, aux_amax=None, lora_bank=None)`` ->
    images in [0, 1] (or the final latents) of its rows.

    ``offsets``: the weight-offset bank; ``latents`` (B, 4, h, w) f32;
    ``pixel_values`` (1, 3, H, W) in [-1, 1]; ``inputs_embeds`` (1 or B, L,
    D) raw prompt token embeddings; ``placeholder_idx`` (B,) positions;
    ``uncond_ids`` (1, L) ids of ""; ``class_embed`` (D,) the domain class
    token's embedding; ``generator`` draws the per-step noise of the
    stochastic schedulers (Euler-ancestral, DDIM at eta > 0).

    ``int8``: quantize the offset-folded UNet weights once per run
    (``ops/quant.py``) and serve the UNet's linear and conv sites in int8,
    with dynamic activation scales (True), calibrated static ones
    (``"static"``, with ``quant.UNET_STATIC_EXCLUDE`` kept dynamic) or
    calibrated per-channel static ones (``"static_pc"``); the static modes
    take ``act_amax`` from ``make_calibration_fn`` or
    ``quant.load_act_scales``.
    ``int8_aux``: also quantize the once-per-run towers, the ViT-H and the
    VAE decode path (``_aux_sites``), once per run, with dynamic activation
    scales (True) or static ones (``"static"``: ``aux_amax`` from
    ``make_aux_calibration_fn``); independent of ``int8``.
    ``int8_attn``: run the low-head-dim flash sites on the int8 attention
    kernel (True or "qk": int8 QK^T; "qkpv": P@V too).
    ``lora_scale``: when set, ``lora_bank`` (``models/lora.py``) is folded
    into the effective weights after the offsets and before int8
    quantization.
    ``mesh``: the (dp, tp) grid of a run over several ranks; ``rows``
    (first row, whole batch): the latents are those rows of the batch
    (data-parallel serving), as in ``_build_denoise_loop``."""
    _check_modes(int8, int8_aux, int8_attn)
    static_act = int8 in ("static", "static_pc")
    attn_mode = "qk" if int8_attn is True else int8_attn
    run_loop = _build_denoise_loop(modules, scheduler, num_inference_steps,
                                   guidance_scale, domain_embed_scale, eta)
    unet = modules.unet

    @torch.inference_mode()
    def sample(offsets, latents, pixel_values, inputs_embeds,
               placeholder_idx, uncond_ids, class_embed, generator=None,
               act_amax=None, aux_amax=None, lora_bank=None):
        _check_extra("act_amax", static_act, act_amax)
        _check_extra("aux_amax", int8_aux == "static", aux_amax)
        _check_extra("lora_bank", lora_scale is not None, lora_bank)
        folded, unet_apply = _folded_apply(unet, offsets, lora_bank,
                                           lora_scale)
        # quantized once per run, outside the step loop
        sites = [(unet, _unet_sites(unet, folded, int8, act_amax))]
        if int8_aux:
            sites += _aux_sites(modules, aux_amax)
        with contextlib.ExitStack() as stack:
            _parallel_contexts(stack, mesh, rows)
            for model, model_sites in sites:
                stack.enter_context(quant.int8_sites(model, model_sites))
            if attn_mode:
                stack.enter_context(int8_flash_attention(attn_mode))
            latents = run_loop(unet_apply, latents, pixel_values,
                               inputs_embeds, placeholder_idx, uncond_ids,
                               class_embed, generator, batch_rows=rows)
            if return_latents:
                return latents
            images = modules.vae.decode(
                latents / modules.vae.config.scaling_factor)
        return (images / 2.0 + 0.5).clamp(0.0, 1.0)

    return sample


def make_calibration_fn(modules: E4TModules, scheduler, num_calib_steps: int,
                        guidance_scale: float, domain_embed_scale: float,
                        eta: float = 0.0, lora_scale: Optional[float] = None,
                        return_final_latents: bool = False,
                        mesh: Optional[pmesh.Mesh] = None,
                        rows: Optional[tuple] = None) -> Callable:
    """Activation-range calibration for static-act int8 serving: a
    ``num_calib_steps`` sampling run in the compute type through the same
    loop as ``make_sample_fn``, recording every UNet site's abs-max
    (``quant.calibration``: the running max over both CFG passes, or the
    tap and cond passes without CFG, and every step). Returns
    ``calibrate(offsets, latents, pixel_values, inputs_embeds,
    placeholder_idx, uncond_ids, class_embed, generator=None,
    lora_bank=None)`` -> the ``act_amax`` of an ``int8="static"`` sample
    function, or ``(act_amax, final latents)`` with
    ``return_final_latents`` (the representative VAE-decode inputs of
    ``make_aux_calibration_fn``). With ``lora_scale`` it calibrates on the
    weights serving uses, the LoRA bank folded in. ``mesh`` and ``rows`` as
    in ``make_sample_fn``: the ranges are then MAX-reduced over the ranks
    (``mesh.reduce_calibration``)."""
    run_loop = _build_denoise_loop(modules, scheduler, num_calib_steps,
                                   guidance_scale, domain_embed_scale, eta)
    unet = modules.unet

    @torch.inference_mode()
    def calibrate(offsets, latents, pixel_values, inputs_embeds,
                  placeholder_idx, uncond_ids, class_embed, generator=None,
                  lora_bank=None):
        _check_extra("lora_bank", lora_scale is not None, lora_bank)
        _, unet_apply = _folded_apply(unet, offsets, lora_bank, lora_scale)
        with contextlib.ExitStack() as stack:
            _parallel_contexts(stack, mesh, rows)
            amax = stack.enter_context(quant.calibration(unet))
            final = run_loop(unet_apply, latents, pixel_values,
                             inputs_embeds, placeholder_idx, uncond_ids,
                             class_embed, generator, batch_rows=rows)
        pmesh.reduce_calibration(amax, unet, mesh or pmesh.Mesh())
        return (amax, final) if return_final_latents else amax

    return calibrate


def make_aux_calibration_fn(modules: E4TModules) -> Callable:
    """Activation-range calibration of the auxiliary towers
    (``int8_aux="static"``): one ViT-H encode and one VAE decode with every
    site's abs-max recorded. Returns ``calibrate(pixel_values, latents)`` ->
    ``{"e4t": the ViT tower's ranges, "vae": the VAE's}``, the ``aux_amax``
    of ``make_sample_fn``; ``latents`` are representative decode inputs
    (unscaled, as the denoise loop ends)."""
    vit, vae = modules.e4t_encoder.clip_vision, modules.vae

    @torch.inference_mode()
    def calibrate(pixel_values, latents):
        with quant.calibration(vit) as vit_amax:
            modules.e4t_encoder.encode_image(pixel_values)
        with quant.calibration(vae) as vae_amax:
            vae.decode(latents / vae.config.scaling_factor)
        return {"e4t": vit_amax, "vae": vae_amax}

    return calibrate


def make_trajectory_fn(modules: E4TModules, scheduler,
                       num_inference_steps: int, guidance_scale: float,
                       domain_embed_scale: float, eta: float = 0.0,
                       int8: Union[bool, str] = False,
                       int8_attn: Union[bool, str] = False) -> Callable:
    """Per-step latent capture through the same loop as ``make_sample_fn``:
    ``trajectory(offsets, latents, pixel_values, inputs_embeds,
    placeholder_idx, uncond_ids, class_embed, generator=None,
    act_amax=None)`` -> every post-step latent stacked, (n_evals, B, 4, h,
    w) (PNDM: ``num_inference_steps + 1``). ``int8`` and ``int8_attn`` as
    in ``make_sample_fn`` (the static modes take ``act_amax``): the record
    behind the int8-against-bf16 divergence study."""
    _check_modes(int8, False, int8_attn)
    static_act = int8 in ("static", "static_pc")
    attn_mode = "qk" if int8_attn is True else int8_attn
    run_loop = _build_denoise_loop(modules, scheduler, num_inference_steps,
                                   guidance_scale, domain_embed_scale, eta)
    unet = modules.unet

    @torch.inference_mode()
    def trajectory(offsets, latents, pixel_values, inputs_embeds,
                   placeholder_idx, uncond_ids, class_embed, generator=None,
                   act_amax=None):
        _check_extra("act_amax", static_act, act_amax)
        folded, unet_apply = _folded_apply(unet, offsets)
        steps = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(quant.int8_sites(
                unet, _unet_sites(unet, folded, int8, act_amax)))
            if attn_mode:
                stack.enter_context(int8_flash_attention(attn_mode))
            run_loop(unet_apply, latents, pixel_values, inputs_embeds,
                     placeholder_idx, uncond_ids, class_embed, generator,
                     on_step=steps.append)
        return torch.stack(steps)

    return trajectory


class StableDiffusionE4TPipeline:
    """Host-side orchestration: tokenize, seed, call the sampler.

    Registers the placeholder token (unless already added), resolves the
    domain-class token's id and takes domain_embed_scale from the E4T
    config. ``offsets`` is the weight-offset bank for ``modules.unet``.

    int8 serving (``make_sample_fn``): ``int8`` False | True (dynamic
    activation scales) | "static" | "static_pc" (calibrated activation
    ranges: ``act_scales`` from ``quant.load_act_scales``, or a calibration
    run of ``E4T_INT8_CALIB_STEPS`` steps (default 8) on the first call,
    kept in ``act_amax`` and reused by every later call); ``int8_aux``
    False | True | "static" (the ViT-H and VAE decode in int8; "static"
    calibrates their ranges once, on the first call, from the UNet
    calibration's final latents where ``int8`` is static, and keeps them
    in ``aux_amax``); ``int8_attn`` False | True ("qk") | "qkpv".
    ``lora_bank`` (``models/lora.py``) is folded into every run's weights
    at ``lora_scale``.

    ``mesh`` (``parallel/mesh.get_mesh``): the (dp, tp) grid of a run over
    several ranks, its UNet split over tp by ``mesh.apply_tensor_parallel``
    beforehand; ``data_parallel``: each dp rank samples its rows of the
    batch (which dp must divide) and every rank gets the whole batch's
    images."""

    def __init__(self, modules: E4TModules, offsets: Dict[str, torch.Tensor],
                 tokenizer, e4t_config, scheduler=None,
                 already_added_placeholder_token: bool = False,
                 int8: Union[bool, str] = False,
                 int8_attn: Union[bool, str] = False, act_scales=None,
                 int8_aux: Union[bool, str] = False, lora_bank=None,
                 lora_scale: float = 1.0,
                 mesh: Optional[pmesh.Mesh] = None,
                 data_parallel: bool = False):
        _check_modes(int8, int8_aux, int8_attn)
        self.mesh = mesh or pmesh.Mesh()
        self.data_parallel = data_parallel
        self.int8, self.int8_aux, self.int8_attn = int8, int8_aux, int8_attn
        self.act_amax = act_scales
        self.aux_amax = None
        self.lora_bank = lora_bank
        self.lora_scale = lora_scale if lora_bank is not None else None
        self.modules = modules
        self.device = modules.unet.conv_in.weight.device
        wo.check_bank(offsets, modules.unet.config)
        self.offsets = {k: v.to(self.device) for k, v in offsets.items()}
        self.tokenizer = tokenizer
        self.e4t_config = e4t_config
        self.scheduler = scheduler or DDIMScheduler(NoiseScheduleConfig())
        if not already_added_placeholder_token:
            if tokenizer.add_tokens(e4t_config.placeholder_token) == 0:
                raise ValueError(
                    f"The tokenizer already contains the token "
                    f"{e4t_config.placeholder_token}.")
        rows = modules.text_encoder.text_model.embeddings.token_embedding \
            .num_embeddings
        if len(tokenizer) > rows:
            raise ValueError(
                f"the tokenizer has {len(tokenizer)} ids but the text "
                f"encoder {rows} embedding rows; resize its token embeddings")
        self.placeholder_token = e4t_config.placeholder_token
        self.placeholder_token_id = tokenizer.convert_tokens_to_ids(
            e4t_config.placeholder_token)
        class_ids = tokenizer(e4t_config.domain_class_token,
                              add_special_tokens=False,
                              padding=None)["input_ids"][0]
        if len(class_ids) != 1:
            raise ValueError(f"domain_class_token "
                             f"{e4t_config.domain_class_token!r} must be one "
                             f"token (got {len(class_ids)})")
        self.class_token_id = class_ids[0]
        self.domain_embed_scale = e4t_config.domain_embed_scale

    def _prepare_prompt(self, prompt: str):
        tok = self.tokenizer
        input_ids = tok(prompt, padding="max_length", truncation=True,
                        max_length=tok.model_max_length)["input_ids"][0]
        if self.placeholder_token_id not in input_ids:
            raise ValueError(f"Your prompt may not have the placeholder_token="
                             f"{self.placeholder_token}")
        return input_ids, input_ids.index(self.placeholder_token_id)

    def __call__(self, prompt: Union[str, Sequence[str]], image,
                 num_inference_steps: int = 50,
                 guidance_scale: float = 7.5,
                 num_images_per_prompt: int = 1,
                 eta: float = 0.0,
                 height: Optional[int] = None,
                 width: Optional[int] = None,
                 seed: Optional[int] = None,
                 latents=None,
                 domain_embed_scale: Optional[float] = None,
                 scheduler_type: Optional[str] = None,
                 output_type: str = "np"):
        """``prompt`` may be a list of distinct prompts, batched into one
        sampling run with per-sample prompt embeddings; each prompt's block
        gets the same seeded initial noise a standalone run would draw.
        ``latents`` (B, 4, h, w) replaces that noise. ``output_type``:
        "np" (float32 NCHW in [0, 1]), "pil" or "latent"."""
        if output_type not in ("np", "pil", "latent"):
            raise ValueError(f"output_type {output_type!r}")
        modules, dev = self.modules, self.device
        ucfg = modules.unet.config
        vae_scale = 2 ** (len(modules.vae.config.block_out_channels) - 1)
        height = height or ucfg.sample_size * vae_scale
        width = width or ucfg.sample_size * vae_scale
        des = (self.domain_embed_scale if domain_embed_scale is None
               else domain_embed_scale)
        scheduler = self.scheduler
        if scheduler_type is not None:
            # another sampler on the pipeline's noise schedule (its
            # prediction type among it: v on an SD 2.x base)
            scheduler = SCHEDULER_MAPPING[scheduler_type](scheduler.config)

        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        prepared = [self._prepare_prompt(p) for p in prompts]
        uncond_ids = self.tokenizer(
            "", padding="max_length", truncation=True,
            max_length=self.tokenizer.model_max_length)["input_ids"]
        b = len(prompts) * num_images_per_prompt
        seed = 0 if seed is None else seed
        if latents is None:
            gen = torch.Generator(dev).manual_seed(seed)
            shape1 = (num_images_per_prompt, ucfg.in_channels,
                      height // vae_scale, width // vae_scale)
            latents = torch.randn(shape1, generator=gen, device=dev)
            latents = latents.repeat(len(prompts), 1, 1, 1)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        if latents.shape[0] != b:
            raise ValueError(f"latents hold {latents.shape[0]} samples; "
                             f"{len(prompts)} prompts x "
                             f"{num_images_per_prompt} images need {b}")

        text = modules.text_encoder
        with torch.inference_mode():
            ids = torch.tensor([ids for ids, _ in prepared], device=dev)
            if len(prompts) > 1:  # per-sample embeddings, repeated per image
                ids = ids.repeat_interleave(num_images_per_prompt, dim=0)
            inputs_embeds = text.embed_tokens(ids)
            class_embed = text.embed_tokens(
                torch.tensor([self.class_token_id], device=dev))[0]
        ph_idx = torch.tensor(np.repeat([i for _, i in prepared],
                                        num_images_per_prompt), device=dev)
        pixel = torch.from_numpy(preprocess_image(image)).to(dev)
        noise_gen = torch.Generator(dev).manual_seed(seed ^ 0x5DEECE66D)
        rows = None
        if self.data_parallel:
            rows = (self.mesh.rows(b).start, b)
            # per-sample prompt embeddings are split, one prompt's kept
            split = pmesh.shard_batch({"latents": latents, "ph_idx": ph_idx,
                                       "embeds": inputs_embeds}, self.mesh)
            latents, ph_idx = split["latents"], split["ph_idx"]
            inputs_embeds = split["embeds"]
        parallel = {"mesh": self.mesh, "rows": rows}

        common = (self.offsets, latents, pixel, inputs_embeds, ph_idx,
                  torch.tensor([uncond_ids[0]], device=dev), class_embed)
        lora = ({"lora_bank": self.lora_bank} if self.lora_bank is not None
                else {})
        act_amax = aux_amax = None
        calib_latents = latents  # the best decode input at hand
        if self.int8 in ("static", "static_pc"):
            if self.act_amax is None:
                want_final = (self.int8_aux == "static"
                              and self.aux_amax is None)
                calibrate = make_calibration_fn(
                    modules, scheduler,
                    int(os.environ.get("E4T_INT8_CALIB_STEPS", "8")),
                    guidance_scale, des, eta=eta, lora_scale=self.lora_scale,
                    return_final_latents=want_final, **parallel)
                out = calibrate(*common, torch.Generator(dev).manual_seed(
                    seed ^ 0x5DEECE66D), **lora)
                if want_final:  # the denoised range the decode will see
                    self.act_amax, calib_latents = out
                else:
                    self.act_amax = out
            act_amax = self.act_amax
        if self.int8_aux == "static":
            if self.aux_amax is None:
                self.aux_amax = make_aux_calibration_fn(modules)(
                    pixel, calib_latents)
                # the rows' ranges made the same on every rank
                with torch.inference_mode():
                    for amax in self.aux_amax.values():
                        pmesh.reduce_calibration(amax, None, self.mesh)
            aux_amax = self.aux_amax
        fn = make_sample_fn(modules, scheduler, num_inference_steps,
                            guidance_scale, des,
                            return_latents=output_type == "latent", eta=eta,
                            int8=_serving_int8_mode(self.int8),
                            int8_aux=self.int8_aux, int8_attn=self.int8_attn,
                            lora_scale=self.lora_scale, **parallel)
        out = fn(*common, noise_gen, act_amax=act_amax, aux_amax=aux_amax,
                 **lora)
        if self.data_parallel:
            out = self.mesh.gather_rows(out)
        if output_type == "pil":
            from PIL import Image

            arr = (out.float() * 255.0).round().to(torch.uint8)
            return [Image.fromarray(a) for a in
                    arr.permute(0, 2, 3, 1).cpu().numpy()]
        return out.float().cpu().numpy()
