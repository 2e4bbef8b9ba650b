"""Stable-unCLIP image variations (the img2img-embeds flavor) on PyTorch.

Counterpart of ``e4t_diffusion_tpu/diffusion/unclip_pipeline.py``, the
pipeline of the offline image-variation augmentation
(``image_variation_augmentation.py --mode unclip``). One call:

1. center-crop a non-square image, CLIP-preprocess it to 224px and encode
   it with the ViT-H image encoder -> ``image_embeds``, broadcast to the
   batch;
2. noise-augment the embeds at ``noise_level`` and append the noise-level
   embedding (``models/unclip.py``) -> the UNet's ``class_labels``; under
   CFG the uncond half's class labels are zeros, paired with the "" text
   states;
3. encode the prompt ("" for pure variations) with the SD2 text encoder;
4. denoise with the SD2-unCLIP UNet (v-prediction, DPM-Solver++ by
   default); the conditioning of 1-3 is computed once a call, not per step;
5. decode ``latents / scaling_factor`` with the VAE and clip to [0, 1].

Random draws come from ``torch.Generator``s seeded from ``seed``: the
initial latents, the augmentation noise, then a stochastic scheduler's
per-step noise. ``latents=`` and ``aug_noise=`` replace the first two.
Entry points run on ``cuda`` unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from e4t_diffusion_torch.diffusion.pipeline import _step_noise, resolve_device
from e4t_diffusion_torch.diffusion.schedulers import (
    DPMSolverMultistepScheduler, NoiseScheduleConfig)
from e4t_diffusion_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from e4t_diffusion_torch.models.unclip import (
    UNCLIP_NOISE_AUG_SCHEDULE, CLIPVisionModelWithProjection,
    CLIPVisionProjectionConfig, StableUnCLIPImageNormalizer,
    noise_image_embeddings)
from e4t_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from e4t_diffusion_torch.models.vae import AutoencoderKL, VAEConfig
from e4t_diffusion_torch.ops.resize import clip_preprocess

# the augmentation noise's generator is seeded with seed ^ AUG_SEED_MIX
AUG_SEED_MIX = 0x51AB1E


@dataclasses.dataclass
class UnCLIPModules:
    """The networks of Stable-unCLIP img2img, weights included."""
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    image_encoder: CLIPVisionModelWithProjection
    image_normalizer: StableUnCLIPImageNormalizer
    noise_aug_schedule: NoiseScheduleConfig = UNCLIP_NOISE_AUG_SCHEDULE

    @classmethod
    def create(cls, unet_config: UNetConfig = None,
               vae_config: VAEConfig = None,
               text_config: CLIPTextConfig = None,
               image_config: CLIPVisionProjectionConfig = None,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device, None] = None
               ) -> "UnCLIPModules":
        """Randomly initialised modules (seed with ``torch.manual_seed``) on
        ``device`` in ``dtype``; defaults: stable-diffusion-2-1-unclip."""
        dev = resolve_device(device)
        image_config = image_config or CLIPVisionProjectionConfig()
        with torch.device(dev):
            mods = cls(
                unet=UNet2DConditionModel(unet_config
                                          or UNetConfig.sd2_unclip()),
                vae=AutoencoderKL(vae_config or VAEConfig(sample_size=768)),
                text_encoder=CLIPTextModel(text_config
                                           or CLIPTextConfig.sd2()),
                image_encoder=CLIPVisionModelWithProjection(image_config),
                image_normalizer=StableUnCLIPImageNormalizer(
                    image_config.projection_dim))
        for m in mods.all():
            m.to(dtype).eval().requires_grad_(False)
        return mods

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device, None] = None
             ) -> "UnCLIPModules":
        """Matched tiny configs: the projection feeds the UNet's class
        embedding (2 x projection_dim wide)."""
        icfg = CLIPVisionProjectionConfig.tiny()
        ucfg = dataclasses.replace(
            UNetConfig.tiny(cross_attention_dim=32),
            use_linear_projection=True, class_embed_type="projection",
            projection_class_embeddings_input_dim=2 * icfg.projection_dim)
        return cls.create(ucfg, VAEConfig.tiny(), CLIPTextConfig.tiny(),
                          icfg, dtype, device)

    def all(self):
        return (self.unet, self.vae, self.text_encoder, self.image_encoder,
                self.image_normalizer)

    def load_state_dicts(self, sds: Dict[str, Dict[str, torch.Tensor]]
                         ) -> None:
        """Strictly load {"unet", "vae", "text", "image_encoder",
        "image_normalizer"} state dicts (any subset)."""
        targets = {"unet": self.unet, "vae": self.vae,
                   "text": self.text_encoder,
                   "image_encoder": self.image_encoder,
                   "image_normalizer": self.image_normalizer}
        for name, sd in sds.items():
            targets[name].load_state_dict(sd, strict=True)


def make_unclip_sample_fn(modules: UnCLIPModules, scheduler,
                          num_inference_steps: int, guidance_scale: float,
                          return_latents: bool = False) -> Callable:
    """``sample(latents, clip_pixels, prompt_ids, uncond_ids, noise_level,
    aug_noise, generator=None)`` -> images in [0, 1] (or the final
    latents). ``latents`` (B, 4, h, w) f32; ``clip_pixels`` (1, 3, 224,
    224) CLIP-preprocessed; ``prompt_ids`` / ``uncond_ids`` (1, L);
    ``noise_level`` (B,) integer; ``aug_noise`` (B, projection_dim) the
    augmentation noise; ``generator`` draws a stochastic scheduler's
    per-step noise."""
    do_cfg = guidance_scale > 1.0
    stochastic = getattr(scheduler, "stochastic", False)

    @torch.inference_mode()
    def sample(latents, clip_pixels, prompt_ids, uncond_ids, noise_level,
               aug_noise, generator=None):
        bsz, device = latents.shape[0], latents.device
        # the conditioning, once a call
        image_embeds = modules.image_encoder(clip_pixels)
        image_embeds = image_embeds.expand(bsz, -1)
        class_cond = noise_image_embeddings(
            image_embeds, noise_level, aug_noise, modules.image_normalizer,
            modules.noise_aug_schedule)
        text = modules.text_encoder
        context = text(prompt_ids)[0].expand(bsz, -1, -1)
        class_labels = class_cond
        if do_cfg:
            uncond = text(uncond_ids)[0].expand(bsz, -1, -1)
            context = torch.cat([uncond, context])
            class_labels = torch.cat([torch.zeros_like(class_cond),
                                      class_cond])

        state = scheduler.init(num_inference_steps, device)
        if hasattr(scheduler, "init_noise_sigma"):
            latents = latents * scheduler.init_noise_sigma(state)
        if hasattr(scheduler, "init_carry"):
            state = scheduler.init_carry(state, latents.shape, latents.dtype)
        for i, t in enumerate(state["timesteps"]):
            latents_in = scheduler.scale_model_input(state, i, latents)
            if do_cfg:
                latents_in = torch.cat([latents_in, latents_in])
            pred = modules.unet(latents_in, t.expand(latents_in.shape[0]),
                                context, class_labels=class_labels)
            if do_cfg:
                pred_u, pred_c = pred.chunk(2)
                pred = pred_u + guidance_scale * (pred_c - pred_u)
            noise = (_step_noise(latents.shape, generator, device,
                                 latents.dtype) if stochastic else None)
            state, latents = scheduler.step(state, i, pred, latents,
                                            noise=noise)
        if return_latents:
            return latents
        images = modules.vae.decode(
            latents / modules.vae.config.scaling_factor)
        return (images.float() / 2.0 + 0.5).clamp(0.0, 1.0)

    return sample


def square_crop(arr: np.ndarray) -> np.ndarray:
    """Center-crop (N, H, W, C) to its shorter side: CLIP's image processor
    resizes the shorter side then center-crops, so a non-square input is
    cropped before the square CLIP resize."""
    ih, iw = arr.shape[1:3]
    if ih == iw:
        return arr
    s = min(ih, iw)
    y0, x0 = (ih - s) // 2, (iw - s) // 2
    return arr[:, y0:y0 + s, x0:x0 + s]


class StableUnCLIPImg2ImgPipeline:
    """Host-side orchestration: tokenize, preprocess, seed, call the
    sampler. The scheduler defaults to DPM-Solver++ with v-prediction."""

    def __init__(self, modules: UnCLIPModules, tokenizer, scheduler=None):
        self.modules = modules
        self.device = modules.unet.conv_in.weight.device
        self.tokenizer = tokenizer
        self.scheduler = scheduler or DPMSolverMultistepScheduler(
            NoiseScheduleConfig(prediction_type="v_prediction"))

    def _tokenize(self, text: str) -> torch.Tensor:
        tok = self.tokenizer
        ids = tok(text, padding="max_length", truncation=True,
                  max_length=tok.model_max_length)["input_ids"][0]
        return torch.tensor([ids], device=self.device)

    def __call__(self, image, prompt: str = "",
                 num_inference_steps: int = 20,
                 guidance_scale: float = 10.0,
                 noise_level: int = 0,
                 num_images_per_prompt: int = 1,
                 height: Optional[int] = None,
                 width: Optional[int] = None,
                 seed: Optional[int] = None,
                 latents=None, aug_noise=None,
                 output_type: str = "pil"):
        """``image``: PIL or uint8 HWC. ``latents`` (B, 4, h, w) and
        ``aug_noise`` (B, projection_dim) replace the seeded draws.
        ``output_type``: "pil", "np" (float32 NCHW in [0, 1]) or
        "latent"."""
        if output_type not in ("np", "pil", "latent"):
            raise ValueError(f"output_type {output_type!r}")
        modules, dev = self.modules, self.device
        ucfg = modules.unet.config
        vae_scale = 2 ** (len(modules.vae.config.block_out_channels) - 1)
        height = height or ucfg.sample_size * vae_scale
        width = width or ucfg.sample_size * vae_scale

        arr = np.asarray(image).astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr[None]
        pixels = torch.from_numpy(
            square_crop(arr).transpose(0, 3, 1, 2) * 2.0 - 1.0).to(dev)
        clip_pixels = clip_preprocess(
            pixels, modules.image_encoder.config.vision.image_size)

        b = num_images_per_prompt
        seed = 0 if seed is None else seed
        if latents is None:
            latents = torch.randn(
                (b, ucfg.in_channels, height // vae_scale, width // vae_scale),
                generator=torch.Generator(dev).manual_seed(seed), device=dev)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        gen = torch.Generator(dev).manual_seed(seed ^ AUG_SEED_MIX)
        if aug_noise is None:
            aug_noise = torch.randn(
                (b, modules.image_encoder.config.projection_dim),
                generator=gen, device=dev)
        aug_noise = torch.as_tensor(aug_noise, dtype=torch.float32,
                                    device=dev)

        fn = make_unclip_sample_fn(modules, self.scheduler,
                                   num_inference_steps, guidance_scale,
                                   return_latents=output_type == "latent")
        out = fn(latents, clip_pixels, self._tokenize(prompt),
                 self._tokenize(""),
                 torch.full((b,), noise_level, dtype=torch.long, device=dev),
                 aug_noise, gen)
        if output_type == "pil":
            from PIL import Image

            arr = (out.float() * 255.0).round().to(torch.uint8)
            return [Image.fromarray(a) for a in
                    arr.permute(0, 2, 3, 1).cpu().numpy()]
        return out.float().cpu().numpy()
