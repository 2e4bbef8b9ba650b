"""Offline dataset augmentation: N variations of each training image,
saved as sha1-named JPEGs.

    python -m e4t_diffusion_torch.image_variation_augmentation \\
        --train_image_dataset /data/ffhq --save_dir /data/ffhq_aug \\
        --num_images_per_image 4 --resolution 512 \\
        [--mode unclip --unclip_model_path DIR] [--device cpu]

Counterpart of the JAX package's ``scripts/image_variation_augmentation.py``
(the same flags, defaults, file names and printed lines). Modes:

- ``geometric`` (default): random resized crops, flips and a mild colour
  jitter, in numpy (``data/dataset.py``); it needs no model and no card.
- ``unclip``: Stable-unCLIP image variations
  (``diffusion/unclip_pipeline.py``) from a local diffusers-format
  stable-diffusion-2-1-unclip directory (``--unclip_model_path``), with
  DPM-Solver++ as the reference's script sets it; bf16 on the card, f32 on
  the CPU (``--device cpu``).

Each source image is resized (shorter side) and randomly cropped to
``--resolution`` before its variations are made.
"""
from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from e4t_diffusion_torch.data.dataset import (
    list_image_files_recursively, load_image_rgb, random_crop,
    smallest_max_size)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train_image_dataset", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--num_images_per_image", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mode", type=str, default="geometric",
                   choices=["geometric", "unclip"])
    p.add_argument("--unclip_model_path", type=str, default=None,
                   help="unclip mode: local diffusers-format "
                        "stable-diffusion-2-1-unclip directory")
    p.add_argument("--guidance_scale", type=float, default=10.0,
                   help="unclip mode only (diffusers default)")
    p.add_argument("--num_inference_steps", type=int, default=20,
                   help="unclip mode only")
    p.add_argument("--noise_level", type=int, default=0,
                   help="unclip mode: image-embedding noise augmentation")
    p.add_argument("--device", type=str, default=None,
                   help="unclip mode: the device (default: cuda; 'cpu' "
                        "runs the plain versions of the kernels)")
    return p.parse_args(argv)


def geometric_variation(arr: np.ndarray, resolution: int,
                        rng: np.random.Generator) -> np.ndarray:
    # random resized crop: upscale a bit, crop back, maybe flip, jitter
    scale = float(rng.uniform(1.0, 1.25))
    big = smallest_max_size(arr, int(resolution * scale))
    out = random_crop(big, resolution, rng)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    jitter = rng.uniform(0.9, 1.1, size=(1, 1, 3))
    return np.clip(out.astype(np.float32) * jitter, 0, 255).astype(np.uint8)


def build_unclip_pipeline(model_path: str, device=None):
    """A local Stable-unCLIP directory as a ``StableUnCLIPImg2ImgPipeline``
    on ``device`` (cuda unless named): bf16 on the card, f32 on the CPU."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import resolve_device
    from e4t_diffusion_torch.diffusion.schedulers import (
        DPMSolverMultistepScheduler)
    from e4t_diffusion_torch.diffusion.unclip_pipeline import (
        StableUnCLIPImg2ImgPipeline, UnCLIPModules)
    from e4t_diffusion_torch.utils.artifacts import load_sd_unclip
    from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    loaded = load_sd_unclip(model_path)
    modules = UnCLIPModules.create(
        loaded["unet_config"], loaded["vae_config"], loaded["text_config"],
        loaded["image_encoder_config"], dtype=dtype, device=dev)
    if "noise_aug_schedule" in loaded:
        modules.noise_aug_schedule = loaded["noise_aug_schedule"]
    modules.load_state_dicts({k: loaded[k] for k in (
        "unet", "vae", "text", "image_encoder", "image_normalizer")})
    # the reference's DPMSolverMultistepScheduler override
    scheduler = DPMSolverMultistepScheduler(loaded["schedule_config"])
    # sized to the text encoder, as the port's other CLIs do (77 for SD2)
    tokenizer = CLIPTokenizer.from_pretrained(
        loaded["tokenizer_dir"],
        model_max_length=loaded["text_config"].max_position_embeddings)
    return StableUnCLIPImg2ImgPipeline(modules, tokenizer, scheduler)


def main(argv=None):
    """Augment as the flags say. Returns the unCLIP pipeline (None in
    geometric mode), for callers that drive it further in process."""
    args = parse_args(argv)
    if args.mode == "unclip" and not args.unclip_model_path:
        raise SystemExit("--mode unclip requires --unclip_model_path "
                         "(a local diffusers-format stable-diffusion-2-1-"
                         "unclip directory)")
    from PIL import Image

    pipe = (build_unclip_pipeline(args.unclip_model_path, args.device)
            if args.mode == "unclip" else None)
    os.makedirs(args.save_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    files = list_image_files_recursively(args.train_image_dataset)
    print(f"{len(files)} source images")
    count = 0
    for n, path in enumerate(files):
        base = smallest_max_size(load_image_rgb(path), args.resolution)
        base = random_crop(base, args.resolution, rng)
        if pipe is not None:
            variations = pipe(
                base, num_images_per_prompt=args.num_images_per_image,
                num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                noise_level=args.noise_level, seed=args.seed + n,
                output_type="pil")
        else:
            variations = [
                Image.fromarray(geometric_variation(base, args.resolution,
                                                    rng))
                for _ in range(args.num_images_per_image)]
        for img in variations:
            name = hashlib.sha1(img.tobytes()).hexdigest()
            img.save(os.path.join(args.save_dir, f"{name}.jpg"))
            count += 1
    print(f"wrote {count} images to {args.save_dir}")
    return pipe


if __name__ == "__main__":
    main()
