"""Full-width training inputs made from seeds, on the card: random weights
at SD v1's published widths, the tokenizer with the placeholder, and
written images of mixed sizes for the data loader.

``chip_smoke.py`` and ``time_train_step.py`` build their tuning and
pretraining runs from these, so both time and check the same runs.
Importing this module touches no device.
"""
from __future__ import annotations

import os
import tempfile

RESOLUTION = 512
PRETRAIN_BATCH = 16
PRETRAIN_IMAGES = 40


def tuning_world(resolution: int = RESOLUTION):
    """Full-width tuning inputs from seeds: the modules (f32), the offset
    bank, the tokenizer with the placeholder, the class token's id and a
    random resolution x resolution image."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.training.setup import resolve_class_token
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    ucfg, ecfg = UNetConfig(), E4TEncoderConfig()
    torch.manual_seed(0)
    modules = E4TModules.create(ucfg, VAEConfig(), CLIPTextConfig(), ecfg,
                                dtype=torch.float32, device="cuda")
    offsets = wo.init_offset_bank(
        ucfg, torch.Generator("cuda").manual_seed(1), device="cuda")
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=[
            "a", "photo", "of", "the", "face"])
        tokenizer = CLIPTokenizer.from_pretrained(tok_dir)
    tokenizer.add_tokens("*s")  # its id lies inside the 49,408-row table
    class_id = resolve_class_token(tokenizer, "face")
    image = np.random.default_rng(0).integers(
        0, 256, (resolution, resolution, 3), dtype=np.uint8)
    return modules, offsets, tokenizer, class_id, image


def pretraining_world(seed: int = 0):
    """Full-width modules (f32, seeded), the encoder and offset bank the CLI
    starts from (``pretrain_e4t.load_e4t_start``: the seeded init), the
    tokenizer with the placeholder, and the ids."""
    import torch

    from e4t_diffusion_torch import pretrain_e4t
    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.training.setup import resolve_class_token
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    torch.manual_seed(seed)
    modules = E4TModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(),
                                E4TEncoderConfig(), dtype=torch.float32,
                                device="cuda")
    with tempfile.TemporaryDirectory() as base_dir:
        # a base directory without encoder.pt / weight_offsets.pt: the
        # encoder is initialised from --seed, the bank drawn from it
        args = pretrain_e4t.parse_args([
            "--pretrained_model_name_or_path", base_dir,
            "--train_image_dataset", "-", "--domain_class_token", "face",
            "--seed", str(seed)])
        offsets = pretrain_e4t.load_e4t_start(args, modules,
                                              torch.device("cuda"))
        make_tiny_tokenizer_files(base_dir, extra_words=[
            "a", "photo", "of", "the", "face"])
        tokenizer = CLIPTokenizer.from_pretrained(base_dir)
    tokenizer.add_tokens("*s")  # its id lies inside the 49,408-row table
    return (modules, offsets, tokenizer, tokenizer.convert_tokens_to_ids(
        "*s"), resolve_class_token(tokenizer, "face"))


def write_pretraining_images(folder: str, n: int = PRETRAIN_IMAGES,
                             seed: int = 0):
    """``n`` images of mixed sizes (short side 320-768, so the resize both
    shrinks and enlarges; aspect 1 to 1.75, portrait and landscape) and
    formats, so the loader's resize and crops run. Returns their (h, w)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(folder, "nested"), exist_ok=True)
    sizes = []
    for i in range(n):
        short = int(rng.integers(320, 769))
        long = int(short * rng.uniform(1.0, 1.75))
        h, w = (short, long) if i % 2 else (long, short)
        # smooth content (JPEG-friendly), a seeded gradient plus noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = (np.stack([xx * 255 // w, yy * 255 // h,
                          (xx + yy) * 255 // (h + w)], -1) + rng.integers(
            0, 32, (h, w, 3))).clip(0, 255).astype(np.uint8)
        sub = "nested" if i % 3 == 0 else ""
        ext = "jpg" if i % 2 else "png"
        Image.fromarray(base).save(os.path.join(folder, sub, f"{i:03d}.{ext}"))
        sizes.append((h, w))
    return sizes


def pretrain_args(data_dir: str, out_dir: str, *extra: str,
                  batch: int = PRETRAIN_BATCH, resolution: int = RESOLUTION):
    """The pretraining CLI's arguments for a run on ``pretraining_world``
    over ``data_dir``, plus ``extra`` flags."""
    from e4t_diffusion_torch import pretrain_e4t

    return pretrain_e4t.parse_args([
        "--pretrained_model_name_or_path", "-",
        "--train_image_dataset", data_dir, "--domain_class_token", "face",
        "--prompt_template", "normal", "--output_dir", out_dir,
        "--train_batch_size", str(batch), "--resolution", str(resolution),
        "--seed", "0", *extra])


def pretrain(args, world, loader, mesh=None):
    """``pretrain_e4t.pretrain`` on ``world`` (``pretraining_world``) and
    ``loader`` as the CLI's ``main`` makes the call; returns its result."""
    from e4t_diffusion_torch import pretrain_e4t
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.utils.trackers import make_tracker

    modules, offsets, tokenizer, placeholder_id, class_id = world
    dtype = pretrain_e4t.resolve_train_dtype(args.mixed_precision, "cuda")
    return pretrain_e4t.pretrain(
        args, modules, offsets, tokenizer, placeholder_id, class_id,
        resolve_templates(args.prompt_template), NoiseScheduleConfig(),
        dtype, loader, make_tracker(None, args.output_dir), mesh)
