"""CLIP-I / CLIP-T evaluation of generated samples.

    python -m e4t_diffusion_torch.evaluate_clip_scores \\
        --generated_dir out/samples --source_image /data/src.jpg \\
        --prompt "a photo of *s" --class_word face \\
        --open_clip_weights /data/open_clip_vit_h14.pt \\
        --tokenizer_dir /data/sd/tokenizer [--device cpu]

Counterpart of the JAX package's ``scripts/evaluate_clip_scores.py`` (the
same flags and the same one JSON line), with an open_clip ViT-H-14
checkpoint (``models/clip_score.py``, f32):

- CLIP-I: the mean cosine similarity between the image features of each
  generated image and of the source image;
- CLIP-T: the mean cosine similarity between each generated image's
  features and its prompt's text features.

The placeholder token is replaced by ``--class_word`` for text scoring.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from e4t_diffusion_torch.data.dataset import list_image_files_recursively
from e4t_diffusion_torch.diffusion.pipeline import resolve_device
from e4t_diffusion_torch.models.clip_score import (
    CLIPScoreConfig, CLIPScorer, clip_i, clip_t, scorer_from_open_clip)
from e4t_diffusion_torch.utils.convert import load_state_dict_file
from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--generated_dir", type=str, required=True)
    p.add_argument("--source_image", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--placeholder_token", type=str, default="*s")
    p.add_argument("--class_word", type=str, default="person")
    p.add_argument("--open_clip_weights", type=str, required=True)
    p.add_argument("--tokenizer_dir", type=str, required=True)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda; 'cpu' runs the plain versions of "
                        "the kernels")
    return p.parse_args(argv)


def load_pixels(path: str, size: int) -> np.ndarray:
    """An image file as (1, 3, size, size) f32 in [-1, 1] (PIL resize)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB").resize((size, size))
    arr = np.asarray(img).astype(np.float32) / 127.5 - 1.0
    return arr.transpose(2, 0, 1)[None]


def load_scorer(path: str, dev) -> CLIPScorer:
    """The f32 ``CLIPScorer`` of an open_clip ViT-H-14 checkpoint on
    ``dev``, loaded strictly, in eval mode and frozen."""
    config = CLIPScoreConfig()
    sd = scorer_from_open_clip(load_state_dict_file(path), config)
    with torch.device(dev):
        scorer = CLIPScorer(config)
    scorer.load_state_dict(sd, strict=True)
    return scorer.eval().requires_grad_(False)


def main(argv=None):
    """Score as the flags say; prints and returns the record."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    scorer = load_scorer(args.open_clip_weights, dev)

    tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer_dir)
    prompt = args.prompt.replace(args.placeholder_token, args.class_word)
    ids = torch.tensor(tokenizer(prompt, padding="max_length",
                                 truncation=True,
                                 max_length=77)["input_ids"], device=dev)

    def image_features(path):
        pixels = torch.from_numpy(load_pixels(path, args.resolution)).to(dev)
        return scorer.image_features(pixels)

    files = list_image_files_recursively(args.generated_dir)
    if not files:
        raise SystemExit(f"no images in {args.generated_dir}")
    clip_i_vals, clip_t_vals = [], []
    with torch.inference_mode():
        src_feats = image_features(args.source_image)
        text_feats = scorer.text_features(ids)
        for f in files:
            gen_feats = image_features(f)
            clip_i_vals.append(float(clip_i(gen_feats, src_feats)))
            clip_t_vals.append(float(clip_t(gen_feats, text_feats)))
    record = {"clip_i": float(np.mean(clip_i_vals)),
              "clip_t": float(np.mean(clip_t_vals)),
              "n_images": len(files)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
