"""One-command real-weights validation (BASELINE.md's CLIP parity row).

Counterpart of ``scripts/validate_real_weights.py``: the same flags (and
``--device``), the same JSON keys and the same ``validation.json``. The day
a diffusers SD-v1-4 directory and the published E4T checkpoint
(mshing/e4t-diffusion-ffhq-celebahq-v1) can be copied in, this runs the
whole chain in one command:

1. stage the E4T checkpoint with its ``pretrained_model_name_or_path``
   rewritten to the local SD directory (the published config names the
   hub id);
2. (``--tune_steps N``) domain-tune on the target image as the reference
   README does before its sample (30 steps);
3. generate the README prompt ("a photo of *s in the beach") with the bf16
   pipeline, then again with ``--int8 --int8_static_act``;
4. report the int8-vs-bf16 image delta (rel-L2, PSNR);
5. if open_clip ViT-H-14 weights are staged too, score CLIP-I (against the
   domain image, and the reference's published sample if given) and CLIP-T
   (against the prompt) with ``models/clip_score``, in this process.

Steps 2 and 3 run the port's CLIs as subprocesses (``python -m
e4t_diffusion_torch.tuning_e4t`` and ``.inference``), so a passing run is
evidence that the user-facing chain, strict weight loads included, works.
On the card unless ``--device cpu``; ``tests/test_torch_validate_real_
weights.py`` runs the chain on a tiny synthetic SD directory.

    python -m e4t_diffusion_torch.validate_real_weights \\
        --e4t_ckpt /data/e4t-diffusion-ffhq-celebahq-v1 \\
        --sd_dir /data/stable-diffusion-v1-4 \\
        --domain_image /data/yann-lecun.jpg \\
        --reference_image /data/yann-in-the-beach.png --tune_steps 30 \\
        --open_clip_weights /data/open_clip_vit_h14.pt \\
        --out_dir out/validation

Prints one JSON line, also written to ``<out_dir>/validation.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--e4t_ckpt", required=True,
                   help="E4T 3-artifact checkpoint dir (pretrained or "
                        "domain-tuned)")
    p.add_argument("--sd_dir", default=None,
                   help="local diffusers SD-v1 dir; rewrites the ckpt's "
                        "pretrained_model_name_or_path (omit if the ckpt "
                        "already points at a reachable path)")
    p.add_argument("--domain_image", required=True,
                   help="target/source image (ViT conditioning + CLIP-I)")
    p.add_argument("--prompt", default="a photo of *s in the beach",
                   help="README sample prompt by default")
    p.add_argument("--reference_image", default=None,
                   help="the reference's published sample to score "
                        "against (assets/yann-in-the-beach.png)")
    p.add_argument("--tune_steps", type=int, default=0,
                   help=">0: domain-tune on --domain_image first "
                        "(README uses 30)")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--resolution", type=int, default=512,
                   help="tuning resolution and generated height/width")
    p.add_argument("--train_batch_size", type=int, default=4,
                   help="tuning batch")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--open_clip_weights", default=None,
                   help="open_clip ViT-H-14 .pt for CLIP-I/CLIP-T "
                        "(skipped if absent)")
    p.add_argument("--class_word", default="face",
                   help="replaces the placeholder token for CLIP-T")
    p.add_argument("--skip_int8", action="store_true")
    p.add_argument("--out_dir", default="out/validation")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda; 'cpu' runs the plain versions of "
                        "the kernels (passed to every step)")
    return p.parse_args(argv)


def _run(module: str, args: List[str]) -> None:
    """``python -m e4t_diffusion_torch.<module> <args>`` from the root of
    the checkout; a failure stops the chain."""
    cmd = [sys.executable, "-m", f"e4t_diffusion_torch.{module}", *args]
    print(f"[validate] $ {' '.join(cmd[1:])}", file=sys.stderr, flush=True)
    r = subprocess.run(cmd, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit(f"[validate] step failed (rc={r.returncode}): "
                         f"{module}")


def stage_ckpt(e4t_ckpt: str, sd_dir: str, out_dir: str) -> str:
    """Copy the ckpt dir with pretrained_model_name_or_path rewritten to
    the local SD dir; weight files are symlinked, not copied."""
    staged = os.path.join(out_dir, "staged_ckpt")
    os.makedirs(staged, exist_ok=True)
    for name in os.listdir(e4t_ckpt):
        src = os.path.join(e4t_ckpt, name)
        dst = os.path.join(staged, name)
        if name == "config.json" or not os.path.isfile(src):
            continue
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
    with open(os.path.join(e4t_ckpt, "config.json")) as f:
        cfg = json.load(f)
    # the key lives either at the top level (tuning output) or nested in
    # pretrained_args (pretrain output): rewrite wherever present
    if "pretrained_model_name_or_path" in cfg:
        cfg["pretrained_model_name_or_path"] = sd_dir
    if isinstance(cfg.get("pretrained_args"), dict):
        cfg["pretrained_args"]["pretrained_model_name_or_path"] = sd_dir
    with open(os.path.join(staged, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return staged


def image_delta(path_a: str, path_b: str) -> Dict[str, float]:
    from PIL import Image

    a = np.asarray(Image.open(path_a).convert("RGB"), np.float32) / 255.0
    b = np.asarray(Image.open(path_b).convert("RGB"), np.float32) / 255.0
    rel_l2 = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    mse = float(np.mean((a - b) ** 2))
    psnr = float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    return {"rel_l2": round(rel_l2, 5), "psnr_db": round(psnr, 2)}


def clip_scores(args, image_paths: Sequence[str], out: Dict) -> None:
    """CLIP-I / CLIP-T with ``models/clip_score`` (open_clip ViT-H-14, f32),
    the scorer ``evaluate_clip_scores`` loads."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import resolve_device
    from e4t_diffusion_torch.evaluate_clip_scores import (load_pixels,
                                                          load_scorer)
    from e4t_diffusion_torch.models.clip_score import clip_i, clip_t
    from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

    dev = resolve_device(args.device)
    scorer = load_scorer(args.open_clip_weights, dev)

    def feats(path):
        return scorer.image_features(
            torch.from_numpy(load_pixels(path, 224)).to(dev))

    with torch.inference_mode():
        gen_feats = [feats(p) for p in image_paths]
        src_feats = feats(args.domain_image)
        out["clip_i_vs_domain"] = round(float(np.mean(
            [float(clip_i(g, src_feats)) for g in gen_feats])), 4)
        if args.reference_image:
            ref_feats = feats(args.reference_image)
            out["clip_i_vs_reference_sample"] = round(float(np.mean(
                [float(clip_i(g, ref_feats)) for g in gen_feats])), 4)
        tok_dir = os.path.join(args.sd_dir or "", "tokenizer")
        if os.path.isdir(tok_dir):
            tokenizer = CLIPTokenizer.from_pretrained(tok_dir)
            text = args.prompt.replace("*s", args.class_word)
            ids = torch.tensor(tokenizer(text, padding="max_length",
                                         truncation=True,
                                         max_length=77)["input_ids"],
                               device=dev)
            text_feats = scorer.text_features(ids)
            out["clip_t"] = round(float(np.mean(
                [float(clip_t(g, text_feats)) for g in gen_feats])), 4)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    device = ["--device", args.device] if args.device else []
    out = {"metric": "real_weights_validation", "prompt": args.prompt}

    ckpt = args.e4t_ckpt
    if args.sd_dir:
        ckpt = stage_ckpt(args.e4t_ckpt, os.path.abspath(args.sd_dir),
                          args.out_dir)
        out["staged_ckpt"] = ckpt

    if args.tune_steps > 0:
        tuned = os.path.abspath(os.path.join(args.out_dir, "tuned"))
        _run("tuning_e4t", [
            "--pretrained_model_name_or_path", os.path.abspath(ckpt),
            "--prompt_template", "a photo of {placeholder_token}",
            "--reg_lambda", "0.1",
            "--output_dir", tuned,
            "--train_image_path", os.path.abspath(args.domain_image),
            "--resolution", str(args.resolution),
            "--train_batch_size", str(args.train_batch_size),
            "--learning_rate", "1e-6", "--scale_lr",
            "--max_train_steps", str(args.tune_steps),
            "--use_8bit_adam", "--seed", str(args.seed), *device])
        # the tuning CLI writes its artifacts to output_dir/<step>/
        ckpt = os.path.join(tuned, str(args.tune_steps))
        out["tuned_ckpt"] = ckpt

    def generate(tag, extra):
        png = os.path.abspath(os.path.join(args.out_dir, f"{tag}.png"))
        _run("inference", [
            "--pretrained_model_name_or_path", os.path.abspath(ckpt),
            "--image_path_or_url", os.path.abspath(args.domain_image),
            "--prompt", args.prompt,
            "--num_inference_steps", str(args.num_inference_steps),
            "--guidance_scale", str(args.guidance_scale),
            "--height", str(args.resolution),
            "--width", str(args.resolution),
            "--seed", str(args.seed),
            "--output", png, *extra, *device])
        return png

    bf16_png = generate("bf16", [])
    out["bf16_sample"] = bf16_png
    gen_paths = [bf16_png]
    if not args.skip_int8:
        int8_png = generate("int8_static", ["--int8", "--int8_static_act"])
        out["int8_sample"] = int8_png
        out["int8_vs_bf16"] = image_delta(int8_png, bf16_png)
        gen_paths.append(int8_png)

    if args.open_clip_weights and os.path.exists(args.open_clip_weights):
        clip_scores(args, gen_paths[:1], out)
    else:
        out["clip_scores"] = "skipped (no --open_clip_weights staged)"

    with open(os.path.join(args.out_dir, "validation.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
