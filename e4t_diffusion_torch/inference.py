"""E4T inference CLI: ``python -m e4t_diffusion_torch.inference``.

Loads a tuned or pretrained E4T artifact directory (or a registry name,
``utils/hub.py``, found under ``$E4T_MODELS_DIR``), builds the sampling
pipeline on the GPU (``--device cpu`` to run on the CPU) and renders the
prompts to a grid image. '::' splits several prompts; ``--batch_prompts``
samples them as one batch. ``--scheduler_type`` picks one of the six
samplers. ``--int8`` (with ``--int8_static_act``, ``--int8_pc_act``,
``--act_scales``) serves the UNet in int8, ``--int8_attn`` its large
self-attention sites too, ``--int8_aux`` (``--int8_aux_static``) the ViT-H
and the VAE decode. ``--lora_weights`` folds LoRA attention adapters into
the UNet at ``--lora_scale``. ``--vit_gelu_tanh`` sets
``E4T_VIT_GELU=tanh`` for the run (the ViT-H's MLP on the tanh GELU).
Under ``torchrun --nproc_per_node N`` (one process a card),
``--tensor_parallel T`` splits the UNet's attention and feed-forward sites
over T ranks and ``--data_parallel_serving`` splits the batch over the
other N / T; rank 0 writes the grid.
The batch server ``serve_e4t`` shares the serving flags (``add_serving_args``)
and ``build_pipeline``.
"""
from __future__ import annotations

import argparse
import os

import torch

from e4t_diffusion_torch.config import (get_e4t_config, getattr_from_config,
                                        load_config)
from e4t_diffusion_torch.diffusion.pipeline import (
    E4TModules, StableDiffusionE4TPipeline, resolve_device, resolve_dtype)
from e4t_diffusion_torch.diffusion.schedulers import SCHEDULER_MAPPING
from e4t_diffusion_torch.models import lora
from e4t_diffusion_torch.models.vit import VIT_GELU_KNOB
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.utils import artifacts
from e4t_diffusion_torch.utils.hub import resolve_model_dir
from e4t_diffusion_torch.utils.image import image_grid, load_image
from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer


def add_serving_args(parser: argparse.ArgumentParser) -> None:
    """The flags that pick how a pipeline serves, shared with the batch
    server: the sampler, the compute type and device, int8 serving and the
    LoRA adapters."""
    parser.add_argument("--pretrained_model_name_or_path", type=str,
                        required=True,
                        help="artifact dir with config.json, encoder.pt and "
                             "weight_offsets.pt or unet.pt")
    parser.add_argument("--scheduler_type", type=str, default="ddim",
                        choices=list(SCHEDULER_MAPPING))
    parser.add_argument("--dtype", type=str, default="auto",
                        choices=["auto", "bf16", "fp32"],
                        help="compute dtype (auto = bf16 on the GPU, fp32 "
                             "on the CPU; fp32 on the GPU runs the f32 "
                             "attention kernels)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; runs on the GPU unless 'cpu' "
                             "is given")
    parser.add_argument("--int8", action="store_true",
                        help="quantize the offset-folded UNet weights to "
                             "int8 once per run and serve its linear and "
                             "conv sites in int8 (ops/quant.py), with "
                             "dynamic activation scales")
    parser.add_argument("--int8_static_act", action="store_true",
                        help="implies --int8: static activation scales, "
                             "calibrated on a short trajectory at the first "
                             "prompt (E4T_INT8_CALIB_STEPS, default 8); the "
                             "residual-conv sites stay dynamic "
                             "(E4T_INT8_STATIC_EXCLUDE overrides the list)")
    parser.add_argument("--int8_pc_act", action="store_true",
                        help="implies --int8_static_act: per-channel "
                             "calibrated activation scales folded into the "
                             "int8 weights (E4T_INT8_PC_ALPHA tunes the "
                             "fold); every site static")
    parser.add_argument("--act_scales", type=str, default=None,
                        help="with --int8_static_act: JSON file of "
                             "calibrated activation ranges (the JAX "
                             "package's format); loaded if it exists, else "
                             "written after the first prompt's calibration")
    parser.add_argument("--int8_attn", choices=["qk", "qkpv"], default=None,
                        help="run the low-head-dim flash-attention sites on "
                             "the int8 kernel: per-head q/k quantization "
                             "with k mean-centred ('qkpv': P@V in int8 "
                             "too); independent of --int8")
    parser.add_argument("--int8_aux", action="store_true",
                        help="also serve the once-per-run towers in int8: "
                             "the ViT-H image encoder (conv1 included) and "
                             "the VAE decode (post_quant_conv and the "
                             "decoder but its conv_in / conv_out), with "
                             "dynamic activation scales; independent of "
                             "--int8")
    parser.add_argument("--int8_aux_static", action="store_true",
                        help="implies --int8_aux: static activation scales "
                             "for the towers, calibrated by one ViT-H "
                             "encode and one VAE decode at the first "
                             "prompt (on the UNet calibration's denoised "
                             "latents with --int8_static_act)")
    parser.add_argument("--lora_weights", type=str, default=None,
                        help="LoRA attention adapters: a diffusers-0.14 "
                             "attn-procs state dict (pytorch_lora_weights"
                             ".bin layout), folded into the UNet's weights "
                             "after the E4T offsets (models/lora.py)")
    parser.add_argument("--lora_scale", type=float, default=1.0,
                        help="LoRA scale (the reference processor's "
                             "default)")
    parser.add_argument("--vit_gelu_tanh", action="store_true",
                        help="serve the ViT-H tower's GELU with the tanh "
                             "approximation: sets E4T_VIT_GELU=tanh for "
                             "the run (open_clip uses exact erf, the "
                             "default); feature deviation bounded in "
                             "tests/test_vit_gelu_knob.py")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="tensor-parallel serving degree: the UNet's "
                             "attention and feed-forward sites split over "
                             "this many ranks of a torchrun launch, flash "
                             "attention on each rank's heads")
    parser.add_argument("--data_parallel_serving", action="store_true",
                        help="split each sampling batch over the dp ranks "
                             "of a torchrun launch (the processes left "
                             "after --tensor_parallel); the batch must be "
                             "divisible by dp, and the images equal one "
                             "card's")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_serving_args(parser)
    parser.add_argument("--image_path_or_url", type=str, required=True,
                        help="path to the input image")
    parser.add_argument("--prompt", type=str, nargs="?",
                        default="a photo of *s", help="the prompt to render")
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=1.0)
    parser.add_argument("--num_images_per_prompt", type=int, default=1)
    parser.add_argument("--height", type=int, default=None,
                        help="default: the base UNet's sample_size x 8 "
                             "(512 for SD v1, 768 for SD 2.1; the JAX "
                             "CLI's default is 512 on every base)")
    parser.add_argument("--width", type=int, default=None,
                        help="default: as --height")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_prompts", action="store_true",
                        help="run all '::'-separated prompts as one batched "
                             "sampling run")
    parser.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="accepted for parity with the reference CLI "
                             "and ignored; flash attention is always used")
    parser.add_argument("--output", type=str, default="grid.png")
    return parser.parse_args(argv)


def int8_mode(args):
    """--int8_pc_act implies --int8_static_act, which implies --int8."""
    if args.int8_pc_act:
        return "static_pc"
    if args.int8_static_act:
        return "static"
    return args.int8


def int8_aux_mode(args):
    """--int8_aux_static implies --int8_aux."""
    return "static" if args.int8_aux_static else args.int8_aux


def build_pipeline(args) -> StableDiffusionE4TPipeline:
    """Load the artifact directory named by ``args`` into a pipeline."""
    if args.vit_gelu_tanh:
        # read per call by models/vit.MLP, as the reference's CLI sets it
        # before its encode program is traced
        os.environ[VIT_GELU_KNOB] = "tanh"
    dtype = resolve_dtype(args.dtype, torch.device(args.device))
    device = pmesh.maybe_initialize_distributed(resolve_device(args.device))
    mesh = pmesh.get_mesh(tp=args.tensor_parallel)
    args.pretrained_model_name_or_path = resolve_model_dir(
        args.pretrained_model_name_or_path)
    config = load_config(args.pretrained_model_name_or_path)
    sd_path = getattr_from_config(config, "pretrained_model_name_or_path")
    e4t_config = get_e4t_config(config)
    base = artifacts.load_sd_base(sd_path)
    enc_cfg = artifacts.e4t_encoder_config_from_args(
        e4t_config, word_embedding_dim=base["text_config"].hidden_size,
        unet_config=base["unet_config"])
    loaded = artifacts.load_e4t_weights(args.pretrained_model_name_or_path,
                                        base)
    modules = E4TModules.create(base["unet_config"], base["vae_config"],
                                base["text_config"], enc_cfg, dtype=dtype,
                                device=device)
    tokenizer = CLIPTokenizer.from_pretrained(
        base["tokenizer_dir"],
        model_max_length=base["text_config"].max_position_embeddings)
    if tokenizer.add_tokens(e4t_config.placeholder_token) == 0:
        raise ValueError(f"The tokenizer already contains the token "
                         f"{e4t_config.placeholder_token}.")
    text_rows = loaded["text"][
        "text_model.embeddings.token_embedding.weight"].shape[0]
    modules.text_encoder.resize_token_embeddings(text_rows)
    modules.load_state_dicts({k: loaded[k]
                              for k in ("unet", "vae", "text", "e4t")})
    # placeholder registration grows the vocab (new rows never reach the
    # encoder: the placeholder slot is overwritten before encoding)
    modules.text_encoder.resize_token_embeddings(
        len(tokenizer), torch.Generator(device).manual_seed(0))
    pmesh.apply_tensor_parallel(modules.unet, mesh)
    if mesh.distributed:
        print(f"parallel serving mesh: {mesh.describe()}"
              + (" (batch dp-sharded)" if args.data_parallel_serving
                 else ""))
    scheduler = SCHEDULER_MAPPING[args.scheduler_type](
        base["schedule_config"])
    act_scales = None
    if args.act_scales and os.path.exists(args.act_scales):
        act_scales = quant.load_act_scales(args.act_scales, device=device)
        print(f"loaded activation ranges from {args.act_scales}")
    lora_bank = None
    if args.lora_weights:
        lora_bank = lora.load_lora_weights(args.lora_weights,
                                           base["unet_config"], device)
        print(f"loaded LoRA adapters ({len(lora_bank)} attention sites, "
              f"scale {args.lora_scale})")
    return StableDiffusionE4TPipeline(modules, loaded["offsets"], tokenizer,
                                      e4t_config, scheduler=scheduler,
                                      already_added_placeholder_token=True,
                                      int8=int8_mode(args),
                                      int8_attn=args.int8_attn or False,
                                      act_scales=act_scales,
                                      int8_aux=int8_aux_mode(args),
                                      lora_bank=lora_bank,
                                      lora_scale=args.lora_scale, mesh=mesh,
                                      data_parallel=args.data_parallel_serving)


def maybe_save_act_scales(pipe: StableDiffusionE4TPipeline, args) -> None:
    """After the first render: write freshly calibrated ranges where
    ``--act_scales`` names a file that does not exist yet (rank 0; the
    ranges are the same on every rank)."""
    if (args.act_scales and pipe.act_amax is not None and pipe.mesh.is_main
            and not os.path.exists(args.act_scales)):
        quant.save_act_scales(pipe.act_amax, args.act_scales)
        print(f"saved activation ranges to {args.act_scales}")


def main(argv=None):
    args = parse_args(argv)
    pipe = build_pipeline(args)
    image = load_image(args.image_path_or_url)
    prompts = args.prompt.split("::")
    kwargs = dict(num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale,
                  num_images_per_prompt=args.num_images_per_prompt,
                  height=args.height, width=args.width, seed=args.seed,
                  output_type="pil")
    if args.batch_prompts and len(prompts) > 1:
        all_images = pipe(prompts, image, **kwargs)
    else:
        all_images = [img for p in prompts for img in pipe(p, image, **kwargs)]
    maybe_save_act_scales(pipe, args)
    if pipe.mesh.is_main:
        image_grid(all_images, len(prompts),
                   args.num_images_per_prompt).save(args.output)
        print(f"DONE! See `{args.output}` for the results!")
    pipe.mesh.barrier()


if __name__ == "__main__":
    main()
