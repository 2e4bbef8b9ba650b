#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, TF32 switched off for matmuls and convolutions;
2. build: nvcc compiles the port's kernel source;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes and at ragged shapes, with times, the work's
   bound and a library call of the same function as a yardstick;
4. main path: StableDiffusionE4TPipeline at full SD-v1 width (UNet, VAE,
   CLIP-L text, ViT-H-14 E4T encoder) with seeded random bf16 weights,
   two prompts x 4 images at 512px, CFG 7.5, DDIM and DPM++ 2M; the
   kernels' launch counters must show the path went through them;
5. the tiny pipeline on the card against the same pipeline on the CPU.

The second-to-last line of output is a JSON ``kernels`` record, the last
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# out rel-L2 against the f32 plain version: bf16 output rounding is ~2e-3
KERNEL_OUT_REL_L2 = 1e-2
# lse is accumulated and written in f32
KERNEL_LSE_MAX_ABS = 2e-3
# the UNet's eps with the flash sites on the kernel vs on f32-softmax
# einsum attention, same bf16 weights and inputs
UNET_ROUTE_REL_L2 = 2e-2
# two same-seed sampling runs, images in [0, 1] (kernels and cuBLAS are
# deterministic; cuDNN may pick other algorithms between calls)
RERUN_MAX_ABS = 1e-2
# tiny pipeline, f32 with TF32 off, card vs CPU, images in [0, 1]
TINY_CARD_VS_CPU_MAX_ABS = 1e-3

STEPS = 4
PROMPTS = ["a photo of *s", "a *s face in monet style"]
IMAGES_PER_PROMPT = 4
RESOLUTION = 512

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# flop/s; exp2 on the special-function units: 16 per clock per SM (CUDA C++
# Programming Guide throughput table, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 16 * 132 * 1.98e9


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20):
    """Median over ``reps`` of one call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_environment():
    import torch

    from e4t_diffusion_torch.ops import _build

    smi = nvidia_smi_line()
    print(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({
        "phase": "environment", "card": smi,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark}))
    return smi


def phase_build():
    from e4t_diffusion_torch.ops import _build, flash_lowdim

    t0 = time.perf_counter()
    log = _build.build(flash_lowdim.SOURCE)
    seconds = time.perf_counter() - t0
    usage = [ln.split("info    : ")[-1] for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "build", "source": flash_lowdim.SOURCE,
                      "seconds": round(seconds, 3), "ptxas": usage}))


def _flash_case(bh, sq, sk, d, gen, timed):
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops.flash_lowdim import (
        flash_fwd_lowdim, flash_fwd_lowdim_reference)

    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd_lowdim(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_fwd_lowdim_reference(q.float(), k.float(),
                                                  v.float(), scale)
    rel = ((out.float() - ref_out).norm() / ref_out.norm()).item()
    lse_err = (lse - ref_lse).abs().max().item()
    case = {"bh": bh, "sq": sq, "sk": sk, "d": d, "out_rel_l2": rel,
            "out_max_abs": (out.float() - ref_out).abs().max().item(),
            "lse_max_abs": lse_err}
    if not (rel <= KERNEL_OUT_REL_L2 and lse_err <= KERNEL_LSE_MAX_ABS):
        fail(f"flash_fwd_lowdim disagrees with its plain version: {case}")
    if timed:
        n_bytes = 2 * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq
        flops = 4 * bh * sq * sk * d
        exps = bh * sq * sk
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(flops / BF16_FLOP_PER_S, exps / EXP_PER_S) * 1e3
        case.update(
            ms=cuda_time_ms(lambda: flash_fwd_lowdim(q, k, v, scale)),
            plain_ms=cuda_time_ms(lambda: flash_fwd_lowdim_reference(
                q.float(), k.float(), v.float(), scale)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bytes=n_bytes, flops=flops, exps=exps)
    del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return case


def phase_kernels():
    import torch

    gen = torch.Generator("cuda").manual_seed(0)
    # the main path's two flash sites at 512px, batch 8 (BH = 8 x 8 heads)
    path = [_flash_case(64, 4096, 4096, 40, gen, timed=True),
            _flash_case(64, 1024, 1024, 80, gen, timed=True)]
    ragged = [_flash_case(4, 300, 200, 40, gen, timed=False)]
    for d, sq, sk in ((8, 65, 33), (24, 100, 130), (64, 128, 257),
                      (80, 70, 90), (120, 257, 257)):
        ragged.append(_flash_case(2, sq, sk, d, gen, timed=False))
    print(json.dumps({"phase": "kernels", "flash_fwd_lowdim": path,
                      "ragged": ragged}))
    return path, ragged


def _full_width_pipeline(tok_dir):
    import torch

    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.diffusion.pipeline import (
        E4TModules, StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    ucfg, ecfg = UNetConfig(), E4TEncoderConfig()
    if not (tap_feature_dim(ucfg) == ecfg.unet_feature_dim == 10880
            and ecfg.n_fused == 129):
        fail("the full-width configs are not SD-v1 / ViT-H-14")
    torch.manual_seed(0)
    t0 = time.perf_counter()
    modules = E4TModules.create(ucfg, VAEConfig(), CLIPTextConfig(), ecfg,
                                dtype=torch.bfloat16, device="cuda")
    offsets = wo.init_offset_bank(
        ucfg, torch.Generator("cuda").manual_seed(1), device="cuda")
    # the repo holds no CLIP vocabulary: a character-level one whose ids
    # index the full 49,408-row embedding
    make_tiny_tokenizer_files(tok_dir, extra_words=[
        "a", "photo", "of", "face", "in", "monet", "style"])
    tokenizer = CLIPTokenizer.from_pretrained(tok_dir)
    pipe = StableDiffusionE4TPipeline(
        modules, offsets, tokenizer, AttributeDict({
            "placeholder_token": "*s", "domain_class_token": "face",
            "domain_embed_scale": 0.1}))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in modules.all() for p in m.parameters())
    return pipe, n_params, time.perf_counter() - t0


def _sample(pipe, image, scheduler_type, seed=0):
    import numpy as np
    import torch

    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd_lowdim

    flash_fwd_lowdim.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe(PROMPTS, image, num_inference_steps=STEPS,
                  guidance_scale=7.5, num_images_per_prompt=IMAGES_PER_PROMPT,
                  height=RESOLUTION, width=RESOLUTION, seed=seed,
                  scheduler_type=scheduler_type)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_fwd_lowdim.launches
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    if images.shape != (n, 3, RESOLUTION, RESOLUTION):
        fail(f"{scheduler_type}: output shape {images.shape}")
    if not np.isfinite(images).all():
        fail(f"{scheduler_type}: non-finite images")
    if images.min() < 0.0 or images.max() > 1.0:
        fail(f"{scheduler_type}: images outside [0, 1]")
    # 10 flash sites per UNet forward at batch >= 5, two forwards a step
    if launches != 20 * STEPS:
        fail(f"{scheduler_type}: flash_fwd_lowdim launched {launches} "
             f"times, expected {20 * STEPS}")
    return images, seconds, launches


def _profile(pipe, image):
    """Device time by kernel over one warm DDIM run (wall time is taken
    under the profiler, so the busy share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(PROMPTS, image, num_inference_steps=STEPS, guidance_scale=7.5,
             num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
             width=RESOLUTION, seed=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host ops: their device time is their kernels'
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key[:80], evt.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top": [{"kernel": k, "ms": us / 1e3, "count": c,
                     "share_of_busy": us / busy_us}
                    for us, k, c in rows[:12]]}


def _unet_route_check(pipe, gen):
    """One batch-8 UNet forward at 512px with the flash sites on the
    kernel, and again with every site on einsum attention."""
    import torch

    from e4t_diffusion_torch.ops import attention

    unet = pipe.modules.unet
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    x = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    ctx = torch.randn(n, 77, 768, device="cuda", generator=gen)
    t = torch.full((n,), 500, device="cuda")
    with torch.inference_mode():
        eps_kernel = unet(x, t, ctx).float()
        saved = attention.FLASH_SCORE_BYTES
        attention.FLASH_SCORE_BYTES = 1 << 62
        try:
            eps_plain = unet(x, t, ctx).float()
        finally:
            attention.FLASH_SCORE_BYTES = saved
    rel = ((eps_kernel - eps_plain).norm() / eps_plain.norm()).item()
    if not rel <= UNET_ROUTE_REL_L2:
        fail(f"UNet eps, kernel vs einsum route: rel-L2 {rel}")
    return rel


def phase_main_path(smi):
    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as tok_dir:
        pipe, n_params, build_s = _full_width_pipeline(tok_dir)
    image = np.random.default_rng(0).integers(
        0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)

    first, first_s, launches = _sample(pipe, image, "ddim")
    torch.cuda.reset_peak_memory_stats()
    second, second_s, launches2 = _sample(pipe, image, "ddim")
    peak = torch.cuda.max_memory_allocated()
    rerun = float(np.abs(first - second).max())
    if not rerun <= RERUN_MAX_ABS:
        fail(f"two same-seed DDIM runs differ by {rerun}")
    _, dpm_s, dpm_launches = _sample(pipe, image, "dpm_solver++")
    route_rel = _unet_route_check(pipe, torch.Generator("cuda").manual_seed(2))
    prof = _profile(pipe, image)
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    print(json.dumps({
        "phase": "main_path", "card": smi, "params": n_params,
        "setup_s": build_s, "batch": n, "resolution": RESOLUTION,
        "steps": STEPS, "guidance": 7.5,
        "ddim_first_s": first_s, "ddim_warm_s": second_s,
        "ddim_images_per_s": n / second_s, "dpm_s": dpm_s,
        "dpm_images_per_s": n / dpm_s,
        "max_memory_allocated_gb": peak / 1e9,
        "rerun_max_abs": rerun, "unet_kernel_vs_einsum_rel_l2": route_rel,
        "flash_launches": [launches, launches2, dpm_launches],
        "profile": prof}))
    return launches


def phase_tiny_vs_cpu():
    """The tiny pipeline, f32, on the card and on the CPU."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.diffusion.pipeline import (
        E4TModules, StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    torch.manual_seed(3)
    cpu = E4TModules.tiny(device="cpu")
    card = E4TModules.tiny(device="cuda")
    for src, dst in zip(cpu.all(), card.all()):
        dst.load_state_dict(src.state_dict(), strict=True)
    offsets = wo.init_offset_bank(cpu.unet.config,
                                  torch.Generator().manual_seed(4))
    cfg = AttributeDict({"placeholder_token": "*s",
                         "domain_class_token": "face",
                         "domain_embed_scale": 0.1})
    image = np.random.default_rng(5).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    latents = np.random.default_rng(6).standard_normal(
        (4, 4, 8, 8)).astype(np.float32)
    outs = []
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["a", "photo", "of",
                                                        "face"])
        for mods in (cpu, card):
            pipe = StableDiffusionE4TPipeline(
                mods, offsets, CLIPTokenizer.from_pretrained(
                    tok_dir, model_max_length=16), cfg)
            outs.append(pipe(PROMPTS[:1] + ["a *s face"], image,
                             num_inference_steps=3, guidance_scale=7.5,
                             num_images_per_prompt=2, latents=latents))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TINY_CARD_VS_CPU_MAX_ABS:
        fail(f"tiny pipeline, card vs CPU: max-abs {err}")
    print(json.dumps({"phase": "tiny_card_vs_cpu", "max_abs": err}))


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "e4t_diffusion_torch")):
        fail("run from a checkout of the repository (e4t_diffusion_torch/ "
             "is missing)")
    sys.path.insert(0, repo)

    smi = phase_environment()
    phase_build()
    path, ragged = phase_kernels()
    launches = phase_main_path(smi)
    phase_tiny_vs_cpu()

    site = path[0]
    errors = [c["out_max_abs"] for c in path + ragged]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd_lowdim", "route": "cuda",
        "source": "e4t_diffusion_torch/csrc/flash_fwd_lowdim.cu",
        "replaces": "e4t_diffusion_tpu/ops/flash_kernels.py:286",
        "launches": launches, "max_abs_err": max(errors),
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
        "library_ms": site["library_ms"],
        "at": "BH=64 Sq=Sk=4096 D=40 bf16",
        "per_site": [{k: c[k] for k in ("bh", "sq", "d", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")}
                     for c in path]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
