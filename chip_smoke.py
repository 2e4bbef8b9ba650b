#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its wall seconds):
1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, TF32 switched off for matmuls and convolutions;
2. build: nvcc compiles every kernel source of the port, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes and at ragged shapes, with times, the work's
   bound and a library call of the same function as a yardstick;
4. sampling: StableDiffusionE4TPipeline at full SD-v1 width (UNet, VAE,
   CLIP-L text, ViT-H-14 E4T encoder) with seeded random bf16 weights,
   two prompts x 4 images at 512px, CFG 7.5, DDIM and DPM++ 2M;
5. tuning: phase-2 E4T tuning (``tuning_e4t.tune``, what the CLI runs
   after loading) at the same width, f32 trainables, bf16 compute, the
   reference defaults (batch 16, 512px), 3 steps;
6. the tiny pipeline on the card against the same pipeline on the CPU.
In phases 4 and 5 the kernels' launch counters, set to 0 just before and
read just after, must show the path went through every kernel it routes
to, as many times as its attention sites give.

The second-to-last line of output is a JSON ``kernels`` record, the last
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# out rel-L2 against the f32 plain version: bf16 output rounding is ~2e-3
KERNEL_OUT_REL_L2 = 1e-2
# lse is accumulated and written in f32
KERNEL_LSE_MAX_ABS = 2e-3
# dq/dk/dv rel-L2 against the f32 plain version on the same bf16 inputs:
# bf16 rounding of p, ds and the outputs is ~2.4e-3 (measured); the bound
# leaves room for long reductions (4096 terms per output)
KERNEL_GRAD_REL_L2 = 2e-2
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
TUNING_STEPS = 3

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
    """One nvcc per kernel source, all started together."""
    from e4t_diffusion_torch.ops import _build, flash_bwd, flash_lowdim

    sources = [flash_lowdim.SOURCE, flash_bwd.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - t0
    usage = {}
    for src, log in zip(sources, logs):
        usage[src], name = [], "?"
        for ln in log.splitlines():
            m = re.search(r"\d(flash_[a-z_]+?_kernel)ILi(\d+)E", ln)
            if m:
                name = f"{m.group(1)}<{m.group(2)}>"
            elif "registers" in ln or ("spill" in ln and
                                        "0 bytes spill stores" not in ln):
                usage[src].append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    print(json.dumps({"phase": "build", "sources": sources,
                      "seconds": round(seconds, 3), "ptxas": usage}))


def _bound(n_bytes, flops, exps):
    """The least time of the work on the card: bytes over the memory rate
    against the larger of flops over the bf16 tensor-core rate and
    exponentials over the special-function units' rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / BF16_FLOP_PER_S, exps / EXP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": n_bytes, "flops": flops, "exps": exps}


def _rel(a, b):
    return ((a.float() - b).norm() / b.norm()).item()


def _fwd_case(bh, sq, sk, d, gen, timed):
    """The forward kernel against its plain version; timed: kernel, plain,
    SDPA's forward and the bound."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops.flash_lowdim import (
        flash_fwd, flash_fwd_reference, launch_route)

    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_fwd_reference(q.float(), k.float(), v.float(),
                                           scale)
    rel = _rel(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    case = {"kernel": f"flash_fwd_{launch_route(d)}", "bh": bh, "sq": sq,
            "sk": sk, "d": d,
            "out_rel_l2": rel,
            "out_max_abs": (out.float() - ref_out).abs().max().item(),
            "lse_max_abs": lse_err}
    del ref_out, ref_lse
    if not (rel <= KERNEL_OUT_REL_L2 and lse_err <= KERNEL_LSE_MAX_ABS):
        fail(f"flash_fwd disagrees with its plain version: {case}")
    if timed:
        case.update(
            ms=cuda_time_ms(lambda: flash_fwd(q, k, v, scale)),
            plain_ms=cuda_time_ms(lambda: flash_fwd_reference(
                q.float(), k.float(), v.float(), scale)),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale)),
            **_bound(2 * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq,
                     4 * bh * sq * sk * d, bh * sq * sk))
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return case


def _bwd_case(bh, sq, sk, d, gen, timed):
    """The backward kernel, fed by the forward kernel's (out, lse), against
    ``flash_bwd_reference`` in f32 on the same bf16 inputs; timed: kernel,
    plain, SDPA's backward through autograd with the same dO, the bound.
    The bound counts the work (dq, dk, dv) needs, whatever the kernel's
    design does: five products (S, dP, dq, dk, dv), 10 flops per score
    element and head dim, and one exponential per score."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops.flash_bwd import (flash_bwd,
                                                   flash_bwd_reference)
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    q, k, v, dout = (torch.randn(bh, s, d, device="cuda", generator=gen)
                     .to(torch.bfloat16) for s in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd(q, k, v, scale)
    grads = flash_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, out, dout)]

    def plain():
        return flash_bwd_reference(*f32[:4], lse, f32[4], scale)

    refs = plain()
    case = {"kernel": "flash_bwd", "bh": bh, "sq": sq, "sk": sk, "d": d}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        case[f"{name}_rel_l2"] = _rel(g, r)
        case[f"{name}_max_abs"] = (g.float() - r).abs().max().item()
    del refs
    if max(case[f"{n}_rel_l2"] for n in ("dq", "dk", "dv")) > \
            KERNEL_GRAD_REL_L2:
        fail(f"flash_bwd disagrees with its plain version: {case}")
    if timed:
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qr[None], kr[None], vr[None], scale=scale)
        case.update(
            ms=cuda_time_ms(lambda: flash_bwd(q, k, v, out, lse, dout,
                                              scale)),
            plain_ms=cuda_time_ms(plain),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qr, kr, vr), dout[None], retain_graph=True)),
            **_bound(2 * (4 * bh * sq * d + 4 * bh * sk * d) + 4 * bh * sq,
                     10 * bh * sq * sk * d, bh * sq * sk))
        del qr, kr, vr, lib_out
    del q, k, v, dout, out, lse, grads, f32
    torch.cuda.empty_cache()
    return case


# the tuning step's attention sites at 512px, batch 16 (BH = 16 x 8 heads):
# (Sq, Sk, d) of UNet self and cross attention at three resolutions
TUNING_SITES = ((4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80),
                (1024, 77, 80), (256, 256, 160), (256, 77, 160))


def phase_kernels():
    import torch

    gen = torch.Generator("cuda").manual_seed(0)
    # sampling's two flash sites at 512px, batch 8 (BH = 8 x 8 heads)
    sampling = [_fwd_case(64, 4096, 4096, 40, gen, timed=True),
                _fwd_case(64, 1024, 1024, 80, gen, timed=True)]
    # tuning's forward sites, the ViT-H's (BH = 16 x 16 heads) included,
    # and one shape the JAX package sends to its grid forward (Sk x 256
    # lanes above 8192 x 128)
    tuning_fwd = [_fwd_case(128, sq, sk, d, gen, timed=True)
                  for sq, sk, d in TUNING_SITES]
    tuning_fwd.append(_fwd_case(256, 257, 257, 80, gen, timed=True))
    grid = _fwd_case(2, 8192, 8192, 160, gen, timed=True)
    tuning_bwd = [_bwd_case(128, sq, sk, d, gen, timed=True)
                  for sq, sk, d in TUNING_SITES]
    # a shape the JAX package sends to its blocked backward grids
    # (Sq x 256 lanes above 4096 x 128)
    grid_bwd = _bwd_case(2, 8192, 8192, 160, gen, timed=True)
    ragged = [_fwd_case(4, 300, 200, 40, gen, timed=False)]
    for d, sq, sk in ((8, 65, 33), (24, 100, 130), (64, 128, 257),
                      (80, 70, 90), (120, 257, 257), (136, 200, 77),
                      (256, 129, 300)):
        ragged.append(_fwd_case(2, sq, sk, d, gen, timed=False))
    for d, sq, sk in ((8, 65, 33), (24, 100, 130), (64, 128, 257),
                      (120, 257, 77), (136, 200, 90), (256, 129, 300)):
        ragged.append(_bwd_case(2, sq, sk, d, gen, timed=False))
    cases = {"sampling": sampling, "tuning_fwd": tuning_fwd, "grid": grid,
             "tuning_bwd": tuning_bwd, "grid_bwd": grid_bwd,
             "ragged": ragged}
    print(json.dumps({"phase": "kernels", **cases}))
    return cases


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


# the kernels line's rows: the forward wrapper counts its d < 128 launches
# (_flash_fwd_lowdim) and its d >= 128 launches (_flash_fwd_kvres and
# _flash_fwd) apart
KERNEL_ROWS = ("flash_fwd_lowdim", "flash_fwd_wide", "flash_bwd")


def _reset_launches():
    from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    flash_fwd.launches = {"lowdim": 0, "wide": 0}
    flash_bwd.launches = 0


def _read_launches():
    from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    return {"flash_fwd_lowdim": flash_fwd.launches["lowdim"],
            "flash_fwd_wide": flash_fwd.launches["wide"],
            "flash_bwd": flash_bwd.launches}


def _sample(pipe, image, scheduler_type, seed=0):
    import numpy as np
    import torch

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe(PROMPTS, image, num_inference_steps=STEPS,
                  guidance_scale=7.5, num_images_per_prompt=IMAGES_PER_PROMPT,
                  height=RESOLUTION, width=RESOLUTION, seed=seed,
                  scheduler_type=scheduler_type)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    if images.shape != (n, 3, RESOLUTION, RESOLUTION):
        fail(f"{scheduler_type}: output shape {images.shape}")
    if not np.isfinite(images).all():
        fail(f"{scheduler_type}: non-finite images")
    if images.min() < 0.0 or images.max() > 1.0:
        fail(f"{scheduler_type}: images outside [0, 1]")
    # 10 low-dim flash sites per UNet forward at batch >= 5, two forwards
    # a step; the d=160 sites stay on einsum below the 128 MiB threshold
    want = {"flash_fwd_lowdim": 20 * STEPS, "flash_fwd_wide": 0,
            "flash_bwd": 0}
    if launches != want:
        fail(f"{scheduler_type}: launches {launches}, expected {want}")
    return images, seconds, launches


def _profile(run):
    """Device time by kernel over one call of ``run`` (wall time is taken
    under the profiler, so the busy share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            # host ops, and annotated ranges such as the optimizer step:
            # their device time is that of the kernels they hold
            continue
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

    from e4t_diffusion_torch.ops.attention import flash_threshold

    unet = pipe.modules.unet
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    x = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    ctx = torch.randn(n, 77, 768, device="cuda", generator=gen)
    t = torch.full((n,), 500, device="cuda")
    with torch.inference_mode():
        eps_kernel = unet(x, t, ctx).float()
        with flash_threshold(1 << 62):
            eps_plain = unet(x, t, ctx).float()
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
    prof = _profile(lambda: pipe(
        PROMPTS, image, num_inference_steps=STEPS, guidance_scale=7.5,
        num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
        width=RESOLUTION, seed=0))
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
        "launches": [launches, launches2, dpm_launches],
        "profile": prof}))
    return launches


def _expected_tuning_launches(ucfg, vit_cfg, resolution):
    """Launches per tuning step, derived from the attention sites. Every
    site whose query has >= FLASH_MIN_SEQ tokens goes to flash (the step
    is all-flash); the tap pass runs the down and mid blocks, the full
    pass every block; whole-UNet remat runs each pass's forward twice,
    its backward once. The frozen ViT runs forward only."""
    from e4t_diffusion_torch.models.weight_offsets import attention_sites
    from e4t_diffusion_torch.ops.attention import FLASH_MIN_SEQ
    from e4t_diffusion_torch.ops.flash_lowdim import launch_route

    side, levels = resolution // 8, len(ucfg.block_out_channels)
    want = dict.fromkeys(KERNEL_ROWS, 0)
    for path, dim, _ in attention_sites(ucfg):
        block, index = path.split(".")[:2]
        if block == "up_blocks":
            level, passes = levels - 1 - int(index), 1
        else:
            level = int(index) if block == "down_blocks" else levels - 1
            passes = 2
        if (side >> level) ** 2 < FLASH_MIN_SEQ:
            continue
        d = dim // ucfg.attention_head_dim
        want[f"flash_fwd_{launch_route(d)}"] += 2 * passes
        want["flash_bwd"] += passes
    if vit_cfg.grid ** 2 + 1 >= FLASH_MIN_SEQ:
        want["flash_fwd_lowdim"] += vit_cfg.num_layers
    return want


def phase_tuning(smi):
    """Phase-2 tuning at full width through ``tuning_e4t.tune`` with the
    CLI's defaults (batch 16, 512px, lr 1.6e-5, clip 1.0) and bf16."""
    import numpy as np
    import torch

    from e4t_diffusion_torch import tuning_e4t
    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training.setup import resolve_class_token
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    def cli_args(steps):
        return tuning_e4t.parse_args([
            "--pretrained_model_name_or_path", "-", "--train_image_path",
            "-", "--max_train_steps", str(steps), "--mixed_precision",
            "bf16"])

    args = cli_args(TUNING_STEPS)
    ucfg, ecfg = UNetConfig(), E4TEncoderConfig()
    torch.manual_seed(0)
    t0 = time.perf_counter()
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
        0, 256, (args.resolution, args.resolution, 3), dtype=np.uint8)
    setup_s = time.perf_counter() - t0

    def sums(tensors, dtype=None):
        return torch.stack([(t if dtype is None else t.to(dtype))
                            .double().sum() for t in tensors])

    e4t = modules.e4t_encoder
    head = [p for n, p in e4t.named_parameters()
            if not n.startswith("clip_vision.")]
    before = {
        "unet": sums(modules.unet.parameters()), "e4t": sums(head),
        "offsets": sums(offsets.values()),
        # frozen modules are cast to bf16 by the trainer
        "vit": sums(e4t.clip_vision.parameters(), torch.bfloat16),
        "vae": sums(modules.vae.parameters(), torch.bfloat16)}
    templates = resolve_templates("normal")

    def run(run_args):
        return tuning_e4t.tune(run_args, modules, offsets, tokenizer, "*s",
                               templates, class_id, image,
                               NoiseScheduleConfig(), torch.bfloat16)

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()

    trained = result["trainable"]
    after = {"unet": sums(trained["unet"].values()),
             "e4t": sums(trained["e4t"].values()),
             "offsets": sums(trained["offsets"].values()),
             "vit": sums(e4t.clip_vision.parameters()),
             "vae": sums(modules.vae.parameters())}
    metrics = result["metrics"]
    if len(metrics) != TUNING_STEPS or not all(
            math.isfinite(m[k]) for m in metrics
            for k in ("loss", "loss_diff", "loss_reg", "grad_norm")):
        fail(f"tuning: non-finite or missing metrics {metrics}")
    for group in ("unet", "e4t", "offsets"):
        if torch.equal(before[group], after[group]):
            fail(f"tuning: trainable group {group} did not change")
    for group in ("vit", "vae"):
        if not torch.equal(before[group], after[group]):
            fail(f"tuning: frozen group {group} changed")
    per_step = _expected_tuning_launches(ucfg, ecfg.vit, args.resolution)
    want = {k: TUNING_STEPS * v for k, v in per_step.items()}
    if launches != want:
        fail(f"tuning: launches {launches}, expected {want} "
             f"({per_step} per step)")
    steady = result["step_seconds"][1:]
    s_per_step = sum(steady) / len(steady)
    prof = _profile(lambda: run(cli_args(1)))
    print(json.dumps({
        "phase": "tuning", "card": smi, "setup_s": setup_s,
        "batch": args.train_batch_size, "resolution": args.resolution,
        "steps": TUNING_STEPS, "wall_s": wall,
        "trainable_params": sum(t.numel() for g in trained.values()
                                for t in g.values()),
        "step_seconds": result["step_seconds"], "s_per_step": s_per_step,
        "samples_per_s": args.train_batch_size / s_per_step,
        "max_memory_allocated_gb": peak / 1e9, "metrics": metrics,
        "launches": launches, "launches_per_step": per_step,
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

    timings = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        timings[name] = time.perf_counter() - t0
        print(json.dumps({"phase_done": name, "wall_s": timings[name]}),
              flush=True)
        return out

    smi = run("environment", phase_environment)
    run("build", phase_build)
    cases = run("kernels", phase_kernels)
    sampling = run("sampling", phase_main_path, smi)
    torch.cuda.empty_cache()
    tuning = run("tuning", phase_tuning, smi)
    torch.cuda.empty_cache()
    run("tiny_card_vs_cpu", phase_tiny_vs_cpu)

    fwd_cases = cases["sampling"] + cases["tuning_fwd"] + [cases["grid"]] + [
        c for c in cases["ragged"] if c["kernel"] != "flash_bwd"]
    bwd_cases = cases["tuning_bwd"] + [cases["grid_bwd"]] + [
        c for c in cases["ragged"] if c["kernel"] == "flash_bwd"]
    timed_keys = ("bh", "sq", "sk", "d", "ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms")

    def entry(name, source, replaces, site, errors, per_site):
        return {
            "name": name, "route": "cuda",
            "source": f"e4t_diffusion_torch/csrc/{source}",
            "replaces": f"e4t_diffusion_tpu/ops/flash_kernels.py:{replaces}",
            "launches": sampling[name] + tuning[name],
            "launches_by_path": {"sampling": sampling[name],
                                 "tuning": tuning[name]},
            "max_abs_err": max(errors), "ms": site["ms"],
            "plain_ms": site["plain_ms"], "bound_ms": site["bound_ms"],
            "bound_by": site["bound_by"], "library_ms": site["library_ms"],
            "at": f"BH={site['bh']} Sq={site['sq']} Sk={site['sk']} "
                  f"D={site['d']} bf16",
            "per_site": [{k: c[k] for k in timed_keys} for c in per_site]}

    low = [c for c in fwd_cases if c["kernel"] == "flash_fwd_lowdim"]
    wide = [c for c in fwd_cases if c["kernel"] == "flash_fwd_wide"]
    kernels = [
        entry("flash_fwd_lowdim", "flash_fwd_lowdim.cu", 286,
              cases["sampling"][0], [c["out_max_abs"] for c in low],
              [c for c in low if "ms" in c]),
        entry("flash_fwd_wide", "flash_fwd_lowdim.cu", 196,
              next(c for c in cases["tuning_fwd"] if c["sq"] == c["sk"]
                   and c["d"] >= 128),
              [c["out_max_abs"] for c in wide],
              [c for c in wide if "ms" in c]),
        entry("flash_bwd", "flash_bwd.cu", 503, cases["tuning_bwd"][0],
              [c[f"{g}_max_abs"] for c in bwd_cases
               for g in ("dq", "dk", "dv")],
              cases["tuning_bwd"] + [cases["grid_bwd"]])]
    kernels[1]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:95"
    kernels[2]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:582"
    print(json.dumps({"phase_seconds": timings}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
