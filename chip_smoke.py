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
5. int8_sampling: the same pipeline serving the UNet in int8: static
   activation scales (calibrated on the first call) under DDIM and DPM++,
   then dynamic scales with the int8 attention kernel in "qk" and "qkpv"
   mode; the UNet's eps on the kernels against the same int8 path on the
   plain versions, and the int8 error against bf16;
6. routes_sampling: phase 4's pipeline with the two opt-in routes on,
   ``E4T_FUSED_GN=1`` (every UNet and VAE GroupNorm on the GroupNorm
   kernel) and ``E4T_SHORTSEQ_MH_ATTN=8`` (the ViT-H's 257-token sites on
   the short-sequence kernel): DDIM twice, the UNet's eps against the
   routes off;
7. tuning: phase-2 E4T tuning (``tuning_e4t.tune``, what the CLI runs
   after loading) at the same width, f32 trainables, bf16 compute, the
   reference defaults (batch 16, 512px), 3 steps;
8. routes_tuning: the same from the same weights with both routes on, 2
   steps, the first step's loss and grad norm against phase 7's;
9. the tiny pipeline on the card against the same pipeline on the CPU, in
   f32, in static int8 and in f32 with ``E4T_FUSED_GN=1``;
10. f32_sampling: phase 4's pipeline in f32 (``--dtype fp32``, the f32
   attention kernels), DDIM twice, the UNet's eps on the kernels against
   the same pass on their plain versions; one UNet pass with the int8
   attention in f32 in each mode and one ViT-H encode with the
   short-sequence route on, each against its plain version;
11. f32_tuning_vs_cpu: one ``tuning_e4t.tune`` step of the tiny configs
   with ``--mixed_precision no`` at 64px (1024 and 256 latent tokens reach
   the f32 flash kernels) on the card and on the CPU, the same random draws
   on both: loss and per-group gradients against each other;
12. f32_tuning: one full-width step with ``--mixed_precision no`` at the
   largest batch of 16, 8 and 4 that the card holds.
In phases 4 to 8, 10 and 12 the kernels' launch counters, set to 0 just
before each run and read just after, must show the path went through every
kernel it routes to, as many times as its attention, conv and GroupNorm
sites give. The two routes are off by default, and off in every other
phase but where phase 10 names one.

The second-to-last line of output is a JSON ``kernels`` record, the last
``{"ok": true, "device": {...}}``.
"""
import contextlib
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
# the calibrated activation ranges, card vs CPU, relative to each site's
# range (a few f32 steps of summation-order drift; 1e-5 holds on the CPU
# against JAX)
TINY_AMAX_REL = 1e-5
# int8 runs of the same inputs on two f32 implementations differ where an
# ulp moves a value across an int8 rounding boundary, and the difference
# grows downstream; it stays below the int8 error itself
INT8_SPREAD_OF_ERROR = 1.0
# int8 attention kernel against its plain version on the same int8
# operands: bf16 output rounding, and exp2 against exp moving a few
# round(p * 127) by one in "qkpv"
INT8_FLASH_REL_L2 = 1e-2
# the UNet's eps with an int8 kernel vs the same path on its plain version:
# the conv kernel is exact, so its int8 UNet is held to this too; the
# attention kernel rounds its bf16 output apart from the plain version's,
# which a downstream int8 site amplifies to the size of the int8 error
# itself (0.058 against an int8 error of 0.052, measured), so it is held on
# the otherwise bf16 UNet, where it rounds as the bf16 flash kernel does
# against einsum (0.012, measured)
UNET_INT8_PLAIN_REL_L2 = 2e-2
# int8 against bf16, eps and final latents: PTQ error is a few percent; a
# wrong scale or layout gives O(1)
INT8_VS_BF16_REL_L2 = 0.25
# GroupNorm kernel against its f32 plain version: bf16 output rounding
# (rel-L2 ~2e-3); in f32 only the order of the f32 sums differs
GN_BF16_REL_L2 = 1e-2
GN_F32_MAX_ABS = 1e-4
# the UNet's eps with both opt-in routes on vs off uses UNET_ROUTE_REL_L2:
# the GroupNorm kernel and ATen's group_norm round their bf16 outputs apart
# the first tuning step's loss and grad norm with both routes on vs off,
# same weights and data: bf16 rounding apart at 61 GroupNorm sites a pass
# and the ViT's 32 attention sites
TUNING_ROUTE_REL = 5e-2
# the knobs and the values the opt-in phases set
ROUTE_KNOBS = {"E4T_FUSED_GN": "1", "E4T_SHORTSEQ_MH_ATTN": "8"}
# f32 attention kernels against their plain versions in f32 on the same
# f32 inputs (out, lse, dq, dk, dv, rel-L2): full f32 FFMA on both sides,
# the sums taken in another order
KERNEL_F32_REL_L2 = 1e-5
# the UNet's eps in f32 with its flash sites on the f32 kernel vs on the
# kernel's plain version, same weights and inputs; and the ViT-H's tokens
# with its attention sites on the f32 short-sequence kernel vs on einsum:
# f32 sums in another order, carried through the network
F32_PATH_REL_L2 = 1e-4
# one tiny f32 tuning step, card vs CPU, the same draws: the loss to the
# JAX parity tests' 1e-5 (relative), every trainable group's gradient to
# their 1e-4 (rel-L2)
TUNING_LOSS_REL = 1e-5
TUNING_GRAD_REL_L2 = 1e-4
# the tiny VAE halves the image once: 1024 latent tokens at level 0, 256 at
# the mid block, all >= FLASH_MIN_SEQ
TINY_TUNING_RESOLUTION = 64
# full-width f32 tuning: the largest of these batches the card holds
F32_TUNING_BATCHES = (16, 8, 4)

STEPS = 4
PROMPTS = ["a photo of *s", "a *s face in monet style"]
IMAGES_PER_PROMPT = 4
RESOLUTION = 512
TUNING_STEPS = 3

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# flop/s, f32 flop/s; exp2 on the special-function units: 16 per clock per SM (CUDA C++
# Programming Guide throughput table, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# f32 on the CUDA cores (FFMA), outside the tensor cores
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
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


# profiler sessions that came back with no device record, and device_time
# calls that fell back to CUDA events after three of them (printed with the
# phase times)
PROFILER_EMPTY = {"sessions": 0, "sessions_without_host_events": 0,
                  "events_fallbacks": 0}


def _note_empty(prof):
    PROFILER_EMPTY["sessions"] += 1
    if not len(prof.events()):
        PROFILER_EMPTY["sessions_without_host_events"] += 1


def device_time(fn, reps=20):
    """(ms, how): the device time of one call, the kernels' device time
    summed under ``torch.profiler`` over ``reps`` calls (after one warm-up),
    over ``reps`` (how "device"). A small kernel's CUDA-event time around
    one call is its launch overhead on the host; this is the time the card
    spends. Now and then a session comes back with no device record at all
    (seen on the H100 machine in PR 7 once a run, and in three sessions in a
    row in PR 11): such a session is measured again, and after three empty
    ones the time is taken by CUDA events around ``reps`` calls in a row,
    over ``reps`` (how "events_batch": the kernels queue behind each other,
    so this is device time where a launch takes less host time than a
    kernel takes on the card, and an upper bound on it elsewhere). An empty
    session is never a time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(evt.self_device_time_total for evt in prof.key_averages()
                 if evt.device_type == DeviceType.CUDA
                 and not getattr(evt, "is_user_annotation", False))
        if us > 0:
            return us / reps / 1e3, "device"
        _note_empty(prof)
    PROFILER_EMPTY["events_fallbacks"] += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events_batch"


def device_ms(fn, reps=20):
    """``device_time``'s milliseconds."""
    return device_time(fn, reps)[0]


def small_aware_ms(fn, floor_ms=0.1):
    """(ms, how): the device time (``device_time``) where it is below
    ``floor_ms`` (a CUDA-event time around one call there is the host's
    launch time), else CUDA events around one call, median of 20."""
    ms, how = device_time(fn)
    return (ms, how) if ms < floor_ms else (cuda_time_ms(fn), "events")


def _traced(run):
    """(prof, wall_us, traced): ``run`` once under ``torch.profiler``,
    again (up to three sessions) while a session holds no device record;
    ``traced`` is False when all three were empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if any(evt.device_type == DeviceType.CUDA
               and evt.self_device_time_total > 0
               for evt in prof.key_averages()):
            return prof, wall_us, True
        _note_empty(prof)
    return prof, wall_us, False


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
    from e4t_diffusion_torch.ops import (_build, flash_bwd, flash_int8,
                                         flash_lowdim, groupnorm, int8_conv,
                                         quant, shortseq)

    sources = [flash_lowdim.SOURCE, flash_bwd.SOURCE, flash_int8.SOURCE,
               int8_conv.SOURCE, groupnorm.SOURCE, shortseq.SOURCE,
               flash_lowdim.F32_SOURCE, quant.QUANTIZE_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - t0
    usage = {}
    for src, log in zip(sources, logs):
        usage[src], name = [], "?"
        for ln in log.splitlines():
            m = re.search(r"\d((?:flash|int8|group_norm|shortseq|attn|quantize)"
                          r"[a-z0-9_]*?_kernel)I(\w+?)E[Ev]", ln)
            if m:
                args = re.findall(r"L[a-z](\d+)E", m.group(2) + "E")
                name = f"{m.group(1)}<{','.join(args) or m.group(2)}>"
            elif "registers" in ln or re.search(
                    r"(?<!\d)[1-9]\d* bytes spill", ln):
                usage[src].append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    print(json.dumps({"phase": "build", "sources": sources,
                      "seconds": round(seconds, 3), "ptxas": usage}))
    # the wgmma kernels and the register-blocked f32 ones (attn_f32_*) hold
    # their accumulators in registers: a spill would move them through local
    # memory on every tile; the GroupNorm kernels stream every element
    # through registers
    spills = [u for lines in usage.values() for u in lines
              if ("wgmma" in u or u.startswith(("attn_f32_", "group_norm")))
              and "spill" in u]
    if spills:
        fail(f"ptxas spills in the wgmma, f32 or GroupNorm kernels: "
             f"{spills}")


def _bound(n_bytes, flops, exps, int8_ops=0, flop_rate=BF16_FLOP_PER_S):
    """The least time of the work on the card: bytes over the memory rate
    against the larger of the products' time (flops over ``flop_rate``, the
    bf16 tensor cores' or the f32 CUDA cores', plus int8 operations over the
    int8 rate) and exponentials over the special-function units' rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flop_rate + int8_ops / INT8_OP_PER_S,
                exps / EXP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": n_bytes, "flops": flops, "int8_ops": int8_ops,
            "exps": exps}


def _rel(a, b):
    return ((a.float() - b).norm() / b.norm()).item()


def _f32(dtype):
    import torch

    return dtype == torch.float32


def _fwd_case(bh, sq, sk, d, gen, timed, dtype=None):
    """The forward kernel of ``dtype`` (bf16 by default, or f32) against its
    plain version in f32, and against the synchronous design it replaced,
    within the same bound (bf16: the wgmma kernel against
    ``flash_fwd_sync``; f32: the register-blocked kernel against
    ``flash_fwd_f32_sync``, out and lse); timed: kernel, plain, SDPA's
    forward in the same type, the bound, and the synchronous design
    (``parent_ms``)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops.flash_lowdim import (
        flash_fwd, flash_fwd_f32_sync, flash_fwd_reference, flash_fwd_sync,
        launch_route)

    dtype = dtype or torch.bfloat16
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
               .to(dtype) for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_fwd_reference(q.float(), k.float(), v.float(),
                                           scale)
    rel = _rel(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    case = {"kernel": f"flash_fwd_{launch_route(d, dtype)}", "bh": bh,
            "sq": sq, "sk": sk, "d": d, "dtype": str(dtype)[6:],
            "out_rel_l2": rel,
            "out_max_abs": (out.float() - ref_out).abs().max().item(),
            "lse_rel_l2": _rel(lse, ref_lse), "lse_max_abs": lse_err}
    del ref_out, ref_lse
    ok = (max(rel, case["lse_rel_l2"]) <= KERNEL_F32_REL_L2 if _f32(dtype)
          else rel <= KERNEL_OUT_REL_L2 and lse_err <= KERNEL_LSE_MAX_ABS)
    if not ok:
        fail(f"flash_fwd disagrees with its plain version: {case}")
    f32 = _f32(dtype)
    sync = flash_fwd_f32_sync if f32 else flash_fwd_sync
    parent, parent_lse = sync(q, k, v, scale)
    case["parent_out_vs_kernel_rel_l2"] = _rel(parent, out.float())
    if f32:
        case["parent_lse_vs_kernel_rel_l2"] = _rel(parent_lse, lse)
    del parent, parent_lse
    if max(case["parent_out_vs_kernel_rel_l2"],
           case.get("parent_lse_vs_kernel_rel_l2", 0.0)) > (
               KERNEL_F32_REL_L2 if f32 else KERNEL_OUT_REL_L2):
        fail(f"flash_fwd disagrees with the synchronous design: {case}")
    if timed:
        size = q.element_size()
        case.update(
            ms=cuda_time_ms(lambda: flash_fwd(q, k, v, scale)),
            plain_ms=cuda_time_ms(lambda: flash_fwd_reference(
                q.float(), k.float(), v.float(), scale),
                reps=3 if _f32(dtype) else 20),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale)),
            **_bound(size * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq,
                     4 * bh * sq * sk * d, bh * sq * sk,
                     flop_rate=F32_FLOP_PER_S if _f32(dtype)
                     else BF16_FLOP_PER_S),
            parent_ms=cuda_time_ms(lambda: sync(q, k, v, scale)))
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return case


def _bwd_case(bh, sq, sk, d, gen, timed, dtype=None):
    """The backward kernel of ``dtype`` (bf16 by default, or f32), fed by
    the forward kernel's (out, lse), against ``flash_bwd_reference`` in f32
    on the same inputs; timed: kernel, plain, SDPA's backward through
    autograd with the same dO in the same type, the bound.
    The bound counts the work (dq, dk, dv) needs, whatever the kernel's
    design does: five products (S, dP, dq, dk, dv), 10 flops per score
    element and head dim, and one exponential per score.
    Also: a second call bit for bit against the first (no atomics), and the
    synchronous design the kernels replaced (``flash_bwd_sync`` in bf16,
    ``flash_bwd_f32_sync`` in f32) against the kernel, within the same
    bound, and timed beside it (``parent_ms``)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops.flash_bwd import (flash_bwd,
                                                   flash_bwd_f32_sync,
                                                   flash_bwd_reference,
                                                   flash_bwd_sync)
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    dtype = dtype or torch.bfloat16
    q, k, v, dout = (torch.randn(bh, s, d, device="cuda", generator=gen)
                     .to(dtype) for s in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd(q, k, v, scale)
    grads = flash_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, out, dout)]

    def plain():
        return flash_bwd_reference(*f32[:4], lse, f32[4], scale)

    refs = plain()
    case = {"kernel": "flash_bwd_f32" if _f32(dtype) else "flash_bwd",
            "bh": bh, "sq": sq, "sk": sk, "d": d, "dtype": str(dtype)[6:]}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        case[f"{name}_rel_l2"] = _rel(g, r)
        case[f"{name}_max_abs"] = (g.float() - r).abs().max().item()
    del refs
    if max(case[f"{n}_rel_l2"] for n in ("dq", "dk", "dv")) > (
            KERNEL_F32_REL_L2 if _f32(dtype) else KERNEL_GRAD_REL_L2):
        fail(f"flash_bwd disagrees with its plain version: {case}")
    sync = flash_bwd_f32_sync if _f32(dtype) else flash_bwd_sync
    again = flash_bwd(q, k, v, out, lse, dout, scale)
    case["repeat_identical"] = all(torch.equal(a, b)
                                   for a, b in zip(grads, again))
    parent = sync(q, k, v, out, lse, dout, scale)
    for name, g, p in zip(("dq", "dk", "dv"), grads, parent):
        case[f"parent_{name}_rel_l2"] = _rel(g, p.float())
    del again, parent
    if not case["repeat_identical"]:
        fail(f"flash_bwd: two calls on the same inputs differ: {case}")
    if max(case[f"parent_{n}_rel_l2"] for n in ("dq", "dk", "dv")) > (
            KERNEL_F32_REL_L2 if _f32(dtype) else KERNEL_GRAD_REL_L2):
        fail(f"flash_bwd disagrees with the synchronous design: {case}")
    if timed:
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qr[None], kr[None], vr[None], scale=scale)
        case.update(
            ms=cuda_time_ms(lambda: flash_bwd(q, k, v, out, lse, dout,
                                              scale)),
            plain_ms=cuda_time_ms(plain, reps=3 if _f32(dtype) else 20),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qr, kr, vr), dout[None], retain_graph=True)),
            **_bound(q.element_size() * (4 * bh * sq * d + 4 * bh * sk * d)
                     + 4 * bh * sq, 10 * bh * sq * sk * d, bh * sq * sk,
                     flop_rate=F32_FLOP_PER_S if _f32(dtype)
                     else BF16_FLOP_PER_S),
            parent_ms=cuda_time_ms(lambda: sync(q, k, v, out, lse, dout,
                                                scale)))
        del qr, kr, vr, lib_out
    del q, k, v, dout, out, lse, grads, f32
    torch.cuda.empty_cache()
    return case


def _int8_flash_case(bh, sq, sk, d, mode, gen, timed, dtype=None):
    """The int8 attention kernel against its plain version at the route's
    kv tile (``flash_int8.quant_tile``), on int8 operands quantized from
    q/k/v in ``dtype`` (bf16 by default, or f32: the f32 output, and in
    "qk" an f32 v) as the attention route does; timed: kernel, plain, the
    route (quantization + kernel), SDPA's forward on the q/k/v (kernel,
    synchronous design and SDPA by device time where it is under 0.1 ms,
    ``small_aware_ms``), and the bound of the kernel's work from the int8
    operands. In f32, "qk" is held
    to KERNEL_F32_REL_L2; "qkpv" to INT8_FLASH_REL_L2 in both types (exp2
    against exp moves a few round(p * 127) by one). The kernel is held
    against its synchronous design (``flash_fwd_int8_sync``) within the same
    bound (lse within KERNEL_LSE_MAX_ABS), whether the two agree bit for bit
    is recorded, and it is timed beside the kernel (``parent_ms``)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import attention
    from e4t_diffusion_torch.ops import flash_int8 as fi

    dtype = dtype or torch.bfloat16
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
               .to(dtype) for s in (sq, sk, sk))
    k = k + 0.5  # keys with a channel mean, as the centring expects
    scale = 1.0 / math.sqrt(d)
    ops = attention.int8_attention_operands(q, k, v, scale, mode)
    out, lse = fi.flash_fwd_int8(*ops, mode, dtype)
    torch.cuda.synchronize()
    ref_out, ref_lse = fi.flash_fwd_int8_reference(*ops, mode, torch.float32)
    rel = _rel(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    key = fi.launch_key(mode, dtype)
    case = {"kernel": "flash_fwd_int8" + ("" if key == "bf16" else
                                          f"_{key}"),
            "mode": mode, "bh": bh, "sq": sq, "sk": sk, "d": d,
            "tile": fi.quant_tile(sk), "dtype": str(dtype)[6:],
            "out_rel_l2": rel,
            "out_max_abs": (out.float() - ref_out).abs().max().item(),
            "lse_max_abs": lse_err}
    del ref_out, ref_lse
    bound = (KERNEL_F32_REL_L2 if key == "qk_f32" else INT8_FLASH_REL_L2)
    if not (rel <= bound and lse_err <= KERNEL_LSE_MAX_ABS):
        fail(f"flash_fwd_int8 disagrees with its plain version: {case}")
    parent, parent_lse = fi.flash_fwd_int8_sync(*ops, mode, dtype)
    case["parent_out_vs_kernel_rel_l2"] = _rel(parent, out.float())
    case["parent_lse_max_abs"] = (parent_lse - lse).abs().max().item()
    case["parent_identical"] = torch.equal(parent, out)
    del parent, parent_lse
    if not (case["parent_out_vs_kernel_rel_l2"] <= bound
            and case["parent_lse_max_abs"] <= KERNEL_LSE_MAX_ABS):
        fail(f"flash_fwd_int8 disagrees with the synchronous design: "
             f"{case}")
    if timed:
        pv = mode == "qkpv"
        f32 = _f32(dtype)
        case["ms"], case["ms_by"] = small_aware_ms(
            lambda: fi.flash_fwd_int8(*ops, mode, dtype))
        case["parent_ms"], case["parent_ms_by"] = small_aware_ms(
            lambda: fi.flash_fwd_int8_sync(*ops, mode, dtype))
        case["library_ms"], case["library_ms_by"] = small_aware_ms(
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   scale=scale))
        case.update(
            plain_ms=cuda_time_ms(lambda: fi.flash_fwd_int8_reference(
                *ops, mode, torch.float32), reps=3),
            route_ms=cuda_time_ms(lambda: attention._int8_lowdim_path(
                q, k, v, scale, mode)),
            library=f"scaled_dot_product_attention, {case['dtype']}",
            **_bound(bh * sq * d + bh * sk * d * (2 if pv else
                                                  1 + q.element_size())
                     + 8 * bh + q.element_size() * bh * sq * d + 4 * bh * sq,
                     0 if pv else 2 * bh * sq * sk * d, bh * sq * sk,
                     int8_ops=(4 if pv else 2) * bh * sq * sk * d,
                     flop_rate=F32_FLOP_PER_S if f32 else BF16_FLOP_PER_S))
    del q, k, v, ops, out, lse
    torch.cuda.empty_cache()
    return case


def _unet_conv_shapes(batch, resolution):
    """{(C, O, H, W, k, stride, pad): sites} of the quantized UNet convs in
    one SD-v1 forward, read off a forward on the meta device."""
    import torch

    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.ops import quant

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig())
    quantized = quant.quantize_params(dict(unet.named_parameters()))
    shapes = {}

    def record(mod, args):
        x = args[0]
        key = (x.shape[1], mod.out_channels, x.shape[2], x.shape[3],
               mod.kernel_size[0], mod.stride[0], mod.padding[0])
        shapes[key] = shapes.get(key, 0) + 1

    for name, m in quant.site_modules(unet).items():
        if isinstance(m, quant.Conv2d) and name in quantized:
            m.register_forward_pre_hook(record)
    side = resolution // 8
    with torch.device("meta"):
        unet(torch.zeros(batch, 4, side, side), torch.zeros(batch),
             torch.zeros(batch, 77, unet.config.cross_attention_dim))
    return shapes


def _unet_linear_shapes(batch, resolution):
    """{input shape: sites} of the quantized UNet linear sites in one SD-v1
    forward, read off a forward on the meta device."""
    import torch

    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.ops import quant

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig())
    quantized = quant.quantize_params(dict(unet.named_parameters()))
    shapes = {}

    def record(mod, args):
        key = tuple(args[0].shape)
        shapes[key] = shapes.get(key, 0) + 1

    for name, m in quant.site_modules(unet).items():
        if isinstance(m, quant.Linear) and name in quantized:
            m.register_forward_pre_hook(record)
    side = resolution // 8
    with torch.device("meta"):
        unet(torch.zeros(batch, 4, side, side), torch.zeros(batch),
             torch.zeros(batch, 77, unet.config.cross_attention_dim))
    return shapes


def _conv_sites(site, x):
    """The conv site ``site`` (from ``quantize_kernel``, OHWI) in each scale
    mode: {"sa": static, "sac": per-channel (folded into its weight),
    "dynamic": the live scale}, calibrated on ``x``."""
    import torch

    from e4t_diffusion_torch.ops import quant

    ax = x.float().abs()
    amax_c = ax.amax(dim=(0, 2, 3))
    sac = amax_c ** 0.75 * torch.max(amax_c ** 0.25) / 127.0
    w = site["w"]
    pc = quant.quantize_kernel(w.float() * sac.reshape(1, -1, 1, 1))
    return {"sa": {"q": site["q"], "s": site["s"],
                   "sa": ax.amax() * 0.8 / 127.0},
            "sac": {"q": pc["q"].permute(0, 2, 3, 1).contiguous(),
                    "s": pc["s"], "sac": sac},
            "dynamic": {"q": site["q"], "s": site["s"]}}


def _conv_case(n, c, o, h, w, k, stride, pad, gen, timed, sites=None):
    """The int8 conv kernel against the synchronous design it replaced and
    its plain version, bf16 and f32 out; the conv site's route
    (``quant.int8_conv2d``: x quantized in the kernel's loads) against
    ``quantize_activation_reference`` + ``int8_conv_sync`` in each scale
    mode, x bf16 and f32 NCHW and bf16 channels-last: all bit for bit (the
    int32 sums are exact, the quantization and the epilogue round alike).
    Timed: the kernel, the yardstick (``parent_ms``), the plain version, the
    old route (PyTorch quantization, the NHWC permute, the kernel) and the
    route from a bf16 NCHW activation on a static scale, cuDNN's bf16
    conv2d of the same shapes, and the bounds of the kernel's work (int8 x)
    and of the route's (x read once in bf16)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    x = torch.randint(-127, 128, (n, h, w, c), device="cuda", generator=gen,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (o, k, k, c), device="cuda", generator=gen,
                       dtype=torch.int8)
    scale = torch.rand(o, device="cuda", generator=gen) * 1e-4
    bias = torch.randn(o, device="cuda", generator=gen)
    case = {"kernel": "int8_conv", "n": n, "c": c, "o": o, "h": h, "w": w,
            "k": k, "stride": stride, "pad": pad}
    if sites is not None:
        case["sites_per_unet_pass"] = sites
    for dtype in (torch.bfloat16, torch.float32):
        b = bias.to(dtype)
        out = ic.int8_conv(x, wt, scale, b, dtype, stride, pad)
        sync = ic.int8_conv_sync(x, wt, scale, b, dtype, stride, pad)
        torch.cuda.synchronize()
        ref = ic.int8_conv_reference(x, wt, scale, b, dtype, stride, pad)
        key = "out_max_abs" if dtype == torch.bfloat16 else "f32_out_max_abs"
        case[key] = (out.float() - ref.float()).abs().max().item()
        if not (torch.equal(out, ref) and torch.equal(out, sync)):
            fail(f"int8_conv ({dtype}) disagrees with int8_conv_sync or its "
                 f"plain version: {case}")
        del out, sync, ref
    xb = torch.randn(n, c, h, w, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    wb = torch.randn(o, c, k, k, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    site = quant.quantize_kernel(wb)
    site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
    site["w"] = wb
    modes = _conv_sites(site, xb)
    routes = [(dtype, "nchw", mode) for dtype in (torch.bfloat16,
                                                  torch.float32)
              for mode in modes] + [(torch.bfloat16, "nhwc", "sa")]
    for dtype, layout, mode in routes:
        xr = xb.to(dtype)
        if layout == "nhwc":
            xr = xr.contiguous(memory_format=torch.channels_last)
        s_, b = modes[mode], bias.to(dtype)
        got = quant.int8_conv2d(xr, s_, b, stride, pad)
        xq, sx = quant.quantize_activation_reference(xr, s_, 1)
        want = ic.int8_conv_sync(xq.permute(0, 2, 3, 1).contiguous(),
                                 s_["q"], (sx * s_["s"]).float(), b, dtype,
                                 stride, pad)
        if not torch.equal(got, want):
            fail(f"int8_conv_act ({dtype}, {layout}, {mode}) disagrees with "
                 f"quantize_activation_reference + int8_conv_sync: {case}")
        del xr, got, xq, want
    case["route_checks"] = len(routes)
    if timed:
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        b16 = bias.to(torch.bfloat16)
        static = modes["sa"]

        def old_route():
            xq, sx = quant.quantize_activation_reference(xb, static, 1)
            return ic.int8_conv(xq.permute(0, 2, 3, 1).contiguous(),
                                static["q"], (sx * static["s"]).float(), b16,
                                torch.bfloat16, stride, pad)

        ops = 2 * n * ho * wo * o * k * k * c
        out_bytes = 2 * n * o * ho * wo
        case.update(
            ms=cuda_time_ms(lambda: ic.int8_conv(x, wt, scale, b16,
                                                 torch.bfloat16, stride,
                                                 pad)),
            parent_ms=cuda_time_ms(lambda: ic.int8_conv_sync(
                x, wt, scale, b16, torch.bfloat16, stride, pad)),
            plain_ms=cuda_time_ms(lambda: ic.int8_conv_reference(
                x, wt, scale, b16, torch.bfloat16, stride, pad), reps=3),
            old_route_ms=cuda_time_ms(old_route),
            route_ms=cuda_time_ms(lambda: quant.int8_conv2d(
                xb, static, b16, stride, pad)),
            library_ms=cuda_time_ms(lambda: F.conv2d(
                xb, wb, b16, stride=stride, padding=pad)),
            library="torch.nn.functional.conv2d (cuDNN), bf16",
            route_bound_ms=_bound(2 * n * h * w * c + o * k * k * c + 6 * o
                                  + out_bytes, 0, 0,
                                  int8_ops=ops)["bound_ms"],
            **_bound(n * h * w * c + o * k * k * c + 6 * o + out_bytes, 0, 0,
                     int8_ops=ops))
    del x, wt, scale, bias, xb, wb, site, modes
    torch.cuda.empty_cache()
    return case


def _quantize_case(shape, gen, timed, sites=None):
    """The linear sites' quantization kernel (``quant.quantize_activation``)
    against its plain version at input ``shape`` (..., K), bit for bit, in
    each scale mode ("sa", "sac" along K, dynamic) for bf16 and f32 x, with
    exact half-way quotients among the inputs (they pin the rounding, half
    to even). Timed in bf16 on a static scale: kernel, plain version, and
    the bound (x read once, q written once)."""
    import torch

    from e4t_diffusion_torch.ops import quant

    k = shape[-1]
    x = torch.randn(shape, device="cuda", generator=gen)
    s = x.abs().amax() / 127.0
    # a quarter of the values at (j + 0.5) * s: the quotient's exact halves
    half = (torch.randint(-130, 130, shape, device="cuda", generator=gen)
            + 0.5) * s
    x = torch.where(torch.rand(shape, device="cuda", generator=gen) < 0.25,
                    half, x)
    sac = x.abs().amax(dim=tuple(range(x.dim() - 1))).clamp(min=1e-3) / 127.0
    modes = {"sa": {"sa": s}, "sac": {"sac": sac}, "dynamic": {}}
    case = {"kernel": "int8_quantize", "shape": list(shape), "k": k}
    if sites is not None:
        case["sites_per_unet_pass"] = sites
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        for mode, site in modes.items():
            q, sx = quant.quantize_activation(xd, site, -1)
            qr, sr = quant.quantize_activation_reference(xd, site, -1)
            if not (torch.equal(q, qr) and torch.equal(sx, sr)):
                fail(f"int8_quantize ({dtype}, {mode}) disagrees with its "
                     f"plain version: {case}")
    case["out_max_abs"] = 0.0
    if timed:
        xb = x.bfloat16()
        n_el = xb.numel()
        case.update(
            ms=small_aware_ms(lambda: quant.quantize_activation(
                xb, modes["sa"], -1))[0],
            plain_ms=small_aware_ms(lambda: quant.quantize_activation_reference(
                xb, modes["sa"], -1))[0],
            library_ms=None,
            **_bound(3 * n_el + 4, 0, 0))
    del x, half
    torch.cuda.empty_cache()
    return case


def _group_norm_sites(unet_config, vae_config, batch, resolution,
                      device="meta"):
    """{"unet", "unet_tap", "vae_decode", "vae_encode": {(C, H, W, groups,
    eps, act, layout): sites}}: the GroupNorm sites of one UNet pass (full,
    and the tap pass that stops after the mid block), one VAE decode and
    one VAE encode, read off forwards of bf16 models on ``device``.
    The layout ("nchw" or "nhwc", channels-last memory) is the one a site's
    input has on the card: the meta device does not carry it ("nchw")."""
    import torch

    from e4t_diffusion_torch.models import unet as unet_mod
    from e4t_diffusion_torch.models import vae as vae_mod

    with torch.device(device):
        unet = unet_mod.UNet2DConditionModel(unet_config).to(torch.bfloat16)
        vae = vae_mod.AutoencoderKL(vae_config).to(torch.bfloat16)
    plain = unet_mod.group_norm_act
    sites = {}
    current = {}

    def record(x, norm, act=None):
        key = (x.shape[1], x.shape[2], x.shape[3], norm.num_groups,
               norm.eps, act, "nchw" if x.is_contiguous() else "nhwc")
        current[key] = current.get(key, 0) + 1
        return plain(x, norm, act)

    side = resolution // 8
    runs = {
        "unet": lambda: unet(torch.zeros(batch, 4, side, side),
                             torch.zeros(batch), torch.zeros(
                                 batch, 77, unet_config.cross_attention_dim)),
        "unet_tap": lambda: unet(torch.zeros(batch, 4, side, side),
                                 torch.zeros(batch), torch.zeros(
                                     batch, 77,
                                     unet_config.cross_attention_dim),
                                 return_encoder_outputs=True),
        "vae_decode": lambda: vae.decode(torch.zeros(batch, 4, side, side)),
        "vae_encode": lambda: vae.encode(
            torch.zeros(batch, 3, resolution, resolution))}
    unet_mod.group_norm_act = vae_mod.group_norm_act = record
    try:
        for name, run in runs.items():
            current = sites[name] = {}
            with torch.device(device), torch.inference_mode():
                run()
    finally:
        unet_mod.group_norm_act = vae_mod.group_norm_act = plain
    del unet, vae
    return sites


def _gn_case(n, c, h, w, groups, eps, act, layout, dtype, gen, timed,
             sites=None):
    """The GroupNorm kernel against its plain version in f32 on the same
    input, in memory ``layout`` ("nchw", or "nhwc": channels-last), and
    against its first design (``group_norm_sync``, the yardstick) within
    the same bound; a second call must give the same bits. Timed (device
    time, and the kernel's and the library's CUDA-event time per call,
    ``wall_ms``): kernel, plain, ``F.group_norm`` (then ``F.silu``) with the
    same weights, the yardstick (``parent_ms``), and the bound: x read once,
    y written once."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import groupnorm as gn

    x = (torch.randn(n, c, h, w, device="cuda", generator=gen) * 2
         + 0.5).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    # the modules' parameters are in the compute dtype
    weight = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = (torch.randn(c, device="cuda", generator=gen) * 0.5).to(dtype)
    out = gn.fused_group_norm(x, weight, bias, groups, eps, act)
    again = gn.fused_group_norm(x, weight, bias, groups, eps, act)
    parent = gn.group_norm_sync(x, weight, bias, groups, eps, act)
    torch.cuda.synchronize()
    ref = gn.group_norm_reference(x.float(), weight, bias, groups, eps, act)
    case = {"kernel": "group_norm", "n": n, "c": c, "h": h, "w": w,
            "groups": groups, "act": act, "layout": layout,
            "dtype": str(dtype),
            "out_rel_l2": _rel(out, ref),
            "out_max_abs": (out.float() - ref).abs().max().item(),
            "parent_out_vs_kernel_rel_l2": _rel(out, parent.float()),
            "parent_out_vs_kernel_max_abs": (
                out.float() - parent.float()).abs().max().item(),
            "parent_identical": torch.equal(out, parent),
            "rerun_identical": torch.equal(out, again)}
    if sites is not None:
        case["sites"] = sites
    del ref, again, parent
    bf16 = dtype == torch.bfloat16
    for ref_name, rel, max_abs in (
            ("its plain version", "out_rel_l2", "out_max_abs"),
            ("its first design", "parent_out_vs_kernel_rel_l2",
             "parent_out_vs_kernel_max_abs")):
        if not (case[rel] <= GN_BF16_REL_L2 if bf16
                else case[max_abs] <= GN_F32_MAX_ABS):
            fail(f"group_norm disagrees with {ref_name}: {case}")
    if not case["rerun_identical"]:
        fail(f"group_norm: two calls on one input differ: {case}")
    if timed:
        def kernel():
            return gn.fused_group_norm(x, weight, bias, groups, eps, act)

        def library():
            y = F.group_norm(x, groups, weight, bias, eps)
            return F.silu(y) if act == "silu" else y

        case.update(
            ms=device_ms(kernel), wall_ms=cuda_time_ms(kernel),
            plain_ms=device_ms(lambda: gn.group_norm_reference(
                x.float(), weight, bias, groups, eps, act), reps=3),
            library_ms=device_ms(library), library_wall_ms=cuda_time_ms(
                library),
            parent_ms=device_ms(lambda: gn.group_norm_sync(
                x, weight, bias, groups, eps, act)),
            library="F.group_norm then F.silu, bf16",
            **_bound(2 * x.numel() * x.element_size()
                     + 2 * c * weight.element_size(), 0, 0))
    del x, out
    torch.cuda.empty_cache()
    return case


def _shortseq_case(bh, s, d, g, gen, timed, dtype=None):
    """The short-sequence kernel of ``dtype`` (bf16 by default, or f32)
    against its plain version in f32 on the same inputs, and against the
    synchronous design it replaced (``flash_fwd_shortseq_sync``,
    ``flash_fwd_shortseq_f32_sync``), within the same bound, with whether
    the two agree bit for bit; timed (device time, and CUDA-event time per
    call, ``wall_ms``): kernel, plain, SDPA's forward in the same type, the
    bound of the work (as for the flash forward), and the synchronous
    design (``parent_ms``)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import shortseq

    dtype = dtype or torch.bfloat16
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out = shortseq.flash_fwd_shortseq(q, k, v, scale, g)
    torch.cuda.synchronize()
    ref = shortseq.flash_fwd_shortseq_reference(q.float(), k.float(),
                                                v.float(), scale)
    case = {"kernel": "flash_fwd_shortseq" + ("_f32" if _f32(dtype) else ""),
            "bh": bh, "sq": s, "sk": s, "d": d, "g": g,
            "dtype": str(dtype)[6:], "out_rel_l2": _rel(out, ref),
            "out_max_abs": (out.float() - ref).abs().max().item()}
    del ref
    if not case["out_rel_l2"] <= (KERNEL_F32_REL_L2 if _f32(dtype)
                                  else KERNEL_OUT_REL_L2):
        fail(f"flash_fwd_shortseq disagrees with its plain version: {case}")
    sync = (shortseq.flash_fwd_shortseq_f32_sync if _f32(dtype)
            else shortseq.flash_fwd_shortseq_sync)
    parent = sync(q, k, v, scale, g)
    case["parent_out_vs_kernel_rel_l2"] = _rel(parent, out.float())
    case["parent_identical"] = torch.equal(parent, out)
    del parent
    if case["parent_out_vs_kernel_rel_l2"] > (
            KERNEL_F32_REL_L2 if _f32(dtype) else KERNEL_OUT_REL_L2):
        fail(f"flash_fwd_shortseq disagrees with the synchronous design: "
             f"{case}")
    if timed:
        def kernel():
            return shortseq.flash_fwd_shortseq(q, k, v, scale, g)

        def library():
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  scale=scale)

        case.update(
            ms=device_ms(kernel), wall_ms=cuda_time_ms(kernel),
            plain_ms=device_ms(lambda: shortseq.flash_fwd_shortseq_reference(
                q.float(), k.float(), v.float(), scale)),
            library_ms=device_ms(library), library_wall_ms=cuda_time_ms(
                library),
            **_bound(q.element_size() * 4 * bh * s * d, 4 * bh * s * s * d,
                     bh * s * s, flop_rate=F32_FLOP_PER_S if _f32(dtype)
                     else BF16_FLOP_PER_S),
            parent_ms=device_ms(lambda: sync(q, k, v, scale, g)))
    del q, k, v, out
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
                      (256, 129, 300),
                      # the wgmma forward from DK 160 at the edges of its
                      # k/v rings (4 stages at DK 160, 3 at 192 and 224, 2
                      # at 256): Sk below one 64-row stage, one stage plus
                      # one row, one q row
                      (160, 100, 63), (192, 64, 65), (256, 1, 200),
                      (136, 257, 129), (224, 200, 129), (256, 300, 65)):
        ragged.append(_fwd_case(2, sq, sk, d, gen, timed=False))
    for d, sq, sk in ((8, 65, 33), (24, 100, 130), (64, 128, 257),
                      (120, 257, 77), (136, 200, 90), (256, 129, 300),
                      # the wgmma backward's masks: Sq and Sk multiples of
                      # no tile, one q row
                      (40, 300, 77), (80, 129, 200), (40, 65, 257),
                      (80, 1, 130), (112, 100, 90),
                      # from DK 128: Sq (the dk/dv kernel's q/dO ring) and
                      # Sk (the dq kernel's k/v ring) below one 64-row tile,
                      # one tile plus one row, one q row, two kv rows (with
                      # one, dq is zero up to rounding: its rel-L2 is noise)
                      (160, 63, 65), (192, 65, 63), (256, 1, 130),
                      (224, 129, 300), (128, 200, 2), (136, 300, 77)):
        ragged.append(_bwd_case(2, sq, sk, d, gen, timed=False))
    # BH 48 at Sk 1000: the dk/dv kernel's blocks of several warpgroups at a
    # ragged Sk (with fewer heads or kv rows it takes 1 warpgroup a block)
    for d, sq in ((40, 300), (80, 129)):
        ragged.append(_bwd_case(48, sq, 1000, d, gen, timed=False))
    # int8 serving: the two low-dim flash sites in both modes, and every
    # distinct quantized conv of a batch-8 512px UNet forward
    int8_flash = [_int8_flash_case(64, s_, s_, d, mode, gen, timed=True)
                  for mode in ("qk", "qkpv")
                  for s_, d in ((4096, 40), (1024, 80))]
    for mode in ("qk", "qkpv"):
        # Sk 1100: quant tiles of 512 rows, the last one of 76
        for d, sq, sk in ((8, 65, 33), (40, 300, 200), (80, 128, 257),
                          (120, 70, 90), (40, 257, 1100)):
            ragged.append(_int8_flash_case(2, sq, sk, d, mode, gen,
                                           timed=False))
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    int8_conv = [_conv_case(n, *key, gen, timed=True, sites=sites)
                 for key, sites in sorted(
                     _unet_conv_shapes(n, RESOLUTION).items())]
    for c, o, h, w, k, stride, pad in ((48, 40, 9, 7, 3, 1, 1),
                                       (32, 72, 11, 10, 3, 2, 1),
                                       (16, 24, 5, 13, 1, 1, 0)):
        ragged.append(_conv_case(3, c, o, h, w, k, stride, pad, gen,
                                 timed=False))
    # the linear sites' quantization at every distinct input of a pass, and
    # at ragged widths (the one-element path)
    int8_quantize = [_quantize_case(shape, gen, timed=True, sites=sites)
                     for shape, sites in sorted(
                         _unet_linear_shapes(n, RESOLUTION).items())]
    for shape in ((3, 5, 36), (7, 40)):
        ragged.append(_quantize_case(shape, gen, timed=False))
    # the opt-in routes: every distinct GroupNorm site of a batch-8 512px
    # UNet pass and VAE decode, and the ViT-H's attention sites when
    # sampling (BH = 8 x 16 heads) and tuning (16 x 16)
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig

    # the sites' layouts as the card gives them at this batch (at batch 1
    # every UNet site is NCHW; from batch 2 most are channels-last)
    gn_sites = _group_norm_sites(UNetConfig(), VAEConfig(), n, RESOLUTION,
                                 "cuda")
    group_norm = {
        part: [_gn_case(n, c, h, w, groups, eps, act, layout, torch.bfloat16,
                        gen, timed=True, sites=count)
               for (c, h, w, groups, eps, act, layout), count in sorted(
                   gn_sites[part].items(), key=str)]
        for part in ("unet", "vae_decode")}
    torch.cuda.empty_cache()
    for n_, c, h, w, groups, act, layout, dtype in (
            (1, 32, 7, 9, 32, "silu", "nchw", torch.float32),  # C/G = 1
            (3, 40, 7, 9, 8, "silu", "nchw", torch.bfloat16),  # odd H*W
            (3, 40, 7, 9, 8, "silu", "nhwc", torch.bfloat16),  # C/G = 5
            (1, 96, 33, 33, 32, None, "nhwc", torch.bfloat16),  # C/G = 3
            (2, 64, 16, 16, 32, None, "nhwc", torch.float32),
            (1, 320, 64, 64, 32, "silu", "nchw", torch.float32),
            (1, 960, 64, 64, 32, "silu", "nhwc", torch.float32),
            # the cooperative channels-last kernel (x from 12 MB): pixels
            # of two and three channel chunks (the last a column short at
            # 2600 in f32), C/G = 4 at n = 16 with odd H*W
            (8, 2560, 32, 32, 32, "silu", "nhwc", torch.bfloat16),
            (2, 2600, 40, 40, 40, None, "nhwc", torch.float32),
            (16, 128, 63, 65, 32, "silu", "nhwc", torch.bfloat16)):
        ragged.append(_gn_case(n_, c, h, w, groups, 1e-5, act, layout, dtype,
                               gen, timed=False))
    short = [_shortseq_case(bh, 257, 80, 8, gen, timed=True)
             for bh in (8 * 16, 16 * 16)]
    for bh, s_, d, g in ((2, 129, 8, 1), (4, 200, 40, 2), (16, 384, 64, 8),
                         (32, 512, 120, 16)):
        ragged.append(_shortseq_case(bh, s_, d, g, gen, timed=False))
    # the redesigned bf16 low-dim forward at the edges of its kv ring: Sk
    # below one 64-row stage, one stage plus one row, two plus one, one row;
    # and a q tile of one row
    for d, sq, sk in ((40, 100, 63), (80, 64, 65), (64, 129, 129),
                      (16, 1, 200), (48, 200, 1), (40, 257, 4096)):
        ragged.append(_fwd_case(2, sq, sk, d, gen, timed=False))
    f32_cases = _f32_kernel_cases(gen, n)
    cases = {"sampling": sampling, "tuning_fwd": tuning_fwd, "grid": grid,
             "tuning_bwd": tuning_bwd, "grid_bwd": grid_bwd,
             "int8_flash": int8_flash, "int8_conv": int8_conv,
             "int8_quantize": int8_quantize, "group_norm": group_norm, "shortseq": short,
             "ragged": ragged, **f32_cases}
    print(json.dumps({"phase": "kernels", **cases}))
    return cases


def _f32_kernel_cases(gen, n):
    """The f32 kernels (``csrc/attention_f32.cu``, and the int8 kernel's f32
    epilogue) at the f32 paths' shapes, timed, and at ragged shapes: d in
    {8, 40, 80, 120, 136, 160, 256}, Sq and Sk off the 64-row tiles (63,
    65, 127, 129 and others), Sk below one tile and one tile plus one row;
    the short-sequence kernel at 257 and 258 tokens (88-row q tiles), at
    129 and 65, and at 512 (the flash-shaped kernel above 320)."""
    import torch

    f32 = torch.float32
    out = {
        # f32 sampling's two flash sites (batch n, 8 heads)
        "f32_sampling": [_fwd_case(8 * n, 4096, 4096, 40, gen, True, f32),
                         _fwd_case(8 * n, 1024, 1024, 80, gen, True, f32)],
        # f32 tuning's sites, as bf16 tuning's (BH = 16 x 8 heads)
        "f32_tuning_fwd": [_fwd_case(128, sq, sk, d, gen, True, f32)
                           for sq, sk, d in TUNING_SITES]
        + [_fwd_case(256, 257, 257, 80, gen, True, f32)],
        "f32_tuning_bwd": [_bwd_case(128, sq, sk, d, gen, True, f32)
                           for sq, sk, d in TUNING_SITES],
        "f32_shortseq": [_shortseq_case(bh, 257, 80, 8, gen, True, f32)
                         for bh in (8 * 16, 16 * 16)],
        "f32_int8_flash": [
            _int8_flash_case(8 * n, s_, s_, d, mode, gen, True, f32)
            for mode in ("qk", "qkpv") for s_, d in ((4096, 40),
                                                     (1024, 80))],
        "f32_ragged": []}
    ragged = out["f32_ragged"]
    for d, sq, sk in ((8, 65, 33), (40, 300, 200), (80, 100, 63),
                      (120, 64, 65), (160, 70, 31), (256, 129, 33),
                      (40, 1, 129), (256, 33, 300),
                      # the register-blocked kernels' tile edges: Sq and Sk
                      # one row either side of 64 and 128, D unpadded to 128
                      # (8, 40) and by 32 above (136 -> 160, 256)
                      (8, 63, 65), (40, 65, 63), (40, 127, 129),
                      (80, 129, 127), (136, 129, 65), (136, 63, 127),
                      (256, 65, 129), (256, 127, 63)):
        ragged.append(_fwd_case(2, sq, sk, d, gen, False, f32))
        ragged.append(_bwd_case(2, sq, sk, d, gen, False, f32))
    for bh, s_, d, g in ((2, 129, 8, 1), (4, 200, 40, 2), (2, 512, 120, 2),
                         (2, 65, 64, 1), (2, 257, 80, 1), (2, 258, 40, 2),
                         (2, 257, 8, 1), (2, 258, 128, 2), (2, 63, 120, 1)):
        ragged.append(_shortseq_case(bh, s_, d, g, gen, False, f32))
    for mode in ("qk", "qkpv"):
        for d, sq, sk in ((8, 65, 33), (40, 300, 200), (80, 128, 257),
                          (120, 70, 90)):
            ragged.append(_int8_flash_case(2, sq, sk, d, mode, gen, False,
                                           f32))
    return out


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
KERNEL_ROWS = ("flash_fwd_lowdim", "flash_fwd_wide", "flash_bwd",
               "flash_fwd_int8", "int8_conv", "int8_quantize", "group_norm",
               "flash_fwd_shortseq", "flash_fwd_lowdim_f32",
               "flash_fwd_wide_f32", "flash_bwd_f32", "flash_fwd_shortseq_f32",
               "flash_fwd_int8_qk_f32", "flash_fwd_int8_qkpv_f32")
# low-dim flash sites per sampling step at batch >= 5: 10 per UNet forward,
# two forwards a step; the d=160 sites stay on einsum below 128 MiB
LOWDIM_SITES_PER_STEP = 20


def _reset_launches():
    from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
    from e4t_diffusion_torch.ops.flash_int8 import flash_fwd_int8
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd
    from e4t_diffusion_torch.ops.groupnorm import fused_group_norm
    from e4t_diffusion_torch.ops.int8_conv import int8_conv, int8_conv_act
    from e4t_diffusion_torch.ops.quant import quantize_activation
    from e4t_diffusion_torch.ops.shortseq import flash_fwd_shortseq

    for counts in (flash_fwd.launches, flash_bwd.launches,
                   flash_fwd_int8.launches, flash_fwd_shortseq.launches):
        counts.update(dict.fromkeys(counts, 0))
    int8_conv.launches = int8_conv_act.launches = 0
    quantize_activation.launches = 0
    fused_group_norm.launches = 0


def _read_launches():
    from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
    from e4t_diffusion_torch.ops.flash_int8 import flash_fwd_int8
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd
    from e4t_diffusion_torch.ops.groupnorm import fused_group_norm
    from e4t_diffusion_torch.ops.int8_conv import int8_conv, int8_conv_act
    from e4t_diffusion_torch.ops.quant import quantize_activation
    from e4t_diffusion_torch.ops.shortseq import flash_fwd_shortseq

    # the conv kernel's two wrappers: int8 x, and x quantized in its loads
    return {"flash_fwd_lowdim": flash_fwd.launches["lowdim"],
            "flash_fwd_wide": flash_fwd.launches["wide"],
            "flash_bwd": flash_bwd.launches["bf16"],
            "flash_fwd_int8": flash_fwd_int8.launches["bf16"],
            "int8_conv": int8_conv.launches + int8_conv_act.launches,
            "int8_quantize": quantize_activation.launches,
            "group_norm": fused_group_norm.launches,
            "flash_fwd_shortseq": flash_fwd_shortseq.launches["bf16"],
            "flash_fwd_lowdim_f32": flash_fwd.launches["lowdim_f32"],
            "flash_fwd_wide_f32": flash_fwd.launches["wide_f32"],
            "flash_bwd_f32": flash_bwd.launches["f32"],
            "flash_fwd_shortseq_f32": flash_fwd_shortseq.launches["f32"],
            "flash_fwd_int8_qk_f32": flash_fwd_int8.launches["qk_f32"],
            "flash_fwd_int8_qkpv_f32": flash_fwd_int8.launches["qkpv_f32"]}


@contextlib.contextmanager
def _routes_on():
    """Both opt-in routes on (``ROUTE_KNOBS``) for the block, then the
    environment as it was."""
    saved = {k: os.environ.get(k) for k in ROUTE_KNOBS}
    os.environ.update(ROUTE_KNOBS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _want(**counts):
    return {**dict.fromkeys(KERNEL_ROWS, 0), **counts}


def _sample(pipe, image, scheduler_type, want, seed=0):
    """One batch-8 512px CFG-7.5 run, its launch counts checked against
    ``want``."""
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
    if launches != want:
        fail(f"{scheduler_type}: launches {launches}, expected {want}")
    return images, seconds, launches


def _profile(run):
    """Device time by kernel over one call of ``run`` (wall time is taken
    under the profiler, so the busy share is a lower bound), and the share
    of it the f32 attention kernels take (``csrc/attention_f32.cu``, whose
    kernels are named attn_*). The device numbers are None ("not
    measured") when three sessions held no device record."""
    from torch.autograd import DeviceType

    prof, wall_us, traced = _traced(run)
    rows, attn_us = [], 0.0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            # host ops, and annotated ranges such as the optimizer step:
            # their device time is that of the kernels they hold
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key[:80], evt.count))
            if "attn_" in evt.key:
                attn_us += dev_us
    if not traced:
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": None,
                "device_busy_share": None, "f32_attention_ms": None,
                "f32_attention_share_of_busy": None, "top": [],
                "device_trace": "empty in three sessions"}
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "f32_attention_ms": attn_us / 1e3,
            "f32_attention_share_of_busy": attn_us / max(busy_us, 1e-9),
            "top": [{"kernel": k, "ms": us / 1e3, "count": c,
                     "share_of_busy": us / busy_us}
                    for us, k, c in rows[:16]]}


# PyTorch ops that would be a quantization pass at a conv site (the kernel
# quantizes in its loads; a dynamic site keeps one reduction for its scale)
CONV_QUANT_PASS_OPS = ("aten::round", "aten::constant_pad_nd", "aten::clone",
                       "aten::abs")
INT8_RANGES = ("e4t::conv_site", "e4t::linear_site", "e4t::int_mm",
               "e4t::linear_quant")


@contextlib.contextmanager
def _int8_site_ranges():
    """``ops/quant``'s int8 site functions, each inside a profiler range for
    the block: ``int8_conv2d``, ``int8_linear``, ``_int_mm``, and
    ``quantize_activation`` where a linear site calls it (channel_dim -1)."""
    import torch

    from e4t_diffusion_torch.ops import quant

    saved = {k: getattr(quant, k) for k in (
        "int8_conv2d", "int8_linear", "_int_mm", "quantize_activation")}

    def ranged(name, fn, when=lambda *a: True):
        def call(*args, **kwargs):
            if not when(*args):
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        # one attribute dict: a launch counted on the function (through its
        # module's global name, now this wrapper) lands on the function
        call.__dict__ = fn.__dict__
        return call

    quant.int8_conv2d = ranged("e4t::conv_site", saved["int8_conv2d"])
    quant.int8_linear = ranged("e4t::linear_site", saved["int8_linear"])
    quant._int_mm = ranged("e4t::int_mm", saved["_int_mm"])
    quant.quantize_activation = ranged(
        "e4t::linear_quant", saved["quantize_activation"],
        lambda x, site, channel_dim: channel_dim == -1)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(quant, k, v)


def _int8_profile(run):
    """Wall and device busy time of one call of ``run`` on int8 sites, and
    the busy time split (ms): ``int8_conv_kernel`` (kernels named
    int8_conv*), ``conv_quant`` (the PyTorch kernels inside the conv sites'
    ranges; the kernels of ``csrc/`` are launched through ctypes, tied to no
    op, so the ranges do not hold them), ``linear_quant`` (the linear sites'
    ``quantize_activation``: its PyTorch kernels and the kernels named
    quantize_kernel), ``int_mm``, ``linear_rest`` (the linear
    sites' rescale, cast and bias) and ``rest``; ``conv_site_ops``: the
    PyTorch ops that launched kernels inside the conv sites, with their
    device time; ``conv_site_op_names``: every PyTorch op inside them,
    kernels or not (read off the host's records, so it holds when the
    device trace is empty). The device numbers are None ("not measured")
    when three sessions held no device record."""
    from torch.autograd import DeviceType

    with _int8_site_ranges():
        prof, wall_us, traced = _traced(run)
    busy_us = conv_us = quant_us = 0.0
    top = []
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        busy_us += evt.self_device_time_total
        if "int8_conv" in evt.key:
            conv_us += evt.self_device_time_total
        if "quantize_kernel" in evt.key:
            quant_us += evt.self_device_time_total
        if evt.self_device_time_total > 0:
            top.append((evt.self_device_time_total, evt.key[:80], evt.count))
    ranges = dict.fromkeys(INT8_RANGES, 0.0)
    calls = dict.fromkeys(INT8_RANGES, 0)
    conv_ops, conv_names = {}, set()

    def walk(evt):
        for ch in evt.cpu_children:
            conv_names.add(ch.name)
            if ch.kernels:
                conv_ops[ch.name] = conv_ops.get(ch.name, 0.0) + sum(
                    k.duration for k in ch.kernels) / 1e3
            walk(ch)

    for evt in prof.events():
        if evt.device_type == DeviceType.CPU and evt.name in ranges:
            ranges[evt.name] += evt.device_time_total
            calls[evt.name] += 1
            if evt.name == "e4t::conv_site":
                walk(evt)
    linear = ranges["e4t::linear_site"]
    split = {"int8_conv_kernel": conv_us,
             "conv_quant": ranges["e4t::conv_site"],
             "linear_quant": ranges["e4t::linear_quant"] + quant_us,
             "int_mm": ranges["e4t::int_mm"],
             "linear_rest": (linear - ranges["e4t::linear_quant"]
                             - ranges["e4t::int_mm"]),
             "rest": (busy_us - conv_us - quant_us - ranges["e4t::conv_site"]
                      - linear)}
    top.sort(reverse=True)
    host = {"range_calls": {k.split("::")[1]: v for k, v in calls.items()},
            "conv_site_op_names": sorted(conv_names)}
    if not traced:
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": None,
                "device_busy_share": None, "split_ms": None,
                "conv_site_ops": None, "top": [],
                "device_trace": "empty in three sessions", **host}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "split_ms": {k: v / 1e3 for k, v in split.items()}, **host,
            "conv_site_ops": conv_ops,
            "top": [{"kernel": k, "ms": us / 1e3, "count": c}
                    for us, k, c in top[:12]]}


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

    want = _want(flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS)
    first, first_s, launches = _sample(pipe, image, "ddim", want)
    torch.cuda.reset_peak_memory_stats()
    second, second_s, launches2 = _sample(pipe, image, "ddim", want)
    peak = torch.cuda.max_memory_allocated()
    rerun = float(np.abs(first - second).max())
    if not rerun <= RERUN_MAX_ABS:
        fail(f"two same-seed DDIM runs differ by {rerun}")
    _, dpm_s, dpm_launches = _sample(pipe, image, "dpm_solver++", want)
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
    return launches, pipe, image, second_s


def _vit_shortseq_sites(vit_cfg, batch):
    """The ViT-H's attention sites that take the short-sequence route (all
    of its layers, or none), decided by the port's own route with both
    opt-in routes on."""
    from e4t_diffusion_torch.ops.attention import shortseq_route

    shape = (batch, vit_cfg.num_heads, vit_cfg.grid ** 2 + 1,
             vit_cfg.width // vit_cfg.num_heads)
    with _routes_on():
        routed = shortseq_route(shape, shape, "cuda")
    return vit_cfg.num_layers if routed else 0


def phase_routes_sampling(smi, pipe, image, bf16_warm_s):
    """Phase 4's pipeline with ``E4T_FUSED_GN=1 E4T_SHORTSEQ_MH_ATTN=8``:
    two same-seed DDIM-4 runs, launches derived from the GroupNorm and
    attention sites, and one UNet pass with the routes on against off."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.models.vae import VAEConfig

    n = len(PROMPTS) * IMAGES_PER_PROMPT
    unet = pipe.modules.unet
    gn_sites = _group_norm_sites(unet.config, VAEConfig(), 1, RESOLUTION)
    per_pass = sum(gn_sites["unet"].values())
    # two full UNet passes a step, one VAE decode a run; the ViT runs once
    want = _want(
        flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS,
        group_norm=2 * STEPS * per_pass + sum(gn_sites["vae_decode"].values()),
        flash_fwd_shortseq=_vit_shortseq_sites(
            pipe.modules.e4t_encoder.config.vit, n))
    with _routes_on():
        first, first_s, launches = _sample(pipe, image, "ddim", want)
        torch.cuda.reset_peak_memory_stats()
        second, second_s, launches2 = _sample(pipe, image, "ddim", want)
        peak = torch.cuda.max_memory_allocated()
        prof = _profile(lambda: pipe(
            PROMPTS, image, num_inference_steps=STEPS, guidance_scale=7.5,
            num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
            width=RESOLUTION, seed=0))
    rerun = float(np.abs(first - second).max())
    if not rerun <= RERUN_MAX_ABS:
        fail(f"routes on: two same-seed DDIM runs differ by {rerun}")

    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    ctx = torch.randn(n, 77, unet.config.cross_attention_dim, device="cuda",
                      generator=gen)
    t = torch.full((n,), 500, device="cuda")
    with torch.inference_mode():
        eps_off = unet(x, t, ctx).float()
        with _routes_on():
            eps_on = unet(x, t, ctx).float()
    route_rel = _rel(eps_on, eps_off)
    if not route_rel <= UNET_ROUTE_REL_L2:
        fail(f"UNet eps, routes on vs off: rel-L2 {route_rel}")
    print(json.dumps({
        "phase": "routes_sampling", "card": smi, "knobs": ROUTE_KNOBS,
        "batch": n, "resolution": RESOLUTION, "steps": STEPS,
        "guidance": 7.5, "group_norm_sites_per_unet_pass": per_pass,
        "ddim_first_s": first_s, "ddim_warm_s": second_s,
        "ddim_images_per_s": n / second_s,
        "bf16_ddim_warm_s_routes_off": bf16_warm_s,
        "max_memory_allocated_gb": peak / 1e9, "rerun_max_abs": rerun,
        "unet_routes_on_vs_off_rel_l2": route_rel,
        "launches": [launches, launches2], "profile": prof}))
    return launches


@contextlib.contextmanager
def _plain_versions():
    """The int8 kernels' wrappers replaced by their plain versions (the
    attention one at the kernel's kv tile), for a comparison on the card."""
    from e4t_diffusion_torch.ops import flash_int8 as fi
    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    saved = (ic.int8_conv, ic.int8_conv_act, quant.quantize_activation,
             fi.flash_fwd_int8)
    ic.int8_conv = (lambda x, w, scale, bias, out_dtype, stride=1, padding=0:
                    ic.int8_conv_reference(x, w, scale, bias, out_dtype,
                                           stride, padding))
    ic.int8_conv_act = (
        lambda x, w, act, per_channel, scale, bias, stride=1, padding=0:
        ic.int8_conv_act_reference(x, w, act, per_channel, scale, bias,
                                   stride, padding))
    quant.quantize_activation = quant.quantize_activation_reference
    fi.flash_fwd_int8 = fi.flash_fwd_int8_reference
    try:
        yield
    finally:
        (ic.int8_conv, ic.int8_conv_act, quant.quantize_activation,
         fi.flash_fwd_int8) = saved


def _unet_int8_checks(pipe, act_amax, gen):
    """One batch-8 512px UNet forward in bf16 and on int8 paths: static int8
    weights and activations (the serving flavor, the pipeline's calibrated
    ranges), int8 attention alone in each mode, and dynamic int8 with
    "qkpv" attention. Each kernel's path against the same path on the plain
    versions; the int8 serving paths against bf16."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import _static_exclude_for
    from e4t_diffusion_torch.ops import quant
    from e4t_diffusion_torch.ops.attention import int8_flash_attention

    unet = pipe.modules.unet
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    x = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    ctx = torch.randn(n, 77, unet.config.cross_attention_dim, device="cuda",
                      generator=gen)
    t = torch.full((n,), 500, device="cuda")
    params = dict(unet.named_parameters())
    paths = {
        "static": (quant.quantize_params(
            params, act_amax=act_amax,
            static_exclude=_static_exclude_for(False)), None),
        "attn_qk": ({}, "qk"), "attn_qkpv": ({}, "qkpv"),
        "dynamic_qkpv": (quant.quantize_params(params), "qkpv")}

    def run(sites, attn):
        with torch.inference_mode(), quant.int8_sites(unet, sites), (
                int8_flash_attention(attn) if attn
                else contextlib.nullcontext()):
            return unet(x, t, ctx).float()

    with torch.inference_mode():
        eps = unet(x, t, ctx).float()
    kernel = {k: run(*v) for k, v in paths.items()}
    held = ("static", "attn_qk", "attn_qkpv")
    with _plain_versions():
        plain = {k: run(*paths[k]) for k in held}
    out = {f"eps_{k}_kernel_vs_plain_rel_l2": _rel(kernel[k], plain[k])
           for k in held}
    out.update({f"eps_{k}_vs_bf16_rel_l2": _rel(kernel[k], eps)
                for k in kernel})
    if not (all(out[f"eps_{k}_kernel_vs_plain_rel_l2"]
                <= UNET_INT8_PLAIN_REL_L2 for k in held)
            and all(out[f"eps_{k}_vs_bf16_rel_l2"] <= INT8_VS_BF16_REL_L2
                    for k in kernel)):
        fail(f"UNet eps on the int8 paths: {out}")
    return out


def phase_int8_sampling(smi, pipe, image):
    """The full-width pipeline serving its UNet in int8: static activation
    scales (the first call calibrates with E4T_INT8_CALIB_STEPS bf16 steps)
    under DDIM and DPM++, then dynamic scales with the int8 attention
    kernel in "qk" and "qkpv" mode. Launches are derived from the UNet's
    quantized conv sites and its low-dim flash sites and checked run by
    run."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import (
        StableDiffusionE4TPipeline)

    n = len(PROMPTS) * IMAGES_PER_PROMPT
    conv_sites = sum(_unet_conv_shapes(n, RESOLUTION).values())
    linear_sites = sum(_unet_linear_shapes(n, RESOLUTION).values())
    calib_steps = int(os.environ.get("E4T_INT8_CALIB_STEPS", "8"))
    # two full UNet passes a step (CFG: the uncond pass with the tap, and
    # the cond pass)
    conv_run = 2 * conv_sites * STEPS
    # one quantization kernel a quantized linear site and pass
    quant_run = 2 * linear_sites * STEPS
    lowdim_run = LOWDIM_SITES_PER_STEP * STEPS

    def make(int8, attn=False):
        return StableDiffusionE4TPipeline(
            pipe.modules, pipe.offsets, pipe.tokenizer, pipe.e4t_config,
            already_added_placeholder_token=True, int8=int8, int8_attn=attn)

    total = _want()
    report = {"phase": "int8_sampling", "card": smi, "batch": n,
              "resolution": RESOLUTION, "steps": STEPS, "guidance": 7.5,
              "calib_steps": calib_steps,
              "conv_sites_per_unet_pass": conv_sites,
              "linear_sites_per_unet_pass": linear_sites, "runs": {}}

    def sample(name, p, scheduler_type, want):
        if name.endswith("warm"):
            torch.cuda.reset_peak_memory_stats()
        images, seconds, launches = _sample(p, image, scheduler_type, want)
        for k, v in launches.items():
            total[k] += v
        report["runs"][name] = {
            "s": seconds, "images_per_s": n / seconds, "launches": launches,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}
        return images

    static = make("static")
    serve = _want(flash_fwd_lowdim=lowdim_run, int8_conv=conv_run,
                  int8_quantize=quant_run)
    first = sample("static_ddim_first", static, "ddim", _want(
        flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * (calib_steps + STEPS),
        int8_conv=conv_run, int8_quantize=quant_run))
    second = sample("static_ddim_warm", static, "ddim", serve)
    report["static_rerun_max_abs"] = float(np.abs(first - second).max())
    sample("static_dpm_warm", static, "dpm_solver++", serve)
    for mode in ("qk", "qkpv"):
        p = make(True, mode)
        want = _want(flash_fwd_int8=lowdim_run, int8_conv=conv_run,
                     int8_quantize=quant_run)
        a = sample(f"{mode}_ddim_first", p, "ddim", want)
        b = sample(f"{mode}_ddim_warm", p, "ddim", want)
        report[f"{mode}_rerun_max_abs"] = float(np.abs(a - b).max())
    for key in ("static_rerun_max_abs", "qk_rerun_max_abs",
                "qkpv_rerun_max_abs"):
        if not report[key] <= RERUN_MAX_ABS:
            fail(f"int8 sampling: two same-seed runs differ: {report}")

    kwargs = dict(num_inference_steps=STEPS, guidance_scale=7.5,
                  num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
                  width=RESOLUTION, seed=0, output_type="latent")
    lat_bf16 = torch.from_numpy(pipe(PROMPTS, image, **kwargs))
    for name, serving in (("static", static), ("qkpv", p)):
        lat_int8 = torch.from_numpy(serving(PROMPTS, image, **kwargs))
        key = f"final_latents_{name}_vs_bf16_rel_l2"
        report[key] = _rel(lat_int8, lat_bf16)
        if not (torch.isfinite(lat_int8).all() and
                report[key] <= INT8_VS_BF16_REL_L2):
            fail(f"int8 sampling: final latents against bf16: {report}")
    report.update(_unet_int8_checks(pipe, static.act_amax,
                                    torch.Generator("cuda").manual_seed(3)))
    prof = _int8_profile(lambda: static(
        PROMPTS, image, num_inference_steps=STEPS, guidance_scale=7.5,
        num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
        width=RESOLUTION, seed=0))
    report["profile_static_ddim"] = prof
    passes = sorted(set(prof["conv_site_op_names"])
                    & set(CONV_QUANT_PASS_OPS))
    if passes or prof["range_calls"]["conv_site"] != conv_run:
        fail(f"int8 sampling: quantization passes in PyTorch at the conv "
             f"sites ({passes}), or not every conv site profiled: {prof}")
    report["launches_total"] = total
    print(json.dumps(report))
    return total


def _expected_tuning_launches(ucfg, vit_cfg, resolution, routes=False,
                              dtype=None, vae_cfg=None):
    """Launches per tuning step in the compute ``dtype`` (bf16 by default,
    or f32: the f32 kernels' rows), derived from the attention sites at the
    latent size ``vae_cfg`` gives (SD-v1's VAE by default: 1/8) and, with
    the opt-in routes on, the GroupNorm sites. Every site whose query
    has >= FLASH_MIN_SEQ tokens goes to flash (the step is all-flash) but
    the ViT's, which take the short-sequence kernel with the routes on; the
    tap pass runs the down and mid blocks, the full pass every block;
    whole-UNet remat runs each pass's forward twice, its backward once.
    The frozen ViT runs forward only."""
    from e4t_diffusion_torch.models.weight_offsets import attention_sites
    from e4t_diffusion_torch.ops.attention import FLASH_MIN_SEQ
    from e4t_diffusion_torch.ops.flash_lowdim import launch_route

    import torch

    dtype = dtype or torch.bfloat16
    sfx = "_f32" if _f32(dtype) else ""
    from e4t_diffusion_torch.models.vae import VAEConfig

    vae_cfg = vae_cfg or VAEConfig()
    side = resolution >> (len(vae_cfg.block_out_channels) - 1)
    levels = len(ucfg.block_out_channels)
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
        want[f"flash_fwd_{launch_route(d, dtype)}"] += 2 * passes
        want["flash_bwd" + sfx] += passes
    vit_short = _vit_shortseq_sites(vit_cfg, 1) if routes else 0
    want["flash_fwd_shortseq" + sfx] += vit_short
    if vit_cfg.grid ** 2 + 1 >= FLASH_MIN_SEQ:
        want["flash_fwd_lowdim" + sfx] += vit_cfg.num_layers - vit_short
    if routes:
        sites = _group_norm_sites(ucfg, vae_cfg, 1, resolution)
        want["group_norm"] += 2 * (sum(sites["unet_tap"].values())
                                   + sum(sites["unet"].values()))
    return want


def phase_tuning(smi, steps=TUNING_STEPS, routes=False, routes_off=None,
                 dtype=None, batch=16):
    """Phase-2 tuning at full width through ``tuning_e4t.tune`` with the
    CLI's defaults (batch 16, 512px, lr 1.6e-5, clip 1.0) in ``dtype``
    (bf16, ``--mixed_precision bf16``, by default; f32 is ``no``), from
    seeded weights. ``routes``: both opt-in routes on, and the first step's
    loss and grad norm held against ``routes_off``, the first step's
    metrics of a run with the routes off. Returns (launches, the first
    step's metrics)."""
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

    dtype = dtype or torch.bfloat16
    f32 = _f32(dtype)

    def cli_args(max_steps):
        return tuning_e4t.parse_args([
            "--pretrained_model_name_or_path", "-", "--train_image_path",
            "-", "--max_train_steps", str(max_steps), "--mixed_precision",
            "no" if f32 else "bf16", "--train_batch_size", str(batch)])

    args = cli_args(steps)
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
        # frozen modules are cast to the compute dtype by the trainer
        "vit": sums(e4t.clip_vision.parameters(), dtype),
        "vae": sums(modules.vae.parameters(), dtype)}
    templates = resolve_templates("normal")

    if tuning_e4t.resolve_train_dtype(args.mixed_precision, "cuda") != dtype:
        fail(f"--mixed_precision {args.mixed_precision} is not {dtype}")

    def run(run_args):
        return tuning_e4t.tune(run_args, modules, offsets, tokenizer, "*s",
                               templates, class_id, image,
                               NoiseScheduleConfig(), dtype)

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _routes_on() if routes else contextlib.nullcontext():
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
    if len(metrics) != steps or not all(
            math.isfinite(m[k]) for m in metrics
            for k in ("loss", "loss_diff", "loss_reg", "grad_norm")):
        fail(f"tuning: non-finite or missing metrics {metrics}")
    for group in ("unet", "e4t", "offsets"):
        if torch.equal(before[group], after[group]):
            fail(f"tuning: trainable group {group} did not change")
    for group in ("vit", "vae"):
        if not torch.equal(before[group], after[group]):
            fail(f"tuning: frozen group {group} changed")
    per_step = _expected_tuning_launches(ucfg, ecfg.vit, args.resolution,
                                         routes, dtype)
    want = {k: steps * v for k, v in per_step.items()}
    if routes:
        # the replicated image is VAE-encoded once a run
        want["group_norm"] += sum(_group_norm_sites(
            ucfg, VAEConfig(), 1, args.resolution)["vae_encode"].values())
    if launches != want:
        fail(f"tuning: launches {launches}, expected {want} "
             f"({per_step} per step)")
    report = {}
    if routes:
        report["first_step_vs_routes_off_rel"] = rel = {
            k: abs(metrics[0][k] - routes_off[k]) / abs(routes_off[k])
            for k in ("loss", "grad_norm")}
        if not max(rel.values()) <= TUNING_ROUTE_REL:
            fail(f"tuning, routes on vs off, first step: {rel} "
                 f"({metrics[0]} against {routes_off})")
    else:
        report["profile"] = _profile(lambda: run(cli_args(1)))
    # after the first step where there is one
    steady = result["step_seconds"][1:] or result["step_seconds"]
    s_per_step = sum(steady) / len(steady)
    print(json.dumps({
        "phase": ("routes_tuning" if routes else "f32_tuning" if f32
                  else "tuning"), "card": smi,
        "dtype": str(dtype)[6:],
        "knobs": ROUTE_KNOBS if routes else {}, "setup_s": setup_s,
        "batch": args.train_batch_size, "resolution": args.resolution,
        "steps": steps, "wall_s": wall,
        "trainable_params": sum(t.numel() for g in trained.values()
                                for t in g.values()),
        "step_seconds": result["step_seconds"], "s_per_step": s_per_step,
        "samples_per_s": args.train_batch_size / s_per_step,
        "max_memory_allocated_gb": peak / 1e9, "metrics": metrics,
        "launches": launches, "launches_per_step": per_step, **report}))
    return launches, metrics[0]


def phase_tiny_vs_cpu():
    """The tiny pipeline, f32, on the card and on the CPU; then in static
    int8, each side calibrating on its first call; then in f32 with
    ``E4T_FUSED_GN=1`` (the GroupNorm kernel in f32 on the card, its plain
    version on the CPU), its launches derived from the sites."""
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
    steps = 3
    outs, outs8, outs_gn, amax = [], [], [], []
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["a", "photo", "of",
                                                        "face"])
        for mods in (cpu, card):
            for int8, dst in ((False, outs), ("static", outs8),
                              (False, outs_gn)):
                pipe = StableDiffusionE4TPipeline(
                    mods, offsets, CLIPTokenizer.from_pretrained(
                        tok_dir, model_max_length=16), cfg, int8=int8)
                routes = dst is outs_gn
                _reset_launches()
                with _routes_on() if routes else contextlib.nullcontext():
                    dst.append(pipe(PROMPTS[:1] + ["a *s face"], image,
                                    num_inference_steps=steps,
                                    guidance_scale=7.5,
                                    num_images_per_prompt=2,
                                    latents=latents))
                gn_launches = _read_launches()["group_norm"]
                if int8:
                    amax.append(pipe.act_amax)
    sites = _group_norm_sites(cpu.unet.config, cpu.vae.config, 1,
                              8 * latents.shape[-1])
    want_gn = (2 * steps * sum(sites["unet"].values())
               + sum(sites["vae_decode"].values()))
    if gn_launches != want_gn:
        fail(f"tiny pipeline, E4T_FUSED_GN=1 on the card: {gn_launches} "
             f"GroupNorm launches, expected {want_gn}")
    err_gn = float(np.abs(outs_gn[0] - outs_gn[1]).max())
    if not err_gn <= TINY_CARD_VS_CPU_MAX_ABS:
        fail(f"tiny pipeline, E4T_FUSED_GN=1, card vs CPU: max-abs {err_gn}")
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TINY_CARD_VS_CPU_MAX_ABS:
        fail(f"tiny pipeline, card vs CPU: max-abs {err}")
    amax_err = max(
        float((amax[1][name][k].cpu() - v).abs().max() / v.abs().max())
        for name, site in amax[0].items() for k, v in site.items())
    if set(amax[0]) != set(amax[1]) or not amax_err <= TINY_AMAX_REL:
        fail(f"tiny int8 calibration, card vs CPU: {amax_err}")
    err8 = float(np.abs(outs8[0] - outs8[1]).max())
    int8_err = float(np.abs(outs8[0] - outs[0]).max())
    if not (np.isfinite(outs8[1]).all()
            and err8 <= INT8_SPREAD_OF_ERROR * int8_err):
        fail(f"tiny int8 pipeline, card vs CPU: max-abs {err8} against an "
             f"int8 error of {int8_err}")
    print(json.dumps({"phase": "tiny_card_vs_cpu", "max_abs": err,
                      "int8_calibration_rel": amax_err,
                      "int8_max_abs": err8,
                      "int8_vs_f32_max_abs_cpu": int8_err,
                      "fused_gn_max_abs": err_gn,
                      "fused_gn_launches": gn_launches,
                      "fused_gn_vs_off_max_abs_cpu": float(
                          np.abs(outs_gn[0] - outs[0]).max())}))


@contextlib.contextmanager
def _flash_plain_versions():
    """The flash forward replaced by its plain version where the attention
    route calls it, for a comparison on the card."""
    from e4t_diffusion_torch.ops import attention
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd_reference

    kernel = attention.flash_fwd
    attention.flash_fwd = flash_fwd_reference
    try:
        yield
    finally:
        attention.flash_fwd = kernel


def phase_f32_sampling(smi, pipe, image):
    """Phase 4's pipeline with its modules in f32, as ``--dtype fp32``
    builds them (``resolve_dtype("fp32", cuda)``): two DDIM-4 runs, 80
    launches of the f32 low-dim forward and none of the bf16 one; one UNet
    pass on the kernel against the same pass on its plain version; one UNet
    pass with the int8 attention in f32 in each mode against its plain
    version; one ViT-H encode with ``E4T_SHORTSEQ_MH_ATTN=8`` (the f32
    short-sequence kernel) against einsum. Returns the launches of the
    phase, its runs and passes together."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import resolve_dtype
    from e4t_diffusion_torch.ops.attention import int8_flash_attention

    dtype = resolve_dtype("fp32", torch.device("cuda"))
    if dtype != torch.float32:
        fail(f"--dtype fp32 on the GPU resolves to {dtype}")
    for m in pipe.modules.all():
        m.to(dtype)
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    total = _want()

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    want = _want(flash_fwd_lowdim_f32=LOWDIM_SITES_PER_STEP * STEPS)
    first, first_s, launches = _sample(pipe, image, "ddim", want)
    add(launches)
    torch.cuda.reset_peak_memory_stats()
    second, second_s, launches2 = _sample(pipe, image, "ddim", want)
    add(launches2)
    peak = torch.cuda.max_memory_allocated()
    rerun = float(np.abs(first - second).max())
    if not rerun <= RERUN_MAX_ABS:
        fail(f"f32: two same-seed DDIM runs differ by {rerun}")
    prof = _profile(lambda: pipe(
        PROMPTS, image, num_inference_steps=STEPS, guidance_scale=7.5,
        num_images_per_prompt=IMAGES_PER_PROMPT, height=RESOLUTION,
        width=RESOLUTION, seed=0))

    unet = pipe.modules.unet
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    ctx = torch.randn(n, 77, unet.config.cross_attention_dim, device="cuda",
                      generator=gen)
    t = torch.full((n,), 500, device="cuda")
    per_pass = LOWDIM_SITES_PER_STEP // 2
    report = {}

    def unet_pass(label, want_pass, attn=None, plain=False):
        _reset_launches()
        with torch.inference_mode(), (
                int8_flash_attention(attn) if attn
                else contextlib.nullcontext()), (
                _plain_versions() if plain and attn
                else _flash_plain_versions() if plain
                else contextlib.nullcontext()):
            eps = unet(x, t, ctx)
        torch.cuda.synchronize()
        launches = _read_launches()
        if eps.dtype != torch.float32 or launches != want_pass:
            fail(f"f32 UNet pass {label}: {eps.dtype}, launches {launches}, "
                 f"expected {want_pass}")
        add(launches)
        return eps

    eps = unet_pass("kernel", _want(flash_fwd_lowdim_f32=per_pass))
    eps_plain = unet_pass("plain", _want(), plain=True)
    report["eps_kernel_vs_plain_rel_l2"] = _rel(eps, eps_plain)
    for mode in ("qk", "qkpv"):
        key = f"flash_fwd_int8_{mode}_f32"
        got = unet_pass(mode, _want(**{key: per_pass}), attn=mode)
        plain = unet_pass(f"{mode} plain", _want(), attn=mode, plain=True)
        report[f"eps_int8_{mode}_kernel_vs_plain_rel_l2"] = _rel(got, plain)
        report[f"eps_int8_{mode}_vs_f32_rel_l2"] = _rel(got, eps)
    del eps, eps_plain, got, plain

    # the ViT-H's 32 attention sites at batch n on the f32 short-sequence
    # kernel, against einsum (the route off)
    vit = pipe.modules.e4t_encoder.clip_vision
    size = vit.config.image_size
    pixels = torch.randn(n, 3, size, size, device="cuda", generator=gen)
    with torch.inference_mode():
        off = vit(pixels)[1]
        _reset_launches()
        with _routes_on():
            on = vit(pixels)[1]
        torch.cuda.synchronize()
    vit_launches = _read_launches()
    want_vit = _want(flash_fwd_shortseq_f32=_vit_shortseq_sites(vit.config, n))
    if vit_launches != want_vit:
        fail(f"f32 ViT-H with the short-sequence route: launches "
             f"{vit_launches}, expected {want_vit}")
    add(vit_launches)
    report["vit_tokens_shortseq_vs_einsum_rel_l2"] = _rel(on, off)
    checks = [v for k, v in report.items() if "kernel_vs_plain" in k
              and "int8" not in k] + [
        report["vit_tokens_shortseq_vs_einsum_rel_l2"]]
    if not (max(checks) <= F32_PATH_REL_L2 and all(
            report[f"eps_int8_{m}_kernel_vs_plain_rel_l2"]
            <= UNET_INT8_PLAIN_REL_L2 for m in ("qk", "qkpv"))):
        fail(f"f32 sampling, kernels against plain versions: {report}")
    print(json.dumps({
        "phase": "f32_sampling", "card": smi, "dtype": "float32",
        "batch": n, "resolution": RESOLUTION, "steps": STEPS,
        "guidance": 7.5, "ddim_first_s": first_s, "ddim_warm_s": second_s,
        "ddim_images_per_s": n / second_s,
        "max_memory_allocated_gb": peak / 1e9, "rerun_max_abs": rerun,
        "launches": [launches, launches2], "launches_total": total,
        "profile": prof, **report}))
    return total


@contextlib.contextmanager
def _draws_on_cpu(seed):
    """``torch.randn`` and ``torch.randint`` draw from one CPU generator
    seeded ``seed``, whatever generator and device they are given, and move
    the draw to the device asked for: a tuning step on the card then takes
    the random numbers of the same step on the CPU (a CUDA generator and a
    CPU one give different numbers from one seed)."""
    import torch

    cpu = torch.Generator().manual_seed(seed)
    randn, randint = torch.randn, torch.randint

    def draw(fn, *args, generator=None, device=None, **kwargs):
        del generator
        out = fn(*args, generator=cpu, **kwargs)
        return out if device is None else out.to(device)

    torch.randn = lambda *a, **kw: draw(randn, *a, **kw)
    torch.randint = lambda *a, **kw: draw(randint, *a, **kw)
    try:
        yield
    finally:
        torch.randn, torch.randint = randn, randint


def _tiny_tuning_step(device, state, offsets, resolution):
    """One ``tuning_e4t.tune`` step of the tiny configs on ``device`` from
    ``state`` (the modules' state dicts) with ``--mixed_precision no``:
    (metrics, per-group gradients as the optimizer saw them, launches)."""
    import numpy as np
    import torch

    from e4t_diffusion_torch import tuning_e4t
    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training.setup import resolve_class_token
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    args = tuning_e4t.parse_args([
        "--pretrained_model_name_or_path", "-", "--train_image_path", "-",
        "--max_train_steps", "1", "--mixed_precision", "no",
        "--train_batch_size", "2", "--resolution", str(resolution),
        "--device", str(device)])
    dtype = tuning_e4t.resolve_train_dtype(args.mixed_precision,
                                           torch.device(device))
    modules = E4TModules.tiny(device=device)
    for name, mod in zip(("unet", "vae", "text", "e4t"), modules.all()):
        mod.load_state_dict(state[name], strict=True)
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=[
            "a", "photo", "of", "the", "face"])
        tokenizer = CLIPTokenizer.from_pretrained(tok_dir,
                                                  model_max_length=16)
    tokenizer.add_tokens("*s")  # its id lies inside the 1,000-row table
    image = np.random.default_rng(7).integers(
        0, 256, (resolution, resolution, 3), dtype=np.uint8)
    seen = []
    make = tuning_e4t.make_optimizer

    def recording_optimizer(params, lr):
        opt = make(params, lr)
        step = opt.step

        def record_then_step(*a, **kw):
            seen.append([p.grad.detach().double().cpu() for p in params])
            return step(*a, **kw)

        opt.step = record_then_step
        return opt

    tuning_e4t.make_optimizer = recording_optimizer
    _reset_launches()
    try:
        with _draws_on_cpu(8):
            result = tuning_e4t.tune(
                args, modules, {k: v.to(device) for k, v in offsets.items()},
                tokenizer, "*s", resolve_templates(
                    "a photo of {placeholder_token}"),
                resolve_class_token(tokenizer, "face"), image,
                NoiseScheduleConfig(), dtype)
    finally:
        tuning_e4t.make_optimizer = make
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    launches = _read_launches()
    grads, i = {}, 0
    for group, tensors in result["trainable"].items():
        grads[group] = seen[0][i:i + len(tensors)]
        i += len(tensors)
    return result["metrics"][0], grads, launches


def phase_f32_tuning_vs_cpu():
    """One f32 tuning step of the tiny configs at TINY_TUNING_RESOLUTION on
    the card and on the CPU, from the same weights and draws: the card's
    f32 flash sites run the f32 forward and backward kernels, as many times
    as the sites give; the CPU runs their plain
    versions. Loss to TUNING_LOSS_REL, each group's gradient to
    TUNING_GRAD_REL_L2."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.models import weight_offsets as wo

    torch.manual_seed(9)
    cpu = E4TModules.tiny(device="cpu")
    state = {name: mod.state_dict() for name, mod in zip(
        ("unet", "vae", "text", "e4t"), cpu.all())}
    offsets = wo.init_offset_bank(cpu.unet.config,
                                  torch.Generator().manual_seed(10))
    res = TINY_TUNING_RESOLUTION
    m_cpu, g_cpu, _ = _tiny_tuning_step("cpu", state, offsets, res)
    m_card, g_card, launches = _tiny_tuning_step("cuda", state, offsets, res)
    want = _expected_tuning_launches(
        cpu.unet.config, cpu.e4t_encoder.config.vit, res, dtype=torch.float32,
        vae_cfg=cpu.vae.config)
    if launches != want or launches["flash_fwd_lowdim_f32"] == 0:
        fail(f"tiny f32 tuning step: launches {launches}, expected {want}")
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    grad_rel = {}
    for group in g_cpu:
        num = sum(float((a - b).norm() ** 2)
                  for a, b in zip(g_card[group], g_cpu[group]))
        den = sum(float(b.norm() ** 2) for b in g_cpu[group])
        grad_rel[group] = (num / den) ** 0.5
    report = {"phase": "f32_tuning_vs_cpu", "resolution": res, "batch": 2,
              "loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
              "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
              "launches": launches}
    if not (loss_rel <= TUNING_LOSS_REL
            and max(grad_rel.values()) <= TUNING_GRAD_REL_L2):
        fail(f"tiny f32 tuning step, card vs CPU: {report}")
    print(json.dumps(report))
    return launches


def phase_f32_tuning(smi):
    """One full-width f32 tuning step (``--mixed_precision no``) at the
    largest batch of F32_TUNING_BATCHES that the card holds; a batch that
    runs out of memory is recorded and the next one tried."""
    import torch

    import gc

    refused = []
    for batch in F32_TUNING_BATCHES:
        try:
            launches, _ = phase_tuning(smi, steps=1, dtype=torch.float32,
                                       batch=batch)
        except torch.cuda.OutOfMemoryError as err:
            refused.append({"batch": batch, "error": str(err)[:200]})
        else:
            print(json.dumps({"phase": "f32_tuning_batch", "batch": batch,
                              "out_of_memory": refused}))
            return launches
        gc.collect()  # the failed step's tensors, freed with its traceback
        torch.cuda.empty_cache()
    fail(f"f32 tuning: no batch of {F32_TUNING_BATCHES} fits: {refused}")


def kernels_line(cases, paths):
    """The kernels record: one row per kernel, its launches on each path
    (``paths``: launch counts by path) and its times at the main path's
    heaviest site, with every timed site beside it."""
    fwd_cases = cases["sampling"] + cases["tuning_fwd"] + [cases["grid"]] + [
        c for c in cases["ragged"] if c["kernel"] != "flash_bwd"]
    bwd_cases = cases["tuning_bwd"] + [cases["grid_bwd"]] + [
        c for c in cases["ragged"] if c["kernel"] == "flash_bwd"]
    timed_keys = ("bh", "sq", "sk", "d", "ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms")

    def entry(name, source, replaces, site, errors, per_site,
              file="flash_kernels.py"):
        # the bf16 flash rows: "parent_ms" is the synchronous design the
        # wgmma kernels replaced, timed in this run
        parent = {"parent_ms": site["parent_ms"]} if "parent_ms" in site \
            else {}
        return {
            "name": name, "route": "cuda",
            "source": f"e4t_diffusion_torch/csrc/{source}",
            "replaces": f"e4t_diffusion_tpu/ops/{file}:{replaces}",
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {k: p[name] for k, p in paths.items()},
            "max_abs_err": max(errors), "ms": site["ms"],
            "plain_ms": site["plain_ms"], "bound_ms": site["bound_ms"],
            "bound_by": site["bound_by"], "library_ms": site["library_ms"],
            **parent,
            "at": f"BH={site['bh']} Sq={site['sq']} Sk={site['sk']} "
                  f"D={site['d']} {site.get('dtype', 'bfloat16')}",
            "per_site": [{k: c[k] for k in timed_keys + ("parent_ms",)
                          if k in c} for c in per_site]}

    low = [c for c in fwd_cases if c["kernel"] == "flash_fwd_lowdim"]
    wide = [c for c in fwd_cases if c["kernel"] == "flash_fwd_wide"]
    int8_flash = cases["int8_flash"] + [
        c for c in cases["ragged"] if c["kernel"] == "flash_fwd_int8"]
    convs = cases["int8_conv"] + [
        c for c in cases["ragged"] if c["kernel"] == "int8_conv"]
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
              cases["tuning_bwd"] + [cases["grid_bwd"]]),
        entry("flash_fwd_int8", "flash_fwd_int8.cu", 813,
              cases["int8_flash"][0], [c["out_max_abs"] for c in int8_flash],
              cases["int8_flash"])]
    kernels[1]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:95"
    kernels[2]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:582"
    kernels[3]["at"] = kernels[3]["at"].replace(
        "bf16", "int8 q/k, bf16 v, mode qk")
    kernels[3]["per_site"] = [
        {k: c[k] for k in ("mode", "tile") + timed_keys
         + ("ms_by", "route_ms", "parent_ms")} for c in cases["int8_flash"]]
    conv_keys = ("c", "o", "h", "w", "k", "stride", "pad",
                 "sites_per_unet_pass", "ms", "parent_ms", "plain_ms",
                 "old_route_ms", "route_ms", "bound_ms", "bound_by",
                 "route_bound_ms", "library_ms")
    site = max(cases["int8_conv"],
               key=lambda c: c["sites_per_unet_pass"] * c["ms"])
    kernels.append({
        "name": "int8_conv", "route": "cuda",
        "source": "e4t_diffusion_torch/csrc/int8_conv.cu",
        "replaces": "e4t_diffusion_tpu/ops/quant.py:276",
        "replaces_note": "an XLA convolution in the JAX package; PyTorch "
                         "has no int8 conv2d on CUDA",
        "launches": sum(p["int8_conv"] for p in paths.values()),
        "launches_by_path": {k: p["int8_conv"] for k, p in paths.items()},
        "max_abs_err": max(max(c["out_max_abs"], c["f32_out_max_abs"])
                           for c in convs),
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
        "library_ms": site["library_ms"], "library": site["library"],
        "parent_ms": site["parent_ms"],
        "at": f"N={site['n']} {site['c']}->{site['o']} at "
              f"{site['h']}x{site['w']} {site['k']}x{site['k']} stride "
              f"{site['stride']} int8 NHWC, bf16 out (the largest share "
              f"of a UNet pass)",
        "routes": "old_route_ms: PyTorch quantization, NHWC permute, the "
                  "kernel; route_ms: quant.int8_conv2d (x quantized in the "
                  "kernel's loads), bf16 NCHW x on a static scale",
        "per_unet_pass": {
            key: sum(c["sites_per_unet_pass"] * c[key]
                     for c in cases["int8_conv"])
            for key in ("ms", "parent_ms", "old_route_ms", "route_ms",
                        "library_ms", "bound_ms", "route_bound_ms")},
        "per_site": [{k: c[k] for k in conv_keys}
                     for c in cases["int8_conv"]]})
    quants = cases["int8_quantize"]
    site = max(quants, key=lambda c: c["sites_per_unet_pass"] * c["ms"])
    q_keys = ("shape", "sites_per_unet_pass", "ms", "plain_ms", "bound_ms",
              "bound_by")
    kernels.append({
        "name": "int8_quantize", "route": "cuda",
        "source": "e4t_diffusion_torch/csrc/quantize.cu",
        "replaces": "e4t_diffusion_tpu/ops/quant.py:251",
        "replaces_note": "XLA elementwise ops in the JAX package "
                         "(_quantize_activation) at the linear sites",
        "launches": sum(p["int8_quantize"] for p in paths.values()),
        "launches_by_path": {k: p["int8_quantize"]
                             for k, p in paths.items()},
        "max_abs_err": max(c["out_max_abs"] for c in quants + [
            c for c in cases["ragged"] if c["kernel"] == "int8_quantize"]),
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
        "library_ms": None,
        "at": f"x {tuple(site['shape'])} bf16 -> int8, static scale (the "
              f"largest share of a UNet pass)",
        "times": "device time under torch.profiler below 0.1 ms, else CUDA "
                 "events",
        "per_unet_pass": {key: sum(c["sites_per_unet_pass"] * c[key]
                                   for c in quants)
                          for key in ("ms", "plain_ms", "bound_ms")},
        "per_site": [{k: c[k] for k in q_keys} for c in quants]})

    gn = cases["group_norm"]
    gn_all = gn["unet"] + gn["vae_decode"] + [
        c for c in cases["ragged"] if c["kernel"] == "group_norm"]
    gn_keys = ("n", "c", "h", "w", "groups", "act", "layout", "sites", "ms",
               "wall_ms", "parent_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "library_wall_ms")
    site = max(gn["unet"], key=lambda c: c["sites"] * c["ms"])

    def per_run(part):
        return {key: sum(c["sites"] * c[key] for c in gn[part])
                for key in ("ms", "wall_ms", "parent_ms", "plain_ms",
                            "library_ms", "library_wall_ms", "bound_ms")}

    kernels.append({
        "name": "group_norm", "route": "cuda",
        "source": "e4t_diffusion_torch/csrc/group_norm.cu",
        "replaces": "e4t_diffusion_tpu/ops/groupnorm.py:117",
        "launches": sum(p["group_norm"] for p in paths.values()),
        "launches_by_path": {k: p["group_norm"] for k, p in paths.items()},
        "max_abs_err": max(c["out_max_abs"] for c in gn_all),
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
        "library_ms": site["library_ms"], "library": site["library"],
        "parent_ms": site["parent_ms"],
        "at": f"N={site['n']} C={site['c']} {site['h']}x{site['w']} "
              f"G={site['groups']} act={site['act']} {site['layout']} bf16 "
              f"(the largest share of a UNet pass)",
        "times": "device time under torch.profiler; wall_ms: CUDA events "
                 "around one call",
        "per_unet_pass": per_run("unet"),
        "per_vae_decode": per_run("vae_decode"),
        "per_site": {part: [{k: c[k] for k in gn_keys} for c in gn[part]]
                     for part in ("unet", "vae_decode")}})
    short = [c for c in cases["shortseq"] + cases["ragged"]
             if c["kernel"] == "flash_fwd_shortseq"]
    kernels.append(entry("flash_fwd_shortseq", "flash_fwd_shortseq.cu", 896,
                         cases["shortseq"][0],
                         [c["out_max_abs"] for c in short],
                         cases["shortseq"]))
    kernels[-1]["times"] = kernels[-2]["times"]
    kernels[-1]["per_site"] = [
        {k: c[k] for k in timed_keys + ("g", "wall_ms", "library_wall_ms",
                                        "parent_ms")}
        for c in cases["shortseq"]]
    kernels += _f32_rows(cases, entry, timed_keys)
    return kernels


def _f32_rows(cases, entry, timed_keys):
    """The kernels line's rows of the f32 kernels (``csrc/attention_f32.cu``
    and the int8 kernel's f32 epilogue), each at its heaviest path site."""
    ragged = cases["f32_ragged"]
    fwd = cases["f32_sampling"] + cases["f32_tuning_fwd"] + ragged

    def errors(name, keys=("out_max_abs",)):
        return [c[k] for c in fwd + cases["f32_tuning_bwd"]
                + cases["f32_shortseq"] + cases["f32_int8_flash"]
                if c["kernel"] == name for k in keys]

    def timed(name, group):
        return [c for c in cases[group] if c["kernel"] == name]

    wide = timed("flash_fwd_wide_f32", "f32_tuning_fwd")
    rows = [
        entry("flash_fwd_lowdim_f32", "attention_f32.cu", 286,
              cases["f32_sampling"][0], errors("flash_fwd_lowdim_f32"),
              [c for c in fwd if c["kernel"] == "flash_fwd_lowdim_f32"
               and "ms" in c]),
        entry("flash_fwd_wide_f32", "attention_f32.cu", 196,
              next(c for c in wide if c["sq"] == c["sk"]),
              errors("flash_fwd_wide_f32"), wide),
        entry("flash_bwd_f32", "attention_f32.cu", 503,
              cases["f32_tuning_bwd"][0],
              errors("flash_bwd_f32", ("dq_max_abs", "dk_max_abs",
                                       "dv_max_abs")),
              cases["f32_tuning_bwd"]),
        entry("flash_fwd_shortseq_f32", "attention_f32.cu", 896,
              cases["f32_shortseq"][0], errors("flash_fwd_shortseq_f32"),
              cases["f32_shortseq"])]
    rows[1]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:95"
    rows[2]["also_replaces"] = "e4t_diffusion_tpu/ops/flash_kernels.py:582"
    for mode, source in (("qk", "attention_f32.cu"),
                         ("qkpv", "flash_fwd_int8.cu")):
        name = f"flash_fwd_int8_{mode}_f32"
        sites = timed(name, "f32_int8_flash")
        row = entry(name, source, 813, sites[0], errors(name), sites)
        row["at"] = row["at"].replace(
            "float32", f"int8 q/k, {'int8' if mode == 'qkpv' else 'f32'} v, "
                       f"f32 out, mode {mode}")
        rows.append(row)
    return rows


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

    for knob in ROUTE_KNOBS:  # the default paths run with the routes off
        os.environ.pop(knob, None)
    smi = run("environment", phase_environment)
    run("build", phase_build)
    cases = run("kernels", phase_kernels)
    sampling, pipe, image, warm_s = run("sampling", phase_main_path, smi)
    int8_sampling = run("int8_sampling", phase_int8_sampling, smi, pipe,
                        image)
    routes_sampling = run("routes_sampling", phase_routes_sampling, smi,
                          pipe, image, warm_s)
    f32_sampling = run("f32_sampling", phase_f32_sampling, smi, pipe, image)
    del pipe
    torch.cuda.empty_cache()
    tuning, first_step = run("tuning", phase_tuning, smi)
    torch.cuda.empty_cache()
    routes_tuning, _ = run("routes_tuning", phase_tuning, smi, 2, True,
                           first_step)
    torch.cuda.empty_cache()
    run("tiny_card_vs_cpu", phase_tiny_vs_cpu)
    f32_tuning_tiny = run("f32_tuning_vs_cpu", phase_f32_tuning_vs_cpu)
    f32_tuning = run("f32_tuning", phase_f32_tuning, smi)
    torch.cuda.empty_cache()
    paths = {"sampling": sampling, "int8_sampling": int8_sampling,
             "routes_sampling": routes_sampling,
             "f32_sampling": f32_sampling, "tuning": tuning,
             "routes_tuning": routes_tuning,
             "f32_tuning_vs_cpu": f32_tuning_tiny, "f32_tuning": f32_tuning}

    kernels = kernels_line(cases, paths)
    print(json.dumps({"phase_seconds": timings,
                      "profiler_empty": PROFILER_EMPTY}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
