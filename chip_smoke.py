#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its wall seconds):
1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, TF32 switched off for matmuls and convolutions;
2. build: nvcc compiles every kernel source of the port, all at once,
   and g++ the data loader's native image transform beside them;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes and at ragged shapes, with times, the work's
   bound and a library call of the same function as a yardstick; the int8
   conv also at every distinct conv of a batch-8 512px VAE decode, the
   quantization kernel at the ViT-H's and the VAE's linear inputs, and the
   ViT-H's patch conv on its route (all bit for bit);
4. sampling: StableDiffusionE4TPipeline at full SD-v1 width (UNet, VAE,
   CLIP-L text, ViT-H-14 E4T encoder) with seeded random bf16 weights,
   two prompts x 4 images at 512px, CFG 7.5, DDIM and DPM++ 2M;
4a. components: ``time_components`` on phase 4's modules (batch 8,
   512px): per-call ms by CUDA events of the UNet forward (bf16, int8 on
   dynamic and static scales, the int8 attention over bf16 and over static
   int8), the forward with the E4T tap, the text encoder, the ViT-H encode
   and the VAE decode (bf16 and their int8 towers), the fuse head and the
   offset fold, with ``*_mfu`` against the bf16 peak (``utils/flops.py``);
   each row's launches against its calls, every MFU in (0, 1];
4a'. vit_ablations: ``time_vit`` on phase 4's ViT-H tower at batch 8:
   base, tanh GELU, no attention products, no block LayerNorms, and the
   short-sequence route (32 launches a forward);
4b. schedulers: the same under PLMS (STEPS + 1 model evaluations), LMS,
   Euler and Euler-ancestral, each twice with one seed;
5. int8_sampling: the same pipeline serving the UNet in int8: static
   activation scales (calibrated on the first call) under DDIM and DPM++,
   then dynamic scales with the int8 attention kernel in "qk" and "qkpv"
   mode; the UNet's eps on the kernels against the same int8 path on the
   plain versions, and the int8 error against bf16;
5b. serving: the batch server (``serve_e4t.main``) on phase 4's weights
   written as a model directory: 20 prompts at batch 8, DDIM-4, a LoRA
   file, ``--int8 --int8_static_act --int8_aux_static`` (the ViT-H and the
   VAE decode in int8); the manifest and PNGs, the int8 towers against
   bf16 towers, LoRA on against off, one ViT-H encode and one VAE decode
   timed in bf16 and in int8;
5c. validate_real_weights: the one-command real-weights chain
   (``python -m e4t_diffusion_torch.validate_real_weights``) on phase 5b's
   model directory, started when 5b ends and run beside phases 6 to 10c:
   the checkpoint staged onto ``--sd_dir``, one tuning step and bf16 and
   static int8 sampling at 2 steps, each a process; its record's keys, the
   staged config, the tuned artifact, the samples and a finite int8 delta
   checked after phase 10c;
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
   f32, in static int8, in f32 with ``E4T_FUSED_GN=1`` and in f32 under
   each of PLMS, LMS, Euler and Euler-ancestral;
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
   largest batch of 16, 8 and 4 that the card holds;
13. pretraining: phase-1 pretraining (``pretrain_e4t.pretrain``, what the
   CLI runs after loading) at the same width, bf16 compute, batch 16,
   512px, from 40 written images of mixed sizes through the loader (its
   native transform, the default: held within 2/127.5 of cv2's on every
   written image, both timed a batch) and the
   device prefetch: 3 steps with a checkpoint at step 2 and a DDIM-4
   sample after each, then one step resumed from that checkpoint; the
   checkpoint read back bit for bit at its save and its restore, the
   schedule's count after the resume, the frozen modules bit for bit, the
   artifact loaded strictly and tuned one step;
14. routes_pretraining: one step from the same weights with both routes
   on, its loss and grad norm against phase 13's first step;
15. f32_pretraining: two steps with ``--mixed_precision no`` (the CLI's
   default) at the largest batch of 16, 8 and 4 that the card holds;
16. parallel: (a) the flash forward and backward on each half of the
   heads (the batch where the heads are odd) against the whole call, bit
   for bit; (b) 4 tuning steps (batch 16, 512px, ``--tensor_parallel
   1``), 4 bf16 pretraining steps and 4 ``--zero1`` steps through a
   one-rank NCCL process group against the same steps without it, bit for
   bit (metrics, trainables, optimizer state, checkpoint), the median of
   the warm steps with and without the group and the gradient bytes dp > 1
   all-reduces per update; (c) the inference CLI with
   ``--data_parallel_serving`` (2 steps) and a 1-step ``pretrain_e4t
   --zero1`` under
   ``torchrun --nproc_per_node 1`` against the same runs without torchrun,
   bit for bit (the grid, the checkpoint, the artifacts), the four
   processes at once while (a) and (e) run; (e) the bf16
   UNet's noise prediction and input gradient at tp=2, two ranks on the
   one card over gloo, against tp=1 and f32 (within ``TP_BF16_RATIO``
   times bf16's own error); (d) with two or more cards, a dp=2 f32
   pretraining step and tp=2 and dp=2 sampling under NCCL against world
   size 1 (``python3 chip_smoke.py --multi-card`` runs (d) alone,
   ``--parallel`` the whole phase alone); the world sizes run and the card
   count on a line of their own;
10b. unclip (after f32_sampling, before tuning): the Stable-unCLIP
   image-variation path at full SD2.1-unclip width (SD2 UNet with
   64-dim heads and the projection class embedding, the 23-layer
   OpenCLIP-H text encoder, the HF ViT-H image encoder with its
   projection, the 768px VAE, a normalizer) with seeded random bf16
   weights, written as a diffusers-format directory and run through
   ``image_variation_augmentation.main --mode unclip`` at its defaults
   (2 source images, 4 variations each, DPM++ 20 steps, CFG 10, 768px):
   8 JPEGs; then the CLI's pipeline called directly: images finite and in
   [0, 1], the same seed twice bit for bit, noise level 500 against 0, a
   CFG-1.0 call at batch 4, one call with both opt-in routes on (every
   GroupNorm on its kernel, the mid block's 144-token self-attention on the
   short-sequence kernel) against the routes off, one batch-8 UNet pass on the flash kernel against einsum,
   one UNet pass and one 768px VAE decode with the routes on against off,
   peak memory, a profile;
10c. clip_score: ``evaluate_clip_scores.main`` with a full-width
   ``CLIPScorer`` (ViT-H-14 and the 24-layer OpenCLIP-H text tower, f32,
   seeded random weights written as an open_clip state dict) over the
   unclip phase's JPEGs: scores finite and in [-1, 1], a source image
   against itself 1 within 1e-3, the scores with ``E4T_SHORTSEQ_MH_ATTN=8``
   (the ViT-H's sites on the f32 short-sequence kernel) against the route
   off.
15b. training_extras (after f32_pretraining, before parallel): the
   training CLIs' last flags. (a) The 8-bit AdamW kernel
   (``csrc/adam8bit.cu``) against its plain version at every trainable
   tensor of a tuning step, two updates from the same gradients, codes,
   scales and parameters bit for bit, timed beside the plain version and
   torch's f32 AdamW on the same tensors (a yardstick, not the same
   function), and at pretraining's trainables; (b) 5 tuning steps with
   ``--use_8bit_adam`` (batch 16, 512px, ``--report_to tensorboard``,
   ``--profile_steps 1``): updates 1 and 2 held against the plain version
   fed the same gradients (``_adam8bit_held``), the first step against
   phase 7's, the optimizer state's bytes, peak memory and the warm step
   against phase 7's; (c) 3 tuning steps with ``--remat_policy dots`` at the largest of
   16, 8 and 4 that fits: the first step, peak memory and the warm step
   against phase 7's; (d) 11 pretraining steps with ``--use_8bit_adam
   --zero1`` through a one-rank NCCL group (``--profile_steps 1``: the
   window [10, 11)), a checkpoint at step 10 read back bit for bit at its
   save and at the restore of one resumed step, updates 1, 2 and the
   resumed 11 held against the plain version; (e) the two traces parsed:
   their host ops and device-kernel events (printed with the phase times,
   beside ``profiler_empty``);
15c. sd2_e4t (after training_extras, before parallel; ``python3
   chip_smoke.py --sd2`` runs it alone, after the build and its kernel
   cases): E4T on a full-width SD 2.1 base (``UNetConfig.sd2``, the
   23-layer OpenCLIP-H text tower, v-prediction, 768px) with seeded
   random bf16 weights written as a diffusers directory:
   ``pretrain_e4t.main`` (2 bf16 steps at batch 16, a checkpoint and the
   artifact), ``tuning_e4t.main`` from that artifact (3 bf16 steps at
   batch 16; both at the largest of 16, 8 and 4 that fits, their
   resolution from the UNet's sample_size), each with finite losses and
   grad norms, every trained group changed and every frozen one bit for
   bit, and the 8-bit AdamW kernel at every tensor the tuning step trains
   against its plain version; then ``inference.build_pipeline`` on the
   tuned artifact: DDIM-4 twice (bit for bit) and DPM++ 2M-4 (2 prompts x
   4 images, CFG 7.5), a UNet pass on flash against einsum, static int8
   against bf16, dynamic int8 with ``int8_attn="qkpv"`` and both opt-in
   routes on (the short-sequence kernel at the 144-token mid block, the
   GroupNorm kernel) against bf16, a profile;
Phase 9 also runs the tiny unCLIP pipeline and a tiny SD2-flavoured E4T
pipeline (v-prediction, DDIM and DPM++) in f32 on the card against the
CPU with the same draws. The kernels phase holds the low-dim forward at
the unCLIP UNet's three flash sites (d64: BH 40 x 9216², 80 x 2304², 160 x
576²), the d64 forward and backward at the SD 2.1 training step's eight
sites (batch 16: BH 80 x 9216², 160 x 2304², 320 x 576² and 144², self
and 77-token cross attention), the int8 attention kernel at the SD 2.1
UNet's three d64 serving sites in both modes, the int8 conv and
quantization kernels at every distinct conv and linear input of an SD 2.1
UNet pass (batch 8, 768px), and the GroupNorm kernel at every site of an
SD2-unclip UNet pass (batch 8, 96²) and a 768px VAE decode (batch 4).
In phases 4 to 8, 10, 10b, 10c and 12 to 16 (4a, 4a', 4b, 5b, 15b and
15c included) the kernels' launch counters, set to 0 just before each run
and read just after, must show the path went through every kernel it
routes to, as many times as its attention, conv, linear and GroupNorm
sites give. The two
routes are off by default, and off in every other phase but where phases
10, 10b and 10c name one.

The second-to-last line of output is a JSON ``kernels`` record, the last
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import math
import os
import re
import statistics
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
# LoRA on against off (rank 4, up ~ N(0, 0.02^2)), same weights and
# inputs: the adapters move the images by more than any rounding does
LORA_EFFECT_REL_L2 = 1e-2
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
# the first pretraining step's loss and grad norm with both routes on vs
# off: the UNet is frozen and the VAE encode's GroupNorm sites join them;
# measured 2.8e-5 on both (H100 80GB HBM3, 700 W), so 1e-3 leaves room for
# rounding and still sees a site that normalises wrongly
PRETRAIN_ROUTE_REL = 1e-3
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense bf16 and int8
# tensor-core rates and f32 on the CUDA cores (FFMA) from the port's
# utils/flops.py; exp2 on the special-function units: 16 per clock per SM
# (CUDA C++ Programming Guide throughput table, compute capability 9.0) x
# 132 SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
try:
    from e4t_diffusion_torch.utils.flops import (
        H100_BF16_PEAK as BF16_FLOP_PER_S, H100_F32_PEAK as F32_FLOP_PER_S,
        H100_INT8_PEAK as INT8_OP_PER_S)
except ImportError:  # not a checkout: main() says so and fails
    BF16_FLOP_PER_S = F32_FLOP_PER_S = INT8_OP_PER_S = None
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


@contextlib.contextmanager
def _tee_stdout(copy):
    """Standard output written through as always and also into ``copy``
    (a text buffer) for the block."""
    real = sys.stdout

    class Tee:
        def write(self, text):
            copy.write(text)
            return real.write(text)

        def flush(self):
            real.flush()

    sys.stdout = Tee()
    try:
        yield
    finally:
        sys.stdout = real


# profiler sessions that came back with no device record, and device_time
# calls that fell back to CUDA events after three of them (printed with the
# phase times)
PROFILER_EMPTY = {"sessions": 0, "sessions_without_host_events": 0,
                  "events_fallbacks": 0}


def _note_empty(prof):
    PROFILER_EMPTY["sessions"] += 1
    if not len(prof.events()):
        PROFILER_EMPTY["sessions_without_host_events"] += 1


# set once _device_events has been held against key_averages in a run
_DEVICE_EVENTS_HELD = []


def _device_events(prof):
    """{kernel name: [device us, count]} of a profiler session: its device
    records that are not user annotations, read off kineto's raw events as
    ``key_averages`` reads them (names demangled, an asynchronous record
    counted with no time). ``key_averages`` gives the same self device
    times but first builds the host ops' event tree in Python, which took
    most of the script's profiling time (seconds to tens of seconds a
    trace). The first session with device records in a run is held against
    ``key_averages``: the same names, counts and times (to 1e-6), or the
    run fails."""
    import torch
    from torch.autograd import DeviceType

    rows, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        row = rows.setdefault(names[raw], [0.0, 0])
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            row[0] += e.duration_ns() / 1e3
        row[1] += 1
    if rows and not _DEVICE_EVENTS_HELD:
        ref = {}
        for evt in prof.key_averages():
            if (evt.device_type == DeviceType.CUDA
                    and not getattr(evt, "is_user_annotation", False)):
                row = ref.setdefault(evt.key, [0.0, 0])
                row[0] += evt.self_device_time_total
                row[1] += evt.count
        bad = [k for k in set(rows) | set(ref)
               if k not in rows or k not in ref or rows[k][1] != ref[k][1]
               or abs(rows[k][0] - ref[k][0]) > 1e-6 * max(ref[k][0], 1.0)]
        if bad:
            fail(f"profiler: kineto's device records disagree with "
                 f"key_averages at {len(bad)} kernels, e.g. "
                 f"{[(k, rows.get(k), ref.get(k)) for k in bad[:3]]}")
        _DEVICE_EVENTS_HELD.append(len(rows))
    return rows


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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(us for us, _ in _device_events(prof).values())
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
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if any(us > 0 for us, _ in _device_events(prof).values()):
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
    """One nvcc per kernel source (per part of ``attention_f32.cu``), all
    started together."""
    from e4t_diffusion_torch.ops import (_build, adam8bit, flash_bwd,
                                         flash_int8, flash_lowdim, groupnorm,
                                         int8_conv, quant, shortseq)

    from e4t_diffusion_torch.data import native_ops

    sources = [flash_lowdim.SOURCE, flash_bwd.SOURCE, flash_int8.SOURCE,
               int8_conv.SOURCE, groupnorm.SOURCE, shortseq.SOURCE,
               *flash_lowdim.F32_PARTS, quant.QUANTIZE_SOURCE,
               adam8bit.SOURCE]
    t0 = time.perf_counter()
    # the loader's native transform (g++) beside the nvcc builds
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        native = pool.submit(native_ops.build)
        logs = list(pool.map(_build.build, sources))
        native_lib = native.result()
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
            elif "adam8bit_kernel" in ln:
                name = "adam8bit_kernel"
            elif "registers" in ln or re.search(
                    r"(?<!\d)[1-9]\d* bytes spill", ln):
                usage[src].append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    print(json.dumps({"phase": "build", "sources": sources,
                      "native": os.path.relpath(native_lib, os.path.dirname(
                          os.path.abspath(__file__))),
                      "native_build": native_ops.build_log().splitlines()[0],
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


def _chunked(plain, n, *tensors):
    """``plain`` (a function of (BH, S, D) tensors and more arguments,
    independent across BH) evaluated over ``n`` slices of BH and joined:
    the same values, with ``n`` times less of its score tensors live."""
    import torch

    def run(*rest):
        parts = [plain(*(t.chunk(n)[i] for t in tensors), *rest)
                 for i in range(n)]
        return tuple(torch.cat(group) for group in zip(*parts))
    return run


def _fwd_case(bh, sq, sk, d, gen, timed, dtype=None, plain_chunks=1):
    """The forward kernel of ``dtype`` (bf16 by default, or f32) against its
    plain version in f32, and against the synchronous design it replaced,
    within the same bound (bf16: the wgmma kernel against
    ``flash_fwd_sync``; f32: the register-blocked kernel against
    ``flash_fwd_f32_sync``, out and lse); timed: kernel, plain, SDPA's
    forward in the same type, the bound, and the synchronous design
    (``parent_ms``). ``plain_chunks``: the plain version runs over that
    many slices of BH (``_chunked``), where its f32 scores would not fit
    whole, and is then timed over one call (after a warm one)."""
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

    def plain():
        return _chunked(flash_fwd_reference, plain_chunks, q.float(),
                        k.float(), v.float())(scale)

    ref_out, ref_lse = plain()
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
            plain_ms=cuda_time_ms(plain, reps=1 if plain_chunks > 1
                                  else 3 if _f32(dtype) else 20),
            library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale)),
            **_bound(size * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq,
                     4 * bh * sq * sk * d, bh * sq * sk,
                     flop_rate=F32_FLOP_PER_S if _f32(dtype)
                     else BF16_FLOP_PER_S),
            parent_ms=cuda_time_ms(lambda: sync(q, k, v, scale)))
    if plain_chunks > 1:
        case["plain_chunks"] = plain_chunks
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return case


def _bwd_case(bh, sq, sk, d, gen, timed, dtype=None, plain_chunks=1):
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
    bound, and timed beside it (``parent_ms``). ``plain_chunks`` as in
    ``_fwd_case``."""
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
        return _chunked(flash_bwd_reference, plain_chunks, *f32[:4], lse,
                        f32[4])(scale)

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
            plain_ms=cuda_time_ms(plain, reps=1 if plain_chunks > 1
                                  else 3 if _f32(dtype) else 20),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qr, kr, vr), dout[None], retain_graph=True)),
            **_bound(q.element_size() * (4 * bh * sq * d + 4 * bh * sk * d)
                     + 4 * bh * sq, 10 * bh * sq * sk * d, bh * sq * sk,
                     flop_rate=F32_FLOP_PER_S if _f32(dtype)
                     else BF16_FLOP_PER_S),
            parent_ms=cuda_time_ms(lambda: sync(q, k, v, out, lse, dout,
                                                scale)))
        del qr, kr, vr, lib_out
    if plain_chunks > 1:
        case["plain_chunks"] = plain_chunks
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


def _unet_conv_shapes(batch, resolution, unet_config=None):
    """{(C, O, H, W, k, stride, pad): sites} of the quantized UNet convs in
    one forward of ``unet_config`` (SD v1's by default), read off a forward
    on the meta device."""
    import torch

    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.ops import quant

    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_config or UNetConfig())
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


def _unet_linear_shapes(batch, resolution, unet_config=None):
    """{input shape: sites} of the quantized UNet linear sites in one
    forward of ``unet_config`` (SD v1's by default; SD 2.x's linear
    proj_in / proj_out among them), read off a forward on the meta
    device."""
    import torch

    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.ops import quant

    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_config or UNetConfig())
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


def _aux_site_shapes(batch, resolution, towers=("e4t", "vae")):
    """The int8 sites of one ViT-H encode and one VAE decode of an int8-aux
    run at ``batch`` and ``resolution`` (``towers``: of those named only),
    read off forwards on the meta device: {"conv": {(C, O, H, W, k, stride,
    pad): sites} of the decoder's quantized convs (the conv kernel's),
    "linear": {input shape: sites} of the quantized linear sites and of the
    ViT-H's patch conv, whose NHWC input goes to the quantization
    kernel}."""
    import types

    import torch

    from e4t_diffusion_torch.diffusion.pipeline import _aux_sites
    from e4t_diffusion_torch.models.e4t_encoder import (E4TEncoder,
                                                        E4TEncoderConfig)
    from e4t_diffusion_torch.models.vae import AutoencoderKL, VAEConfig
    from e4t_diffusion_torch.ops import quant

    with torch.device("meta"):
        mods = types.SimpleNamespace(vae=AutoencoderKL(VAEConfig()),
                                     e4t_encoder=E4TEncoder(
                                         E4TEncoderConfig()))
    shapes = {"conv": {}, "linear": {}}

    def record(mod, args):
        x = args[0]
        if not isinstance(mod, quant.Conv2d):
            part, key = "linear", tuple(x.shape)
        elif mod.kernel_size[0] == mod.stride[0] > 1:  # the patch route
            p = mod.stride[0]
            part, key = "linear", (x.shape[0], x.shape[2] // p * p,
                                   x.shape[3] // p * p, x.shape[1])
        else:
            part, key = "conv", (x.shape[1], mod.out_channels, x.shape[2],
                                 x.shape[3], mod.kernel_size[0],
                                 mod.stride[0], mod.padding[0])
        shapes[part][key] = shapes[part].get(key, 0) + 1

    for model, sites in _aux_sites(mods, None):
        modules = quant.site_modules(model)
        for name in sites:
            modules[name].register_forward_pre_hook(record)
    with torch.device("meta"):
        if "e4t" in towers:
            mods.e4t_encoder.encode_image(
                torch.zeros(batch, 3, resolution, resolution))
        if "vae" in towers:
            mods.vae.decode(torch.zeros(batch, 4, resolution // 8,
                                        resolution // 8))
    return shapes


def _vae_conv_case(n, c, o, h, w, k, stride, pad, gen, sites):
    """The int8 conv at a VAE-decoder site through its route
    (``quant.int8_conv2d``: x quantized in the kernel's loads) against its
    plain version ``int8_conv_act_reference``, bit for bit, x bf16 and f32
    NCHW in each scale mode (static per-tensor "sa", per-channel "sac",
    dynamic). Timed from bf16 x: the route on a static scale (the kernel
    alone) and on the dynamic one (with its abs-max reduction), the plain
    version, cuDNN's bf16 conv2d of the same shapes, and the bound (x and
    the output in bf16 once each, the int8 weight, the int8 products)."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    xb = torch.randn(n, c, h, w, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    wb = torch.randn(o, c, k, k, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    bias = torch.randn(o, device="cuda", generator=gen)
    site = quant.quantize_kernel(wb)
    site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
    site["w"] = wb
    modes = _conv_sites(site, xb)
    tiles = -(-o // ic.TILE_N)
    case = {"kernel": "int8_conv", "n": n, "c": c, "o": o, "h": h, "w": w,
            "k": k, "stride": stride, "pad": pad, "sites_per_decode": sites,
            "n_tile_fill": o / (tiles * ic.TILE_N)}
    for dtype in (torch.bfloat16, torch.float32):
        xr, b = xb.to(dtype), bias.to(dtype)
        for mode, s_ in modes.items():
            per_channel = mode == "sac"
            act = (s_["sac"] if per_channel
                   else s_.get("sa", quant.dynamic_scale(xr))).reshape(-1)
            before = ic.int8_conv_act.launches
            got = quant.int8_conv2d(xr, s_, b, stride, pad)
            torch.cuda.synchronize()
            want = ic.int8_conv_act_reference(xr, s_["q"], act.float(),
                                              per_channel, s_["s"], b,
                                              stride, pad)
            if not (torch.equal(got, want)
                    and ic.int8_conv_act.launches == before + 1):
                fail(f"int8_conv_act at a VAE site ({dtype}, {mode}) "
                     f"disagrees with int8_conv_act_reference: {case}")
            del got, want
        del xr
        torch.cuda.empty_cache()
    case["out_max_abs"] = case["f32_out_max_abs"] = 0.0
    case["route_checks"] = 2 * len(modes)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    b16 = bias.to(torch.bfloat16)
    static = modes["sa"]
    case.update(
        ms=cuda_time_ms(lambda: quant.int8_conv2d(xb, static, b16, stride,
                                                  pad)),
        dynamic_ms=cuda_time_ms(lambda: quant.int8_conv2d(
            xb, modes["dynamic"], b16, stride, pad)),
        plain_ms=cuda_time_ms(lambda: ic.int8_conv_act_reference(
            xb, static["q"], static["sa"].reshape(-1), False, static["s"],
            b16, stride, pad), reps=1),
        library_ms=cuda_time_ms(lambda: F.conv2d(xb, wb, b16, stride=stride,
                                                 padding=pad)),
        library="torch.nn.functional.conv2d (cuDNN), bf16",
        **_bound(2 * n * c * h * w + o * k * k * c + 6 * o
                 + 2 * n * o * ho * wo, 0, 0,
                 int8_ops=2 * n * ho * wo * o * k * k * c))
    del xb, wb, site, modes
    torch.cuda.empty_cache()
    return case


def _patch_conv_case(n, gen):
    """The ViT-H's conv1 (3 -> 1280, 14x14 at stride 14, no bias) on its
    route (``quant.int8_patch_conv``: the quantization kernel, then
    ``torch._int_mm`` over the patch matrix) against
    ``int8_conv_act_reference``, bit for bit, x bf16 and f32 in each scale
    mode; one quantization launch and no conv launch a call. Timed from
    bf16 x on a static scale beside the plain version, cuDNN's bf16 conv2d
    and the bound."""
    import torch
    import torch.nn.functional as F

    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    xb = torch.randn(n, 3, 224, 224, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    wb = torch.randn(1280, 3, 14, 14, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    site = quant.quantize_kernel(wb)
    site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
    site["w"] = wb
    modes = _conv_sites(site, xb)
    case = {"kernel": "int8_patch_conv", "n": n, "c": 3, "o": 1280,
            "h": 224, "w": 224, "k": 14, "stride": 14, "pad": 0,
            "sites_per_aux_run": 1}
    for dtype in (torch.bfloat16, torch.float32):
        xr = xb.to(dtype)
        for mode, s_ in modes.items():
            per_channel = mode == "sac"
            act = (s_["sac"] if per_channel
                   else s_.get("sa", quant.dynamic_scale(xr))).reshape(-1)
            counts = (quant.quantize_activation.launches,
                      ic.int8_conv_act.launches)
            got = quant.int8_conv2d(xr, s_, None, 14, 0)
            torch.cuda.synchronize()
            want = ic.int8_conv_act_reference(xr, s_["q"], act.float(),
                                              per_channel, s_["s"], None,
                                              14, 0)
            if not (torch.equal(got, want)
                    and (quant.quantize_activation.launches,
                         ic.int8_conv_act.launches)
                    == (counts[0] + 1, counts[1])):
                fail(f"conv1's patch route ({dtype}, {mode}) disagrees with "
                     f"int8_conv_act_reference: {case}")
    case.update(out_max_abs=0.0, route_checks=2 * len(modes))
    static = modes["sa"]
    ops = 2 * n * 256 * 1280 * 14 * 14 * 3
    case.update(
        ms=small_aware_ms(lambda: quant.int8_conv2d(xb, static, None, 14,
                                                    0))[0],
        plain_ms=small_aware_ms(lambda: ic.int8_conv_act_reference(
            xb, static["q"], static["sa"].reshape(-1), False, static["s"],
            None, 14, 0))[0],
        library_ms=small_aware_ms(lambda: F.conv2d(xb, wb, None,
                                                   stride=14))[0],
        library="torch.nn.functional.conv2d (cuDNN), bf16",
        **_bound(2 * n * 3 * 224 * 224 + 1280 * 588 + 4 * 1280
                 + 2 * n * 1280 * 256, 0, 0, int8_ops=ops))
    del xb, wb, site, modes
    torch.cuda.empty_cache()
    return case


def _group_norm_sites(unet_config, vae_config, batch, resolution,
                      device="meta", parts=None):
    """{"unet", "unet_tap", "vae_decode", "vae_encode": {(C, H, W, groups,
    eps, act, layout): sites}}: the GroupNorm sites of one UNet pass (full,
    and the tap pass that stops after the mid block), one VAE decode and
    one VAE encode (or only the ``parts`` named), read off forwards of bf16
    models on ``device``.
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
    # the Stable-unCLIP UNet's projection class embedding takes class labels
    def labels():
        return ({} if unet_config.class_embed_type is None else {
            "class_labels": torch.zeros(
                batch, unet_config.projection_class_embeddings_input_dim)})

    runs = {
        "unet": lambda: unet(torch.zeros(batch, 4, side, side),
                             torch.zeros(batch), torch.zeros(
                                 batch, 77, unet_config.cross_attention_dim),
                             **labels()),
        "unet_tap": lambda: unet(torch.zeros(batch, 4, side, side),
                                 torch.zeros(batch), torch.zeros(
                                     batch, 77,
                                     unet_config.cross_attention_dim),
                                 return_encoder_outputs=True, **labels()),
        "vae_decode": lambda: vae.decode(torch.zeros(batch, 4, side, side)),
        "vae_encode": lambda: vae.encode(
            torch.zeros(batch, 3, resolution, resolution))}
    unet_mod.group_norm_act = vae_mod.group_norm_act = record
    try:
        for name, run in runs.items():
            if parts is not None and name not in parts:
                continue
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

    from e4t_diffusion_torch.ops.shortseq import heads_per_cell

    gen = torch.Generator("cuda").manual_seed(0)
    # sampling's two flash sites at 512px, batch 8 (BH = 8 x 8 heads)
    sampling = [_fwd_case(64, 4096, 4096, 40, gen, timed=True),
                _fwd_case(64, 1024, 1024, 80, gen, timed=True)]
    # the Stable-unCLIP UNet's three flash sites at 768px, batch 8 (4
    # variations x CFG; 5, 10 and 20 heads of 64)
    unclip_flash = [_fwd_case(8 * heads, side * side, side * side, 64, gen,
                              timed=True) for heads, side in UNCLIP_FLASH]
    torch.cuda.empty_cache()
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
    # int8-aux serving: every distinct quantized conv of a batch-8 512px VAE
    # decode, every distinct input of the quantization kernel in one ViT-H
    # encode and one decode, and the ViT-H's patch conv on its route
    aux = _aux_site_shapes(n, RESOLUTION)
    int8_conv_vae = [_vae_conv_case(n, *key, gen, sites=sites)
                     for key, sites in sorted(aux["conv"].items())]
    int8_quantize_aux = []
    for shape, sites in sorted(aux["linear"].items()):
        int8_quantize_aux.append(_quantize_case(shape, gen, timed=True))
        int8_quantize_aux[-1]["sites_per_aux_run"] = sites
    vit_conv1 = _patch_conv_case(n, gen)
    # the opt-in routes: every distinct GroupNorm site of a batch-8 512px
    # UNet pass and VAE decode, of the VAE encode a pretraining step runs at
    # batch 16, and the ViT-H's attention sites when sampling (BH = 8 x 16
    # heads) and tuning (16 x 16)
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
    # the encode's layouts as the card gives them at the pretraining batch
    encode_sites = _group_norm_sites(UNetConfig(), VAEConfig(),
                                     PRETRAIN_BATCH, RESOLUTION,
                                     "cuda")["vae_encode"]
    group_norm["vae_encode"] = [
        _gn_case(PRETRAIN_BATCH, c, h, w, groups, eps, act, layout,
                 torch.bfloat16, gen, timed=True, sites=count)
        for (c, h, w, groups, eps, act, layout), count in sorted(
            encode_sites.items(), key=str)]
    torch.cuda.empty_cache()
    # the unCLIP path: an SD2-unclip UNet pass at batch 8, 96² latents, and
    # a 768px VAE decode at batch 4, in the layouts the card gives them
    ucfg2, vcfg2 = (UNetConfig.sd2_unclip(),
                    VAEConfig(sample_size=UNCLIP_RESOLUTION))
    unclip_unet = _group_norm_sites(ucfg2, vcfg2, UNCLIP_BATCH,
                                    UNCLIP_RESOLUTION, "cuda", ("unet",))
    unclip_decode = _group_norm_sites(ucfg2, vcfg2, UNCLIP_IMAGES,
                                      UNCLIP_RESOLUTION, "cuda",
                                      ("vae_decode",))
    torch.cuda.empty_cache()
    for part, batch, sites in (
            ("unclip_unet", UNCLIP_BATCH, unclip_unet["unet"]),
            ("vae_decode_768", UNCLIP_IMAGES, unclip_decode["vae_decode"])):
        group_norm[part] = [
            _gn_case(batch, c, h, w, groups, eps, act, layout,
                     torch.bfloat16, gen, timed=True, sites=count)
            for (c, h, w, groups, eps, act, layout), count in sorted(
                sites.items(), key=str)]
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
    # the unCLIP UNet's mid block with the knob on: 144 tokens, BH 8 x 20
    # heads of 64
    short.append(_shortseq_case(
        UNCLIP_BATCH * 20, 144, 64,
        heads_per_cell(UNCLIP_BATCH * 20, int(ROUTE_KNOBS[
            "E4T_SHORTSEQ_MH_ATTN"])), gen, timed=True))
    for bh, s_, d, g in ((2, 129, 8, 1), (4, 200, 40, 2), (16, 384, 64, 8),
                         (32, 512, 120, 16)):
        ragged.append(_shortseq_case(bh, s_, d, g, gen, timed=False))
    # the redesigned bf16 low-dim forward at the edges of its kv ring: Sk
    # below one 64-row stage, one stage plus one row, two plus one, one row;
    # and a q tile of one row
    for d, sq, sk in ((40, 100, 63), (80, 64, 65), (64, 129, 129),
                      (16, 1, 200), (48, 200, 1), (40, 257, 4096)):
        ragged.append(_fwd_case(2, sq, sk, d, gen, timed=False))
    sd2_fwd, sd2_bwd, sd2_int8 = _sd2_kernel_cases(gen)
    f32_cases = _f32_kernel_cases(gen, n)
    cases = {"sampling": sampling, "unclip_flash": unclip_flash,
             "sd2_fwd": sd2_fwd, "sd2_bwd": sd2_bwd, "sd2_int8": sd2_int8,
             "tuning_fwd": tuning_fwd, "grid": grid,
             "tuning_bwd": tuning_bwd, "grid_bwd": grid_bwd,
             "int8_flash": int8_flash, "int8_conv": int8_conv,
             "int8_quantize": int8_quantize, "int8_conv_vae": int8_conv_vae,
             "int8_quantize_aux": int8_quantize_aux, "vit_conv1": vit_conv1,
             "group_norm": group_norm, "shortseq": short,
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

    from e4t_diffusion_torch.ops.shortseq import heads_per_cell

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
        # the ViT-H at batch 8 and 16, and the CLIP scorer's ViT-H-14 at
        # batch 1 (BH 16) with E4T_SHORTSEQ_MH_ATTN's heads per cell
        "f32_shortseq": [_shortseq_case(bh, 257, 80, 8, gen, True, f32)
                         for bh in (8 * 16, 16 * 16)] + [_shortseq_case(
                             16, 257, 80, heads_per_cell(16, int(ROUTE_KNOBS[
                                 "E4T_SHORTSEQ_MH_ATTN"])), gen, True, f32)],
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
               "flash_fwd_int8_qk_f32", "flash_fwd_int8_qkpv_f32",
               "adam8bit")
# low-dim flash sites per sampling step at batch >= 5: 10 per UNet forward,
# two forwards a step; the d=160 sites stay on einsum below 128 MiB
LOWDIM_SITES_PER_STEP = 20


def _reset_launches():
    from e4t_diffusion_torch.ops.adam8bit import adam8bit_update
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
    adam8bit_update.launches = 0


def _read_launches():
    from e4t_diffusion_torch.ops.adam8bit import adam8bit_update
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
            "flash_fwd_int8_qkpv_f32": flash_fwd_int8.launches["qkpv_f32"],
            "adam8bit": adam8bit_update.launches}


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


@contextlib.contextmanager
def _flash_shapes():
    """Yields a dict that counts, for the block, the flash forward's calls
    from ``ops/attention`` by "BHxSqxSkxD" (the wrapper itself counts its
    launches as always)."""
    from e4t_diffusion_torch.ops import attention

    shapes, real = {}, attention.flash_fwd

    def tally(q, k, v, *args):
        key = f"{q.shape[0]}x{q.shape[1]}x{k.shape[1]}x{q.shape[2]}"
        shapes[key] = shapes.get(key, 0) + 1
        return real(q, k, v, *args)

    attention.flash_fwd = tally
    try:
        yield shapes
    finally:
        attention.flash_fwd = real


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


# device time by kernel family in a profile: the first family with a mark
# in the kernel's name (the port's kernels, cuDNN's layout conversions and
# convolutions, GEMMs, norms, the optimizer, elementwise and reductions)
KERNEL_FAMILIES = (
    ("port_attention", ("flash_", "shortseq_", "attn_f32")),
    ("port_group_norm", ("group_norm_",)),
    ("port_int8", ("int8_conv", "quantize_kernel")),
    ("layout_conversion", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution", ("conv", "cudnn", "implicit_gemm", "xmma_fprop",
                     "xmma_dgrad", "xmma_wgrad")),
    ("gemm", ("gemm", "cutlass", "sm90_xmma", "ampere_", "Kernel2")),
    ("norm", ("norm", "layer_norm")),
    ("optimizer", ("multi_tensor", "adam")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "copy", "fill", "cat")))


def _profile(run):
    """Device time by kernel over one call of ``run`` (wall time is taken
    under the profiler, so the busy share is a lower bound), and the share
    of it the f32 attention kernels take (``csrc/attention_f32.cu``, whose
    kernels are named attn_*). The device numbers are None ("not
    measured") when three sessions held no device record."""
    prof, wall_us, traced = _traced(run)
    rows, attn_us = [], 0.0
    # kernels only: host ops, and annotated ranges such as the optimizer
    # step, whose device time is that of the kernels they hold, are not
    # device records
    for key, (dev_us, count) in _device_events(prof).items():
        if dev_us > 0:
            rows.append((dev_us, key[:80], count))
            if "attn_" in key:
                attn_us += dev_us
    if not traced:
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": None,
                "device_busy_share": None, "f32_attention_ms": None,
                "f32_attention_share_of_busy": None, "top": [],
                "device_trace": "empty in three sessions"}
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    families = {}
    for us, key, _ in rows:
        family = next((f for f, marks in KERNEL_FAMILIES
                       if any(m in key for m in marks)), "other")
        families[family] = families.get(family, 0.0) + us / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "f32_attention_ms": attn_us / 1e3,
            "f32_attention_share_of_busy": attn_us / max(busy_us, 1e-9),
            "families_ms": families,
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


COMPONENT_ITERS = 10
VIT_ABLATION_ITERS = 10


def phase_components(smi, pipe):
    """``time_components.time_components`` in process on the main path's
    SD v1 modules (bf16) and offsets, batch 8, 512px: every row, bf16, int8
    on dynamic and on calibrated static scales, the int8 attention rows,
    each row's launches (reset just before it, read just after) against
    those derived from its calls, and every ``*_mfu`` in (0, 1]."""
    from e4t_diffusion_torch import time_components as tc

    n = len(PROMPTS) * IMAGES_PER_PROMPT
    per_fwd = LOWDIM_SITES_PER_STEP // 2
    unet_conv = sum(_unet_conv_shapes(n, RESOLUTION).values())
    unet_quant = sum(_unet_linear_shapes(n, RESOLUTION).values())
    tower = {t: _aux_site_shapes(n, RESOLUTION, (t,)) for t in ("e4t", "vae")}
    results, launches, forwards = {}, {}, {}
    total = _want()
    for row in tc.ROWS:
        _reset_launches()
        res = tc.time_components(pipe.modules, pipe.offsets, n, RESOLUTION,
                                 COMPONENT_ITERS, rows=[row])
        got = _read_launches()
        calls = res["calls"][row]
        calib = res["calib_calls"].get(row, 0)
        forwards[row] = calls + calib
        if row.startswith("unet_fwd"):
            attn = row.endswith("_attn")
            int8 = row in ("unet_fwd_int8", "unet_fwd_int8_static",
                           "unet_fwd_int8_static_attn")
            want = _want(
                flash_fwd_lowdim=per_fwd * (calib + (0 if attn else calls)),
                flash_fwd_int8=per_fwd * calls if attn else 0,
                int8_conv=unet_conv * calls if int8 else 0,
                int8_quantize=unet_quant * calls if int8 else 0)
        elif "int8" in row:
            shapes = tower["e4t" if row.startswith("vit") else "vae"]
            want = _want(int8_conv=sum(shapes["conv"].values()) * calls,
                         int8_quantize=sum(shapes["linear"].values()) * calls)
        else:
            want = _want()
        if got != want:
            fail(f"components: {row}: launches {got}, expected {want} "
                 f"({calls} calls, {calib} calibration)")
        for k, v in got.items():
            total[k] += v
        launches[row] = {k: v for k, v in got.items() if v}
        results.update({k: v for k, v in res.items()
                        if k.startswith(row + "_")})
    mfu = {k: v for k, v in results.items() if k.endswith("_mfu")}
    flash_per_unet_fwd = {
        row: (launches[row].get("flash_fwd_lowdim", 0)
              + launches[row].get("flash_fwd_int8", 0)) / forwards[row]
        for row in tc.ROWS if row.startswith("unet_fwd")}
    report = {"phase": "components", "card": smi, "batch": n,
              "resolution": RESOLUTION, "iters": COMPONENT_ITERS,
              **results, "est_cfg_step_ms": sum(results[f"{r}_ms"] for r in (
                  "unet_fwd_with_tap", "unet_fwd", "text_encoder",
                  "e4t_fuse")),
              "flash_launches_per_unet_forward": flash_per_unet_fwd,
              "launches": launches}
    print(json.dumps(report))
    if sorted(mfu) != sorted(f"{r}_mfu" for r in tc.row_flops(
            pipe.modules, n, RESOLUTION)):
        fail(f"components: MFU rows {sorted(mfu)}")
    if not all(0.0 < v <= 1.0 for v in mfu.values()):
        fail(f"components: an MFU outside (0, 1]: {mfu}")
    if set(flash_per_unet_fwd.values()) != {per_fwd}:
        fail(f"components: flash launches per UNet forward "
             f"{flash_per_unet_fwd}, derived {per_fwd}")
    return total


def phase_vit_ablations(smi, pipe):
    """``time_vit.time_vit`` in process on the main path's ViT-H-14 tower
    (bf16) at batch 8: base, gelu_tanh, no_attn, no_ln (towers sharing its
    weights) and shortseq (``E4T_SHORTSEQ_MH_ATTN=8``): the shortseq row's
    launches are the short-sequence kernel's, 32 a forward (its layers'
    sites, by the port's route), the other rows' none; every ``*_mfu`` in
    (0, 1]."""
    from e4t_diffusion_torch import time_vit

    batch = len(PROMPTS) * IMAGES_PER_PROMPT
    tower = pipe.modules.e4t_encoder.clip_vision
    sites = _vit_shortseq_sites(tower.config, batch)
    if sites != tower.config.num_layers:
        fail(f"vit_ablations: {sites} short-sequence sites, expected "
             f"{tower.config.num_layers}")
    results, launches = {}, {}
    total = _want()
    for row in time_vit.CONFIGS:
        _reset_launches()
        res = time_vit.time_vit(tower, batch, VIT_ABLATION_ITERS, [row])
        got = _read_launches()
        want = _want(flash_fwd_shortseq=sites * res["calls"][row]
                     if row == "shortseq" else 0)
        if got != want:
            fail(f"vit_ablations: {row}: launches {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
        launches[row] = {k: v for k, v in got.items() if v}
        results.update({k: v for k, v in res.items()
                        if k.startswith(row + "_")})
    report = {"phase": "vit_ablations", "card": smi, "batch": batch,
              "iters": VIT_ABLATION_ITERS, **results,
              "shortseq_launches_per_forward": launches["shortseq"].get(
                  "flash_fwd_shortseq", 0) / (VIT_ABLATION_ITERS + 1),
              "launches": launches}
    print(json.dumps(report))
    mfu = [v for k, v in results.items() if k.endswith("_mfu")]
    if len(mfu) != len(time_vit.CONFIGS) or not all(
            0.0 < v <= 1.0 for v in mfu):
        fail(f"vit_ablations: an MFU outside (0, 1]: {results}")
    return total


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


def phase_schedulers(smi, pipe, image):
    """Phase 4's pipeline under the other four samplers, PLMS, LMS, Euler
    and Euler-ancestral, each twice with one seed (Euler-ancestral draws its
    per-step noise from the run's generator). Each model evaluation runs
    the 20 low-dim flash sites of two UNet passes; PLMS evaluates the model
    STEPS + 1 times."""
    import numpy as np

    from e4t_diffusion_torch.diffusion.schedulers import SCHEDULER_MAPPING

    n = len(PROMPTS) * IMAGES_PER_PROMPT
    report = {"phase": "schedulers", "card": smi, "batch": n,
              "resolution": RESOLUTION, "steps": STEPS, "guidance": 7.5,
              "runs": {}}
    total = _want()
    for name in ("plms", "lms", "euler", "euler_ancestral"):
        evals = len(SCHEDULER_MAPPING[name]().init(STEPS)["timesteps"])
        if evals != STEPS + (name == "plms"):
            fail(f"{name}: {evals} model evaluations for {STEPS} steps")
        want = _want(flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * evals)
        first, first_s, launches = _sample(pipe, image, name, want)
        second, warm_s, _ = _sample(pipe, image, name, want)
        rerun = float(np.abs(first - second).max())
        if not rerun <= RERUN_MAX_ABS:
            fail(f"{name}: two same-seed runs differ by {rerun}")
        for k, v in launches.items():
            total[k] += 2 * v
        report["runs"][name] = {
            "model_evaluations": evals, "first_s": first_s, "warm_s": warm_s,
            "images_per_s": n / warm_s, "rerun_max_abs": rerun,
            "launches": launches}
    print(json.dumps(report))
    return total


SERVE_PROMPTS = 20
SERVE_BATCH = 8
SERVE_LORA_RANK = 4


def _write_serving_artifact(root, pipe):
    """Phase 4's weights (bf16) as a user's model directory: a
    diffusers-format SD base (unet/, vae/, text_encoder/, tokenizer/,
    scheduler/) and the E4T artifact that names it (config.json,
    encoder.pt, weight_offsets.pt). Returns the artifact's path."""
    import dataclasses

    import torch

    from e4t_diffusion_torch.config import save_config
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

    mods = pipe.modules
    tcfg = mods.text_encoder.config
    base = os.path.join(root, "sd")
    parts = {
        "unet": (dataclasses.asdict(mods.unet.config), mods.unet,
                 "diffusion_pytorch_model.bin"),
        "vae": (dataclasses.asdict(mods.vae.config), mods.vae,
                "diffusion_pytorch_model.bin"),
        "text_encoder": ({
            "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
            "num_hidden_layers": tcfg.num_layers,
            "num_attention_heads": tcfg.num_heads,
            "intermediate_size": tcfg.intermediate_size,
            "max_position_embeddings": tcfg.max_position_embeddings,
            "layer_norm_eps": tcfg.layer_norm_eps,
            "hidden_act": tcfg.hidden_act}, mods.text_encoder,
            "pytorch_model.bin")}

    def save(state, path):
        torch.save({k: v.detach().cpu() for k, v in state.items()}, path)

    for sub, (config, module, weights) in parts.items():
        os.makedirs(os.path.join(base, sub))
        with open(os.path.join(base, sub, "config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(config, f)
        save(module.state_dict(), os.path.join(base, sub, weights))
    os.makedirs(os.path.join(base, "scheduler"))
    with open(os.path.join(base, "scheduler", "scheduler_config.json"), "w",
              encoding="utf-8") as f:
        json.dump(dataclasses.asdict(NoiseScheduleConfig()), f)
    make_tiny_tokenizer_files(os.path.join(base, "tokenizer"), extra_words=[
        "a", "photo", "of", "face", "in", "monet", "style"])
    artifact = os.path.join(root, "e4t")
    save_config({"pretrained_model_name_or_path": base,
                 "placeholder_token": "*s", "domain_class_token": "face",
                 "domain_embed_scale": 0.1}, artifact)
    save(mods.e4t_encoder.state_dict(), os.path.join(artifact, "encoder.pt"))
    save(pipe.offsets, os.path.join(artifact, "weight_offsets.pt"))
    return artifact


def _tower_times(pipe):
    """One batch-8 ViT-H encode (512px pixels) and one VAE decode (64x64
    latents) in bf16 and with the int8 towers on dynamic and on the
    pipeline's calibrated scales: CUDA events, median of 5."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import _aux_sites
    from e4t_diffusion_torch.ops import quant

    n = SERVE_BATCH
    gen = torch.Generator("cuda").manual_seed(9)
    mods = pipe.modules
    pixel = torch.rand(n, 3, RESOLUTION, RESOLUTION, device="cuda",
                       generator=gen) * 2.0 - 1.0
    z = torch.randn(n, 4, RESOLUTION // 8, RESOLUTION // 8, device="cuda",
                    generator=gen)
    runs = {"vit_encode": lambda: mods.e4t_encoder.encode_image(pixel),
            "vae_decode": lambda: mods.vae.decode(z)}
    times = {}
    with torch.inference_mode():
        for flavor, amax in (("bf16", None), ("int8_dynamic", None),
                             ("int8_static", pipe.aux_amax)):
            with contextlib.ExitStack() as stack:
                if flavor != "bf16":
                    for model, sites in _aux_sites(mods, amax):
                        stack.enter_context(quant.int8_sites(model, sites))
                for name, fn in runs.items():
                    times[f"{name}_{flavor}_ms"] = cuda_time_ms(fn, reps=5)
    return times


def phase_serving(smi, pipe, root):
    """The batch server (``serve_e4t.main``) as a user runs it: phase 4's
    weights written as a model directory under ``root`` (``root/sd``, the
    artifact ``root/e4t``; the caller keeps it for the
    ``validate_real_weights`` chain), 20 prompts at batch 8 (two full
    batches and one padded), DDIM-4 at 512px, CFG 7.5, a LoRA file of rank
    4 with non-zero ``up``, ``--int8 --int8_static_act --int8_aux_static``.
    The first batch calibrates the UNet (E4T_INT8_CALIB_STEPS bf16 steps)
    and then the towers on that run's final latents. Checks: the manifest
    and the PNGs; the launches of the whole serve and of one more run of
    the first batch, derived from the UNet's and the towers' sites; that
    run's images against the same run with bf16 towers (rel-L2) and
    without the LoRA file (they differ), and against the served PNGs.
    Times one ViT-H encode and one VAE decode in bf16 and on the int8
    towers."""
    import numpy as np
    import torch
    from PIL import Image

    from e4t_diffusion_torch import serve_e4t
    from e4t_diffusion_torch.diffusion.pipeline import (
        StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.models import lora

    n = SERVE_BATCH
    calib_steps = int(os.environ.get("E4T_INT8_CALIB_STEPS", "8"))
    unet_conv = 2 * sum(_unet_conv_shapes(n, RESOLUTION).values()) * STEPS
    unet_quant = 2 * sum(_unet_linear_shapes(n, RESOLUTION).values()) * STEPS
    aux = _aux_site_shapes(n, RESOLUTION)
    aux_conv, aux_quant = (sum(aux["conv"].values()),
                           sum(aux["linear"].values()))
    per_run = _want(flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS,
                    int8_conv=unet_conv + aux_conv,
                    int8_quantize=unet_quant + aux_quant)
    n_batches = -(-SERVE_PROMPTS // n)
    want_serve = {k: n_batches * v for k, v in per_run.items()}
    want_serve["flash_fwd_lowdim"] += LOWDIM_SITES_PER_STEP * calib_steps
    words = ["in monet style", "face", "photo"]
    prompts = [" ".join(["a photo of *s"] + [words[i % 3]] * (1 + i // 3))
               for i in range(SERVE_PROMPTS)]
    report = {"phase": "serving", "card": smi, "prompts": SERVE_PROMPTS,
              "batch": n, "resolution": RESOLUTION, "steps": STEPS,
              "guidance": 7.5, "calib_steps": calib_steps,
              "flags": "--int8 --int8_static_act --int8_aux_static "
                       f"--lora_weights (rank {SERVE_LORA_RANK})",
              "aux_conv_sites": aux_conv, "aux_quantize_sites": aux_quant}
    t0 = time.perf_counter()
    artifact = _write_serving_artifact(root, pipe)
    gen = torch.Generator().manual_seed(11)
    bank = lora.init_lora_bank(pipe.modules.unet.config,
                               SERVE_LORA_RANK, generator=gen)
    for layers in bank.values():
        for layer in layers.values():
            layer["up"] = 0.02 * torch.randn(layer["up"].shape,
                                             generator=gen)
    lora_path = os.path.join(root, "pytorch_lora_weights.bin")
    torch.save(lora.lora_to_torch(bank), lora_path)
    image_path = os.path.join(root, "in.png")
    Image.fromarray(np.random.default_rng(12).integers(
        0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)).save(
            image_path)
    with open(os.path.join(root, "prompts.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(prompts) + "\n")
    out = os.path.join(root, "served")
    report["write_s"] = time.perf_counter() - t0
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spipe, record = serve_e4t.main([
        "--pretrained_model_name_or_path", artifact,
        "--image_path", image_path,
        "--prompts_file", os.path.join(root, "prompts.txt"),
        "--batch_size", str(n), "--num_inference_steps", str(STEPS),
        "--guidance_scale", "7.5", "--height", str(RESOLUTION),
        "--width", str(RESOLUTION), "--seed", "0", "--output_dir", out,
        "--int8", "--int8_static_act", "--int8_aux_static",
        "--lora_weights", lora_path])
    torch.cuda.synchronize()
    report["serve_s"] = time.perf_counter() - t0
    report["launches"] = launches = _read_launches()
    if launches != want_serve:
        fail(f"serving: launches {launches}, expected {want_serve}")
    with open(os.path.join(out, "manifest.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    pngs = sorted(p for p in os.listdir(out) if p.endswith(".png"))
    if ([r["prompt"] for r in rows] != prompts
            or pngs != [f"{i:05d}.png" for i in range(SERVE_PROMPTS)]):
        fail(f"serving: manifest {len(rows)} rows, PNGs {pngs}")
    report["record"] = record
    report["images_per_s_by_batch"] = [
        min(n, SERVE_PROMPTS - i * n) / wall
        for i, wall in enumerate(record["batch_walls_s"])]
    served0 = np.asarray(Image.open(os.path.join(out, "00000.png")),
                         np.float32) / 255.0

    first = prompts[:n]
    pixels = np.random.default_rng(12).integers(
        0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)

    def render(p, want):
        _reset_launches()
        out = p(first, pixels, num_inference_steps=STEPS, guidance_scale=7.5,
                height=RESOLUTION, width=RESOLUTION, seed=0)
        got = _read_launches()
        if got != want:
            fail(f"serving: launches {got}, expected {want}")
        if not (np.isfinite(out).all() and out.shape == (
                n, 3, RESOLUTION, RESOLUTION)):
            fail(f"serving: output {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
        return out

    def variant(**kwargs):
        p = StableDiffusionE4TPipeline(
            spipe.modules, spipe.offsets, spipe.tokenizer, spipe.e4t_config,
            already_added_placeholder_token=True, int8="static",
            act_scales=spipe.act_amax, **kwargs)
        p.aux_amax = spipe.aux_amax
        return p

    t0 = time.perf_counter()
    served = render(spipe, per_run)
    report["run_s"] = time.perf_counter() - t0
    report["served_png_vs_run_max_abs"] = float(np.abs(
        served0 - served[0].transpose(1, 2, 0)).max())
    bf16_towers = render(
        variant(lora_bank=spipe.lora_bank, lora_scale=spipe.lora_scale),
        _want(flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS,
              int8_conv=unet_conv, int8_quantize=unet_quant))
    no_lora = render(variant(int8_aux="static"), per_run)
    report["int8_towers_vs_bf16_towers_rel_l2"] = _rel(
        torch.from_numpy(served), torch.from_numpy(bf16_towers))
    report["lora_on_vs_off_rel_l2"] = _rel(torch.from_numpy(served),
                                           torch.from_numpy(no_lora))
    report.update(_tower_times(spipe))
    print(json.dumps(report))
    if not (report["served_png_vs_run_max_abs"] <= RERUN_MAX_ABS + 1 / 255
            and report["int8_towers_vs_bf16_towers_rel_l2"]
            <= INT8_VS_BF16_REL_L2
            and report["lora_on_vs_off_rel_l2"] >= LORA_EFFECT_REL_L2):
        fail(f"serving: {report}")
    total = {k: want_serve[k] + 2 * per_run[k] + v for k, v in _want(
        flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS, int8_conv=unet_conv,
        int8_quantize=unet_quant).items()}
    del spipe
    torch.cuda.empty_cache()
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
        d = dim // ucfg.heads_for_block(level)
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
                 dtype=None, batch=16, extra=(), name=None, untimed=1):
    """Phase-2 tuning at full width through ``tuning_e4t.tune`` with the
    CLI's defaults (batch 16, 512px, lr 1.6e-5, clip 1.0) in ``dtype``
    (bf16, ``--mixed_precision bf16``, by default; f32 is ``no``), from
    seeded weights; ``extra``: more CLI flags (the training extras, whose
    run ``name`` prints; ``untimed``: the first calls left out of the warm
    step's time). ``routes``: both opt-in routes on, and the first
    step's loss and grad norm held against ``routes_off``, the first step's
    metrics of a run with the routes off. Returns (launches, summary: the
    first step's metrics, peak memory, the warm step's seconds (the calls
    after the first outside a profile window), the optimizer's state
    bytes, the trace directory and the printed output)."""
    import io

    import torch

    from e4t_diffusion_torch import seeded, tuning_e4t
    from e4t_diffusion_torch.training.optim8bit import state_bytes
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.templates import resolve_templates

    dtype = dtype or torch.bfloat16
    f32 = _f32(dtype)

    def cli_args(max_steps):
        return tuning_e4t.parse_args([
            "--pretrained_model_name_or_path", "-", "--train_image_path",
            "-", "--max_train_steps", str(max_steps), "--mixed_precision",
            "no" if f32 else "bf16", "--train_batch_size", str(batch),
            "--resolution", str(RESOLUTION), *extra])

    args = cli_args(steps)
    t0 = time.perf_counter()
    modules, offsets, tokenizer, class_id, image = seeded.tuning_world(
        args.resolution)
    ucfg, ecfg = modules.unet.config, modules.e4t_encoder.config
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

    printed = io.StringIO()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (_routes_on() if routes else contextlib.nullcontext()), \
            _tee_stdout(printed):
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
    if args.use_8bit_adam:
        want["adam8bit"] = steps  # one launch an update
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
    elif not extra:
        report["profile"] = _profile(lambda: run(cli_args(1)))
    # after the untimed calls where there are more, outside the profile
    # window
    window = range(2, 2 + args.profile_steps)
    steady = [t for i, t in enumerate(result["step_seconds"])
              if i >= untimed and i not in window] or result["step_seconds"]
    s_per_step = sum(steady) / len(steady)
    summary = {"first_step": metrics[0], "peak_gb": peak / 1e9,
               "s_per_step": s_per_step,
               "step_seconds": result["step_seconds"],
               "optimizer_state_bytes": state_bytes(result["optimizer"]),
               "profile_dir": result["profile_dir"],
               "printed": printed.getvalue()}
    print(json.dumps({
        "phase": name or ("routes_tuning" if routes else "f32_tuning" if f32
                          else "tuning"), "card": smi, "flags": list(extra),
        "dtype": str(dtype)[6:],
        "knobs": ROUTE_KNOBS if routes else {}, "setup_s": setup_s,
        "batch": args.train_batch_size, "resolution": args.resolution,
        "steps": steps, "wall_s": wall,
        "trainable_params": sum(t.numel() for g in trained.values()
                                for t in g.values()),
        "step_seconds": result["step_seconds"], "s_per_step": s_per_step,
        "samples_per_s": args.train_batch_size / s_per_step,
        "max_memory_allocated_gb": peak / 1e9,
        "optimizer_state_bytes": summary["optimizer_state_bytes"],
        "metrics": metrics, "launches": launches,
        "launches_per_step": per_step, **report}))
    return launches, summary


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
    sched_err = _tiny_schedulers_vs_cpu(cpu, card, offsets, cfg, image,
                                        latents, steps)
    print(json.dumps({"phase": "tiny_card_vs_cpu", "max_abs": err,
                      "schedulers_max_abs": sched_err,
                      "unclip_max_abs": _tiny_unclip_vs_cpu(),
                      "sd2_e4t_max_abs": _tiny_sd2_vs_cpu(),
                      "int8_calibration_rel": amax_err,
                      "int8_max_abs": err8,
                      "int8_vs_f32_max_abs_cpu": int8_err,
                      "fused_gn_max_abs": err_gn,
                      "fused_gn_launches": gn_launches,
                      "fused_gn_vs_off_max_abs_cpu": float(
                          np.abs(outs_gn[0] - outs[0]).max())}))


def _tiny_schedulers_vs_cpu(cpu, card, offsets, cfg, image, latents, steps):
    """The tiny f32 pipeline under PLMS, LMS, Euler and Euler-ancestral on
    the card and on the CPU, each side drawing Euler-ancestral's per-step
    noise from one CPU generator (the card's and the CPU's generators give
    other numbers for one seed): max-abs of the images by sampler."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion import pipeline as pl
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    errors = {}
    saved = pl._step_noise
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["a", "photo", "of",
                                                        "face"])
        try:
            for name in ("plms", "lms", "euler", "euler_ancestral"):
                outs = []
                for mods in (cpu, card):
                    noise = torch.Generator().manual_seed(7)
                    pl._step_noise = (
                        lambda shape, generator, device, dtype, g=noise:
                        torch.randn(shape, generator=g).to(device, dtype))
                    pipe = pl.StableDiffusionE4TPipeline(
                        mods, offsets, CLIPTokenizer.from_pretrained(
                            tok_dir, model_max_length=16), cfg)
                    outs.append(pipe(PROMPTS[:1] + ["a *s face"], image,
                                     num_inference_steps=steps,
                                     guidance_scale=7.5,
                                     num_images_per_prompt=2,
                                     latents=latents, scheduler_type=name))
                errors[name] = float(np.abs(outs[0] - outs[1]).max())
        finally:
            pl._step_noise = saved
    if not all(e <= TINY_CARD_VS_CPU_MAX_ABS for e in errors.values()):
        fail(f"tiny pipeline, card vs CPU by sampler: max-abs {errors}")
    return errors


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

    def recording_optimizer(params, lr, **options):
        opt = make(params, lr, **options)
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


# phase-1 pretraining at the CLI's shapes (batch 16, 512px): 3 steps with a
# checkpoint at 2 and a sample after every step (one prompt, one input,
# DDIM-4), then 1 step resumed from that checkpoint; the images written for
# it, of mixed sizes and aspect ratios (PNG and JPEG)
# the Stable-unCLIP path at the augmentation CLI's defaults: 4 variations
# of each source image at 768px, CFG 10 (the UNet runs both halves at once:
# batch 8), DPM++ 20 steps, noise level 0
UNCLIP_RESOLUTION = 768
UNCLIP_IMAGES = 4
UNCLIP_BATCH = 2 * UNCLIP_IMAGES
UNCLIP_STEPS = 20
UNCLIP_GUIDANCE = 10.0
# (heads, latent side) of its flash sites: 64-dim heads at 96², 48², 24²
UNCLIP_FLASH = ((5, 96), (10, 48), (20, 24))
# the source images the phase writes (H, W): one square, one not
UNCLIP_SOURCES = ((640, 640), (600, 900))
# a 768px VAE decode in bf16 chains 30 GroupNorm sites: with the routes on
# and off it is held against the same decode in f32, and the routes-on
# error may be at most this multiple of the routes-off (ATen) error; a site
# that normalised wrongly would be O(1) off
ROUTE_DECODE_ERROR_RATIO = 2.0
# a whole bf16 call's images with both opt-in routes on against off, same
# seed: bf16 rounding apart through 20 UNet passes and the decode (measured
# 1.8e-2 on an H100 80GB HBM3 at 700 W); a site that normalised wrongly is
# O(1) off
UNCLIP_ROUTES_IMAGES_REL_L2 = 5e-2
# peak device memory over a warm call: 3.8 GB of bf16 weights, the 768px
# decode's activations and its 1.36 GB f32 mid-attention scores (measured
# 8.77 GB on an H100 80GB HBM3 at 700 W)
UNCLIP_PEAK_GB = 12.0
# CLIP-I of a source image against itself (features L2-normalised in f32)
CLIP_SELF_SCORE_ABS = 1e-3
# the scorer runs in f32: its scores (absolute) and one image's features
# (rel-L2) with the short-sequence route on against off are held to the f32
# path's tolerance, F32_PATH_REL_L2


def _expected_unclip_launches(ucfg, batch, resolution, steps, dtype=None,
                              routes=False):
    """Launches of one unCLIP call: one UNet pass a step at ``batch`` (CFG's
    two halves batched), a site on the short-sequence kernel where the
    port's ``shortseq_route`` sends it with both opt-in routes on
    (``routes``: the mid block's 144-token self-attention), else on flash
    where ``flash_route`` does, with the head count of its block; the
    image encoder, the text encoder and the VAE's mid attention run einsum
    (GroupNorm launches are not counted here)."""
    import torch

    from e4t_diffusion_torch.models.weight_offsets import attention_sites
    from e4t_diffusion_torch.ops.attention import flash_route, shortseq_route
    from e4t_diffusion_torch.ops.flash_lowdim import launch_route

    dtype = dtype or torch.bfloat16
    side = resolution // 8
    levels = len(ucfg.block_out_channels)
    want = dict.fromkeys(KERNEL_ROWS, 0)
    for path, dim, _ in attention_sites(ucfg):
        block, index = path.split(".")[:2]
        level = (levels - 1 - int(index) if block == "up_blocks"
                 else int(index) if block == "down_blocks" else levels - 1)
        heads = ucfg.heads_for_block(level)
        sq = (side >> level) ** 2
        sk = sq if path.endswith("attn1") else 77
        d = dim // heads
        q_shape, k_shape = (batch, heads, sq, d), (batch, heads, sk, d)
        with _routes_on() if routes else contextlib.nullcontext():
            short = shortseq_route(q_shape, k_shape, "cuda")
        if short:
            want["flash_fwd_shortseq" + (
                "_f32" if dtype == torch.float32 else "")] += steps
        elif flash_route(q_shape, k_shape, "cuda"):
            want[f"flash_fwd_{launch_route(d, dtype)}"] += steps
    return want


def _write_sd_model(root, unet, vae, text_encoder, extra=None,
                    noise_aug_schedule=None):
    """An SD v2-family model as a diffusers-format directory: unet/, vae/,
    text_encoder/ (their configs and weights as the modules hold them),
    scheduler/ (v-prediction), tokenizer/ (character-level, its ids inside
    the 49,408-row table); ``extra``: more folders, {name: (config,
    module, weight file)}; ``noise_aug_schedule``: an
    image_noising_scheduler/ folder."""
    import dataclasses

    import torch

    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

    tcfg = text_encoder.config
    parts = {
        "unet": (dataclasses.asdict(unet.config), unet,
                 "diffusion_pytorch_model.bin"),
        "vae": (dataclasses.asdict(vae.config), vae,
                "diffusion_pytorch_model.bin"),
        "text_encoder": ({
            "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
            "num_hidden_layers": tcfg.num_layers,
            "num_attention_heads": tcfg.num_heads,
            "intermediate_size": tcfg.intermediate_size,
            "max_position_embeddings": tcfg.max_position_embeddings,
            "layer_norm_eps": tcfg.layer_norm_eps,
            "hidden_act": tcfg.hidden_act}, text_encoder,
            "pytorch_model.bin"),
        **(extra or {})}
    for sub, (config, module, weights) in parts.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(config, f)
        torch.save({k: v.detach().cpu() for k, v in
                    module.state_dict().items()},
                   os.path.join(root, sub, weights))
    schedules = {"scheduler": NoiseScheduleConfig(
        prediction_type="v_prediction")}
    if noise_aug_schedule is not None:
        schedules["image_noising_scheduler"] = noise_aug_schedule
    for sub, config in schedules.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "scheduler_config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(dataclasses.asdict(config), f)
    make_tiny_tokenizer_files(os.path.join(root, "tokenizer"),
                              extra_words=["a", "photo", "of", "face"])
    return root


def _write_unclip_model(root, mods):
    """The unCLIP modules (bf16) as a diffusers-format
    stable-diffusion-2-1-unclip directory: ``_write_sd_model``'s folders,
    image_encoder/, image_normalizer/ and image_noising_scheduler/."""
    icfg = mods.image_encoder.config
    vis = icfg.vision
    return _write_sd_model(
        root, mods.unet, mods.vae, mods.text_encoder, extra={
            "image_encoder": ({
                "hidden_size": vis.hidden_size,
                "num_hidden_layers": vis.num_layers,
                "num_attention_heads": vis.num_heads,
                "intermediate_size": vis.intermediate_size,
                "image_size": vis.image_size, "patch_size": vis.patch_size,
                "projection_dim": icfg.projection_dim,
                "hidden_act": vis.hidden_act}, mods.image_encoder,
                "pytorch_model.bin"),
            "image_normalizer": ({"embedding_dim": icfg.projection_dim},
                                 mods.image_normalizer,
                                 "diffusion_pytorch_model.bin")},
        noise_aug_schedule=mods.noise_aug_schedule)


def _unclip_modules():
    """The full-width SD2.1-unclip stack, seeded random bf16 weights on the
    card, with a normalizer of positive std."""
    import torch

    from e4t_diffusion_torch.diffusion.unclip_pipeline import UnCLIPModules
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.unclip import CLIPVisionProjectionConfig
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig

    torch.manual_seed(20)
    mods = UnCLIPModules.create(
        UNetConfig.sd2_unclip(), VAEConfig(sample_size=UNCLIP_RESOLUTION),
        CLIPTextConfig.sd2(), CLIPVisionProjectionConfig(),
        dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator("cuda").manual_seed(21)
    norm = mods.image_normalizer
    with torch.no_grad():
        norm.mean.copy_(0.1 * torch.randn(norm.mean.shape, generator=gen,
                                          device="cuda"))
        norm.std.copy_(0.5 + torch.rand(norm.std.shape, generator=gen,
                                        device="cuda"))
    return mods


def _unclip_unet_checks(pipe):
    """One batch-8 UNet pass at 96² with the flash sites on the kernel
    against einsum attention everywhere, and with both routes on against
    off (rel-L2); one 768px VAE decode with the routes on and off, each
    against the decode in f32 (``ROUTE_DECODE_ERROR_RATIO``)."""
    import copy

    import torch

    from e4t_diffusion_torch.ops.attention import flash_threshold

    mods = pipe.modules
    ucfg = mods.unet.config
    side = UNCLIP_RESOLUTION // 8
    gen = torch.Generator("cuda").manual_seed(22)
    x = torch.randn(UNCLIP_BATCH, 4, side, side, device="cuda",
                    generator=gen)
    ctx = torch.randn(UNCLIP_BATCH, 77, ucfg.cross_attention_dim,
                      device="cuda", generator=gen)
    labels = torch.randn(UNCLIP_BATCH,
                         ucfg.projection_class_embeddings_input_dim,
                         device="cuda", generator=gen)
    z = torch.randn(UNCLIP_IMAGES, 4, side, side, device="cuda",
                    generator=gen)
    t = torch.full((UNCLIP_BATCH,), 500, device="cuda")
    out = {}
    with torch.inference_mode():
        eps = mods.unet(x, t, ctx, class_labels=labels).float()
        with flash_threshold(1 << 62):
            eps_plain = mods.unet(x, t, ctx, class_labels=labels).float()
        out["unet_kernel_vs_einsum_rel_l2"] = _rel(eps, eps_plain)
        del eps_plain
        torch.cuda.empty_cache()
        img = mods.vae.decode(z).float()
        with _routes_on():
            out["unet_routes_on_vs_off_rel_l2"] = _rel(
                mods.unet(x, t, ctx, class_labels=labels), eps)
            img_on = mods.vae.decode(z).float()
        del eps
        vae32 = copy.deepcopy(mods.vae).float()
        ref = vae32.decode(z.float())
        del vae32
    decode = {"vae_decode_routes_on_vs_off_rel_l2": _rel(img_on, img),
              "vae_decode_routes_off_vs_f32_rel_l2": _rel(img, ref),
              "vae_decode_routes_on_vs_f32_rel_l2": _rel(img_on, ref)}
    if not (max(out.values()) <= UNET_ROUTE_REL_L2
            and decode["vae_decode_routes_on_vs_f32_rel_l2"]
            <= ROUTE_DECODE_ERROR_RATIO
            * decode["vae_decode_routes_off_vs_f32_rel_l2"]):
        fail(f"unclip: UNet / VAE route checks {out} {decode}")
    return {**out, **decode}


def phase_unclip(smi, root):
    """The Stable-unCLIP augmentation CLI at its defaults on a written
    full-width SD2.1-unclip directory, then its pipeline called directly.
    Returns (the CLI run's launches, the files the clip_score phase
    reads)."""
    import numpy as np
    import torch
    from PIL import Image

    from e4t_diffusion_torch import image_variation_augmentation as aug
    from e4t_diffusion_torch.data.dataset import load_image_rgb

    report = {"phase": "unclip", "card": smi,
              "resolution": UNCLIP_RESOLUTION, "steps": UNCLIP_STEPS,
              "guidance": UNCLIP_GUIDANCE,
              "images_per_source": UNCLIP_IMAGES}
    t0 = time.perf_counter()
    mods = _unclip_modules()
    ucfg, vcfg = mods.unet.config, mods.vae.config
    report["params"] = sum(p.numel() for m in mods.all()
                           for p in m.parameters())
    model_dir = _write_unclip_model(os.path.join(root, "sd21-unclip"), mods)
    del mods
    torch.cuda.empty_cache()
    src = os.path.join(root, "sources")
    os.makedirs(src)
    rng = np.random.default_rng(23)
    for i, (h, w) in enumerate(UNCLIP_SOURCES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(src, f"{i}.png"))
    report["write_s"] = time.perf_counter() - t0

    per_call = _expected_unclip_launches(ucfg, UNCLIP_BATCH,
                                         UNCLIP_RESOLUTION, UNCLIP_STEPS)
    # 5 self-attention sites at each of 96², 48² and 24² (the mid block's
    # 144 tokens and every 77-token cross-attention stay on einsum)
    if per_call != _want(flash_fwd_lowdim=15 * UNCLIP_STEPS):
        fail(f"unclip: derived launches {per_call}")
    out = os.path.join(root, "variations")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = aug.main(["--train_image_dataset", src, "--save_dir", out,
                     "--mode", "unclip", "--unclip_model_path", model_dir])
    torch.cuda.synchronize()
    report["cli_s"] = time.perf_counter() - t0
    launches = _read_launches()
    want_cli = {k: len(UNCLIP_SOURCES) * v for k, v in per_call.items()}
    if launches != want_cli:
        fail(f"unclip CLI: launches {launches}, expected {want_cli}")
    jpgs = sorted(f for f in os.listdir(out) if f.endswith(".jpg"))
    if len(jpgs) != len(UNCLIP_SOURCES) * UNCLIP_IMAGES:
        fail(f"unclip CLI: {len(jpgs)} JPEGs in {out}")

    image = load_image_rgb(os.path.join(src, "1.png"))  # not square

    def call(want, **kwargs):
        args = dict(num_images_per_prompt=UNCLIP_IMAGES,
                    num_inference_steps=UNCLIP_STEPS,
                    guidance_scale=UNCLIP_GUIDANCE, noise_level=0, seed=7,
                    output_type="np")
        args.update(kwargs)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = pipe(image, **args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = _read_launches()
        if got != want:
            fail(f"unclip {kwargs}: launches {got}, expected {want}")
        if not (images.shape == (UNCLIP_IMAGES, 3, UNCLIP_RESOLUTION,
                                 UNCLIP_RESOLUTION)
                and np.isfinite(images).all() and images.min() >= 0.0
                and images.max() <= 1.0):
            fail(f"unclip {kwargs}: images {images.shape}, finite "
                 f"{np.isfinite(images).all()}, range "
                 f"[{images.min()}, {images.max()}]")
        return images, seconds

    first, report["first_call_s"] = call(per_call)
    torch.cuda.reset_peak_memory_stats()
    with _flash_shapes() as shapes:
        second, warm_s = call(per_call)
    peak = torch.cuda.max_memory_allocated()
    report.update(warm_call_s=warm_s, images_per_s=UNCLIP_IMAGES / warm_s,
                  max_memory_allocated_gb=peak / 1e9,
                  flash_launches_by_shape=shapes,
                  rerun_bit_equal=bool(np.array_equal(first, second)))
    if not report["rerun_bit_equal"]:
        fail(f"unclip: two same-seed calls differ by "
             f"{float(np.abs(first - second).max())}")
    if peak > UNCLIP_PEAK_GB * 1e9:
        fail(f"unclip: peak memory {peak / 1e9} GB above {UNCLIP_PEAK_GB}")
    want_shapes = {f"{UNCLIP_BATCH * h}x{s * s}x{s * s}x64": 5 * UNCLIP_STEPS
                   for h, s in UNCLIP_FLASH}
    if shapes != want_shapes:
        fail(f"unclip: flash launches by shape {shapes}, expected "
             f"{want_shapes}")
    noised, _ = call(per_call, noise_level=500)
    report["noise_level_500_vs_0_rel_l2"] = _rel(torch.from_numpy(noised),
                                                 torch.from_numpy(first))
    if not report["noise_level_500_vs_0_rel_l2"] > 1e-3:
        fail(f"unclip: noise level 500 against 0: {report}")
    no_cfg = _expected_unclip_launches(ucfg, UNCLIP_IMAGES,
                                       UNCLIP_RESOLUTION, UNCLIP_STEPS)
    # at batch 4 the 576-token sites' scores (106 MB) fall under 128 MiB
    if no_cfg != _want(flash_fwd_lowdim=10 * UNCLIP_STEPS):
        fail(f"unclip: derived launches without CFG {no_cfg}")
    _, report["cfg_1_call_s"] = call(no_cfg, guidance_scale=1.0)
    gn = _group_norm_sites(ucfg, vcfg, 1, UNCLIP_RESOLUTION,
                           parts=("unet", "vae_decode"))
    report["group_norm_sites"] = {
        "unet_pass": sum(gn["unet"].values()),
        "vae_decode": sum(gn["vae_decode"].values())}
    want_routes = dict(_expected_unclip_launches(
        ucfg, UNCLIP_BATCH, UNCLIP_RESOLUTION, UNCLIP_STEPS, routes=True),
        group_norm=(UNCLIP_STEPS * report["group_norm_sites"]["unet_pass"]
                    + report["group_norm_sites"]["vae_decode"]))
    with _routes_on():
        routed, report["routes_call_s"] = call(want_routes)
    report["routes_on_vs_off_images_rel_l2"] = _rel(
        torch.from_numpy(routed), torch.from_numpy(first))
    if not (report["routes_on_vs_off_images_rel_l2"]
            <= UNCLIP_ROUTES_IMAGES_REL_L2):
        fail(f"unclip: routes on against off: {report}")
    report.update(_unclip_unet_checks(pipe))
    report["profile"] = _profile(lambda: pipe(
        image, num_images_per_prompt=UNCLIP_IMAGES,
        num_inference_steps=UNCLIP_STEPS, guidance_scale=UNCLIP_GUIDANCE,
        seed=7, output_type="np"))
    report["launches_cli"] = launches
    print(json.dumps(report))
    del pipe
    torch.cuda.empty_cache()
    # the flash kernel's device time over the profiled call: the only port
    # attention kernel a default call launches
    families = report["profile"].get("families_ms") or {}
    per_call = {"launches_by_shape": shapes,
                "profiled_ms": families.get("port_attention")}
    return launches, {"variations": out, "source": os.path.join(src, "0.png"),
                      "tokenizer": os.path.join(model_dir, "tokenizer"),
                      "flash_per_call": per_call}


def _open_clip_file(path):
    """A full-width ``CLIPScorer`` with seeded random weights, written as an
    open_clip ViT-H-14 checkpoint (bf16): ``visual.*`` with ``visual.proj``,
    the text tower at top level, ``logit_scale`` and ``attn_mask``."""
    import torch

    from e4t_diffusion_torch.models.clip_score import (
        CLIPScoreConfig, CLIPScorer)

    torch.manual_seed(24)
    cfg = CLIPScoreConfig()
    with torch.device("cuda"):
        scorer = CLIPScorer(cfg)
    sd = {}
    for k, v in scorer.state_dict().items():
        k = ("visual.proj" if k == "visual_proj"
             else k[len("text."):] if k.startswith("text.") else k)
        sd[k] = v.detach().to("cpu", torch.bfloat16)
    length = cfg.text.context_length
    sd["logit_scale"] = torch.tensor(4.6052)
    sd["attn_mask"] = torch.full((length, length), float("-inf")).triu(1)
    torch.save(sd, path)
    return sum(v.numel() for k, v in scorer.state_dict().items())


def phase_clip_score(smi, root, data):
    """``evaluate_clip_scores.main`` over the unclip phase's JPEGs with a
    full-width scorer: the route off (default), then with
    ``E4T_SHORTSEQ_MH_ATTN=8``, then a source image against itself; and
    one JPEG's image features with the route on against off."""
    import shutil

    import torch

    from e4t_diffusion_torch import evaluate_clip_scores as score

    report = {"phase": "clip_score", "card": smi}
    weights = os.path.join(root, "open_clip_vit_h14.pt")
    t0 = time.perf_counter()
    report["params"] = _open_clip_file(weights)
    report["write_s"] = time.perf_counter() - t0
    n = len(os.listdir(data["variations"]))
    args = ["--generated_dir", data["variations"], "--source_image",
            data["source"], "--prompt", "a photo of *s", "--class_word",
            "face", "--open_clip_weights", weights, "--tokenizer_dir",
            data["tokenizer"]]

    def run(argv, want):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = score.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = _read_launches()
        if got != want:
            fail(f"clip_score: launches {got}, expected {want}")
        if not all(math.isfinite(record[k]) and -1.0 <= record[k] <= 1.0
                   for k in ("clip_i", "clip_t")):
            fail(f"clip_score: {record}")
        return record, seconds, got

    off, report["off_s"], _ = run(args, _want())
    # the ViT-H's 32 attention sites at 257 tokens, BH 16, in f32: one
    # image-features call for the source and one for each JPEG
    with _routes_on():
        on, report["on_s"], launches = run(args, _want(
            flash_fwd_shortseq_f32=32 * (n + 1)))
    self_dir = os.path.join(root, "self")
    os.makedirs(self_dir)
    shutil.copy(data["source"], self_dir)
    itself, _, _ = run(["--generated_dir", self_dir,
                        *args[2:]], _want())
    report.update(route_off=off, route_on=on, source_vs_itself=itself,
                  launches_on=launches)
    # one JPEG's image features with the route on against off: a mean of
    # cosines could hide a wrong feature
    scorer = score.load_scorer(weights, "cuda")
    jpg = os.path.join(data["variations"],
                       sorted(os.listdir(data["variations"]))[0])
    pixels = torch.from_numpy(score.load_pixels(jpg, 224)).cuda()
    feats = {}
    for route, want in (("off", _want()),
                        ("on", _want(flash_fwd_shortseq_f32=32))):
        with contextlib.ExitStack() as stack:
            if route == "on":
                stack.enter_context(_routes_on())
            _reset_launches()
            with torch.inference_mode():
                feats[route] = scorer.image_features(pixels)
            torch.cuda.synchronize()
            if _read_launches() != want:
                fail(f"clip_score: image features, route {route}: "
                     f"launches {_read_launches()}, expected {want}")
    report["image_features_on_vs_off_rel_l2"] = _rel(feats["on"],
                                                     feats["off"])
    del scorer, feats
    torch.cuda.empty_cache()
    print(json.dumps(report))
    if not (off["n_images"] == on["n_images"] == n
            and abs(itself["clip_i"] - 1.0) <= CLIP_SELF_SCORE_ABS
            and max(abs(on[k] - off[k]) for k in ("clip_i", "clip_t"))
            <= F32_PATH_REL_L2
            and report["image_features_on_vs_off_rel_l2"]
            <= F32_PATH_REL_L2):
        fail(f"clip_score: {report}")
    return launches


def _tiny_sd2_vs_cpu():
    """The tiny E4T world on an SD2-flavoured base (per-block heads, linear
    projections, a gelu text tower, v-prediction) in f32 on the card and
    on the CPU, the same latents given to both: max-abs of the images by
    sampler (DDIM, DPM++ 2M)."""
    import dataclasses

    import numpy as np
    import torch

    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.diffusion.pipeline import (
        E4TModules, StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.diffusion.schedulers import (
        SCHEDULER_MAPPING, NoiseScheduleConfig)
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    ucfg = dataclasses.replace(UNetConfig.tiny(), attention_head_dim=(4, 2),
                               use_linear_projection=True)
    tcfg = dataclasses.replace(CLIPTextConfig.tiny(), hidden_act="gelu")
    ecfg = E4TEncoderConfig.tiny(word_embedding_dim=tcfg.hidden_size,
                                 unet_feature_dim=tap_feature_dim(ucfg))
    torch.manual_seed(27)
    cpu = E4TModules.create(ucfg, VAEConfig.tiny(), tcfg, ecfg,
                            device="cpu")
    card = E4TModules.create(ucfg, VAEConfig.tiny(), tcfg, ecfg,
                             device="cuda")
    for src, dst in zip(cpu.all(), card.all()):
        dst.load_state_dict(src.state_dict(), strict=True)
    offsets = wo.init_offset_bank(ucfg, torch.Generator().manual_seed(28))
    cfg = AttributeDict({"placeholder_token": "*s",
                         "domain_class_token": "face",
                         "domain_embed_scale": 0.1})
    rng = np.random.default_rng(29)
    image = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    latents = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    errors = {}
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["a", "photo", "of",
                                                        "face"])
        for name in ("ddim", "dpm_solver++"):
            outs = []
            for mods in (cpu, card):
                pipe = StableDiffusionE4TPipeline(
                    mods, offsets, CLIPTokenizer.from_pretrained(
                        tok_dir, model_max_length=16), cfg,
                    scheduler=SCHEDULER_MAPPING[name](NoiseScheduleConfig(
                        prediction_type="v_prediction")))
                outs.append(pipe(PROMPTS[:1] + ["a *s face"], image,
                                 num_inference_steps=3, guidance_scale=7.5,
                                 num_images_per_prompt=2, latents=latents))
            errors[name] = float(np.abs(outs[0] - outs[1]).max())
    if not all(e <= TINY_CARD_VS_CPU_MAX_ABS for e in errors.values()):
        fail(f"tiny SD2 E4T pipeline, card vs CPU: max-abs {errors}")
    return errors


def _tiny_unclip_vs_cpu():
    """The tiny unCLIP pipeline in f32 on the card and on the CPU, the same
    latents and augmentation noise passed to both: max-abs of the
    images."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion.unclip_pipeline import (
        StableUnCLIPImg2ImgPipeline, UnCLIPModules)
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)

    torch.manual_seed(25)
    cpu = UnCLIPModules.tiny(device="cpu")
    card = UnCLIPModules.tiny(device="cuda")
    with torch.no_grad():
        cpu.image_normalizer.std.uniform_(0.5, 1.5)
    for src, dst in zip(cpu.all(), card.all()):
        dst.load_state_dict(src.state_dict(), strict=True)
    rng = np.random.default_rng(26)
    image = rng.integers(0, 256, (40, 32, 3), dtype=np.uint8)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    aug_noise = rng.standard_normal((2, 16)).astype(np.float32)
    outs = []
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["photo"])
        for mods in (cpu, card):
            pipe = StableUnCLIPImg2ImgPipeline(
                mods, CLIPTokenizer.from_pretrained(tok_dir,
                                                    model_max_length=16))
            outs.append(pipe(image, prompt="photo", num_inference_steps=3,
                             guidance_scale=10.0, noise_level=300,
                             num_images_per_prompt=2, latents=latents,
                             aug_noise=aug_noise, output_type="np"))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TINY_CARD_VS_CPU_MAX_ABS:
        fail(f"tiny unCLIP pipeline, card vs CPU: max-abs {err}")
    return err


PRETRAIN_STEPS = 3
PRETRAIN_BATCH = 16
PRETRAIN_IMAGES = 40
PRETRAIN_SAMPLE_STEPS = 4
# full-width f32 pretraining: the largest of these batches the card holds
F32_PRETRAIN_BATCHES = (16, 8, 4)
# the loader timed on 1024x1024 images (the published model's FFHQ +
# CelebA-HQ are that size), with one decode thread and with this many
LOADER_LARGE_SIDE = 1024
LOADER_LARGE_IMAGES = 32
LOADER_WORKERS = 4
# the native transform against cv2's INTER_AREA, which works in fixed
# point: ~1.5 LSB in uint8 space
NATIVE_VS_CV2_MAX_ABS = 2.0 / 127.5


def _expected_sampling_launches(ucfg, vit_cfg, batch, resolution, steps,
                                dtype=None):
    """Launches of one CFG sampling run of ``steps`` steps at ``batch``:
    each step runs two full UNet passes, and a site goes to flash where the
    port's own ``flash_route`` sends it (the default threshold: sampling
    runs outside the train step's ``flash_threshold(0)``); the ViT encodes
    once. The routes are off."""
    import torch

    from e4t_diffusion_torch.models.weight_offsets import attention_sites
    from e4t_diffusion_torch.ops.attention import flash_route
    from e4t_diffusion_torch.ops.flash_lowdim import launch_route

    dtype = dtype or torch.bfloat16
    side = resolution // 8
    levels = len(ucfg.block_out_channels)
    want = dict.fromkeys(KERNEL_ROWS, 0)
    for path, dim, _ in attention_sites(ucfg):
        block, index = path.split(".")[:2]
        level = (levels - 1 - int(index) if block == "up_blocks"
                 else int(index) if block == "down_blocks" else levels - 1)
        heads = ucfg.heads_for_block(level)
        sq = (side >> level) ** 2
        sk = sq if path.endswith("attn1") else 77
        d = dim // heads
        if flash_route((batch, heads, sq, d), (batch, heads, sk, d), "cuda"):
            want[f"flash_fwd_{launch_route(d, dtype)}"] += 2 * steps
    tokens = vit_cfg.grid ** 2 + 1
    d = vit_cfg.width // vit_cfg.num_heads
    shape = (batch, vit_cfg.num_heads, tokens, d)
    if flash_route(shape, shape, "cuda"):
        want[f"flash_fwd_{launch_route(d, dtype)}"] += vit_cfg.num_layers
    return want


def _expected_pretraining_launches(ucfg, vit_cfg, resolution, routes=False,
                                   dtype=None):
    """Launches per pretraining step: a tuning step's attention (the same
    sites, all-flash, a frozen UNet whose backward still runs for the
    offsets and the tap), and with the routes on the GroupNorm sites of the
    VAE encode the step runs on its batch."""
    from e4t_diffusion_torch.models.vae import VAEConfig

    want = _expected_tuning_launches(ucfg, vit_cfg, resolution, routes,
                                     dtype)
    if routes:
        want["group_norm"] += sum(_group_norm_sites(
            ucfg, VAEConfig(), 1, resolution)["vae_encode"].values())
    return want


def _write_square_images(folder, n, side, seed=1):
    """``n`` side x side images, half PNG and half JPEG (quality 95), of
    smooth seeded content with grain. Returns {"png": [bytes], "jpg":
    [bytes]}, the files' sizes."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    # the draws in order, then the images made and encoded side by side
    draws = [(rng.uniform(0, 2 * np.pi, 3), rng.normal(0, 6, (side, side, 3)))
             for _ in range(n)]

    def write(i):
        phase, grain = draws[i]
        base = np.stack([127 + 100 * np.sin(xx / (40 + 30 * c) + phase[c]
                                            + yy / 97) for c in range(3)], -1)
        img = (base + grain).clip(0, 255).astype(np.uint8)
        ext = "jpg" if i % 2 else "png"
        path = os.path.join(folder, f"{i:03d}.{ext}")
        Image.fromarray(img).save(path, **({"quality": 95} if ext == "jpg"
                                           else {}))
        return ext, os.path.getsize(path)

    sizes = {"png": [], "jpg": []}
    with ThreadPoolExecutor(8) as pool:
        for ext, size in pool.map(write, range(n)):
            sizes[ext].append(size)
    return sizes


def _loader_seconds(loader, batches=3):
    """Seconds per batch that ``loader`` yields, over ``batches`` batches
    after its first (which also starts its threads)."""
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        if next(it)["pixel_values"].shape != (
                loader.batch_size, 3, loader.resolution, loader.resolution):
            fail("pretraining: a loader batch of the wrong shape")
    seconds = (time.perf_counter() - t0) / batches
    it.close()
    return seconds


def _pretrain_args(data_dir, out_dir, *extra):
    from e4t_diffusion_torch import seeded

    return seeded.pretrain_args(data_dir, out_dir, *extra,
                                batch=PRETRAIN_BATCH, resolution=RESOLUTION)


def _pretrain_run(args, world, routes=False, mesh=None):
    """One ``seeded.pretrain`` call (its loader from
    ``pretrain_e4t.make_loader``; ``mesh``: a process group's grid), with
    the launch counters set to 0 just before and read just after. Returns
    (result, launches, wall seconds)."""
    import torch

    from e4t_diffusion_torch import pretrain_e4t, seeded

    loader, _ = pretrain_e4t.make_loader(args, mesh)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _routes_on() if routes else contextlib.nullcontext():
        result = seeded.pretrain(args, world, loader, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    result["loader_transform"] = loader.transform_kind
    return result, _read_launches(), wall


def _native_vs_cv2(folder):
    """The largest difference between the loader's two transforms (the
    native one and ``E4T_DISABLE_NATIVE=1``'s cv2 one, center crops, one
    seed so the same flips) over every image of ``folder``, and the
    images compared."""
    import numpy as np

    from e4t_diffusion_torch.data import native_ops
    from e4t_diffusion_torch.data.dataset import (
        list_image_files_recursively, load_image_rgb, make_transform)

    native = native_ops.make_native_transform(RESOLUTION, False, seed=0)
    cv2 = make_transform(RESOLUTION, False, seed=0)
    files = list_image_files_recursively(folder)
    worst = 0.0
    for path in files:
        img = load_image_rgb(path)
        worst = max(worst, float(np.abs(native(img) - cv2(img)).max()))
    return worst, len(files)


def _checksums(tensors, dtype=None):
    """Per-tensor (float64 sum, sum of the bit patterns as integers) of
    ``tensors`` (cast to ``dtype`` first, as the trainer casts frozen
    modules): a change of any bit shows in the second."""
    import torch

    ints = {2: torch.int16, 4: torch.int32}
    out = []
    for t in tensors:
        t = t.detach() if dtype is None else t.detach().to(dtype)
        out.append((float(t.double().sum()), int(t.contiguous().view(
            ints[t.element_size()]).sum(dtype=torch.int64))))
    return out


@contextlib.contextmanager
def _checkpoints_checked(report):
    """While active, every train-state save is read back after it is
    written, and every restore after it is loaded, and held bit for bit
    against the live trainables, optimizer state (AdamW's moments, or the
    8-bit AdamW's codes and scales in their dtypes; unsharded under
    ZeRO-1) and generator state."""
    import torch

    from e4t_diffusion_torch.parallel.mesh import consolidated_state_dict
    from e4t_diffusion_torch.utils import artifacts

    save, restore = artifacts.save_train_state, artifacts.restore_train_state

    def compare(what, path, trainable, optimizer, generator):
        payload = torch.load(os.path.join(path, artifacts.TRAIN_STATE_FILE),
                             map_location="cpu", weights_only=True)
        n = 0
        for g, group in trainable.items():
            for k, t in group.items():
                if not torch.equal(t.detach().cpu(),
                                   payload["trainable"][g][k]):
                    fail(f"{what} {path}: trainable {g}/{k} differs")
                n += t.numel()
        saved = payload["optimizer"]["state"]
        live = consolidated_state_dict(optimizer)["state"]
        if set(live) != set(saved):
            fail(f"{what} {path}: optimizer state of other tensors")
        for i, state in live.items():
            if set(state) != set(saved[i]):
                fail(f"{what} {path}: optimizer state keys {sorted(state)} "
                     f"against {sorted(saved[i])}")
            for key, value in state.items():
                same = (value.dtype == saved[i][key].dtype and torch.equal(
                    value.cpu(), saved[i][key])) if isinstance(
                    value, torch.Tensor) else value == saved[i][key]
                if not same:
                    fail(f"{what} {path}: optimizer {key} of tensor {i} "
                         f"differs")
        if not torch.equal(generator.get_state(), payload["generators"][0]):
            fail(f"{what} {path}: generator state differs")
        report.setdefault(what, []).append(
            {"path": os.path.basename(path), "step": payload["step"],
             "updates": payload["updates"], "tensors_checked": n,
             "bytes": os.path.getsize(os.path.join(
                 path, artifacts.TRAIN_STATE_FILE))})

    def checked_save(output_dir, step, trainable, optimizer, updates,
                     generator, async_save=False, mesh=None):
        path = save(output_dir, step, trainable, optimizer, updates,
                    generator, async_save, mesh)
        artifacts.wait_for_checkpoints()
        compare("saved", path, trainable, optimizer, generator)
        return path

    def checked_restore(path, trainable, optimizer, generator, rank=0):
        out = restore(path, trainable, optimizer, generator, rank)
        compare("restored", path, trainable, optimizer, generator)
        return out

    artifacts.save_train_state = checked_save
    artifacts.restore_train_state = checked_restore
    try:
        yield
    finally:
        artifacts.save_train_state = save
        artifacts.restore_train_state = restore


def _metrics_finite(metrics, what):
    if not metrics or not all(
            math.isfinite(m[k]) for m in metrics
            for k in ("loss", "loss_diff", "loss_reg", "grad_norm")):
        fail(f"{what}: non-finite or missing metrics {metrics}")


def _warm_step_profile(world, result, args, data_dir):
    """One more step of the trained state, warm, under ``torch.profiler``
    (busy share; the top kernels), with the step's time by CUDA events
    beside it for when the profiler records no device time."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.data.dataset import E4TDataLoader
    from e4t_diffusion_torch.diffusion.schedulers import (DDPMScheduler,
                                                          NoiseScheduleConfig)
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training.setup import TemplateSampler
    from e4t_diffusion_torch.training.train_step import (E4TTrainConfig,
                                                         make_train_step)

    modules, _, tokenizer, placeholder_id, class_id = world
    it = iter(E4TDataLoader(data_dir, args.train_batch_size,
                            args.resolution, seed=7))
    pixels = next(it)["pixel_values"]
    it.close()
    sampler = TemplateSampler(resolve_templates(args.prompt_template),
                              tokenizer, "*s", placeholder_id, seed=7)
    ids, ph = sampler.sample(args.train_batch_size)
    batch = {"pixel_values": torch.from_numpy(pixels).cuda(),
             "input_ids": torch.from_numpy(ids).cuda(),
             "placeholder_idx": torch.from_numpy(np.asarray(ph)).cuda(),
             "uncond_ids": torch.from_numpy(sampler.uncond_ids).cuda(),
             "class_token_id": torch.tensor(class_id, device="cuda")}
    cfg = E4TTrainConfig(train_unet=False, max_grad_norm=None)
    step = make_train_step(modules, DDPMScheduler(NoiseScheduleConfig()),
                           cfg, result["trainable"], result["optimizer"],
                           lambda n: args.learning_rate)
    gen = torch.Generator("cuda").manual_seed(7)

    def run():
        float(step(batch, gen)["loss"])

    run()  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    profile = _profile(run)
    profile["events_ms"] = start.elapsed_time(end)
    return profile


def phase_pretraining(smi):
    """Phase-1 pretraining at full width through ``pretrain_e4t.pretrain``
    (what the CLI runs after loading), bf16 compute, batch 16, 512px:
    PRETRAIN_STEPS steps from a folder of written images through the loader
    and the device prefetch, a checkpoint at step 2, a DDIM-4 sample after
    every step; then one step resumed from ``latest``. Checks the metrics,
    the trainables against the frozen modules, the checkpoints bit for bit,
    the schedule's count after the resume, the artifacts (strict loads and a
    tuning step from them), the samples and the launch counts. Returns
    (launches of both runs, the first step's metrics, the image folder's
    TemporaryDirectory)."""
    import gc

    import numpy as np
    import torch
    from PIL import Image

    from e4t_diffusion_torch import seeded, tuning_e4t
    from e4t_diffusion_torch.data.dataset import E4TDataLoader
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training.setup import make_lr_schedule
    from e4t_diffusion_torch.utils import artifacts

    data = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    sizes = seeded.write_pretraining_images(data.name, PRETRAIN_IMAGES)
    images_s = time.perf_counter() - t0
    # the loader's default transform is the native one; cv2's beside it
    loader = E4TDataLoader(data.name, PRETRAIN_BATCH, RESOLUTION, seed=0)
    if loader.transform_kind != "native":
        fail(f"pretraining: the loader took {loader.transform_kind}")
    loader_s = _loader_seconds(loader)
    os.environ["E4T_DISABLE_NATIVE"] = "1"
    try:
        loader = E4TDataLoader(data.name, PRETRAIN_BATCH, RESOLUTION, seed=0)
    finally:
        del os.environ["E4T_DISABLE_NATIVE"]
    if loader.transform_kind != "cv2":
        fail(f"pretraining: E4T_DISABLE_NATIVE=1 took "
             f"{loader.transform_kind}")
    loader_cv2_s = _loader_seconds(loader)
    native_vs_cv2, n_compared = _native_vs_cv2(data.name)
    if not native_vs_cv2 <= NATIVE_VS_CV2_MAX_ABS:
        fail(f"pretraining: the native transform is {native_vs_cv2} from "
             f"cv2's (at most {NATIVE_VS_CV2_MAX_ABS})")
    # the published model's domain, FFHQ + CelebA-HQ, is 1024x1024 photos:
    # the loader on such images, one decode thread and LOADER_WORKERS
    with tempfile.TemporaryDirectory() as large:
        large_bytes = _write_square_images(large, LOADER_LARGE_IMAGES,
                                           LOADER_LARGE_SIDE)
        loader_large = {workers: _loader_seconds(E4TDataLoader(
            large, PRETRAIN_BATCH, RESOLUTION, seed=0, num_workers=workers))
            for workers in (0, LOADER_WORKERS)}

    t0 = time.perf_counter()
    world = seeded.pretraining_world()
    modules, offsets = world[:2]
    setup_s = time.perf_counter() - t0
    ucfg, ecfg = modules.unet.config, modules.e4t_encoder.config
    if _expected_sampling_launches(ucfg, ecfg.vit, IMAGES_PER_PROMPT * len(
            PROMPTS), RESOLUTION, STEPS) != _want(
            flash_fwd_lowdim=LOWDIM_SITES_PER_STEP * STEPS):
        fail("the sampling launch derivation disagrees with the sampling "
             "phase's counts")
    e4t = modules.e4t_encoder
    bf16 = torch.bfloat16
    frozen = {"unet": list(modules.unet.parameters()),
              "vae": list(modules.vae.parameters()),
              "text": list(modules.text_encoder.parameters()),
              "vit": list(e4t.clip_vision.parameters())}
    before = {k: _checksums(v, bf16) for k, v in frozen.items()}
    head_before = _checksums([p for n, p in e4t.named_parameters()
                              if not n.startswith("clip_vision.")])
    offsets_before = _checksums(offsets.values())

    out = tempfile.TemporaryDirectory()
    sched = ["--mixed_precision", "bf16", "--max_train_steps",
             str(PRETRAIN_STEPS), "--checkpointing_steps", "2",
             "--lr_scheduler", "linear", "--lr_warmup_steps", "1",
             "--save_sample_prompt", "a photo of *s"]
    args = _pretrain_args(data.name, out.name, *sched, "--log_steps", "1",
                          "--n_save_sample", "1", "--save_inference_steps",
                          str(PRETRAIN_SAMPLE_STEPS))
    checks = {}
    torch.cuda.reset_peak_memory_stats()
    with _checkpoints_checked(checks):
        result, launches, wall = _pretrain_run(args, world)
    peak = torch.cuda.max_memory_allocated()
    if result["loader_transform"] != "native":
        fail(f"pretraining: the run's loader took "
             f"{result['loader_transform']}")
    metrics = result["metrics"]
    _metrics_finite(metrics, "pretraining")
    if len(metrics) != PRETRAIN_STEPS:
        fail(f"pretraining: {len(metrics)} updates, {PRETRAIN_STEPS} asked")
    trained = result["trainable"]
    if _checksums(trained["offsets"].values()) == offsets_before:
        fail("pretraining: the offsets did not change")
    if _checksums(trained["e4t"].values()) == head_before:
        fail("pretraining: the encoder head did not change")
    after = {k: _checksums(v) for k, v in frozen.items()}
    for k in frozen:
        if after[k] != before[k]:
            fail(f"pretraining: the frozen {k} changed")
    if result["sampled"] != list(range(1, PRETRAIN_STEPS + 1)):
        fail(f"pretraining: samples at {result['sampled']}")
    images = result["last_samples"]
    if images.shape != (1, 3, RESOLUTION, RESOLUTION) or not (
            np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0):
        fail("pretraining: the last sample is not finite images in [0, 1]")
    for step in result["sampled"]:
        grid = os.path.join(out.name, "samples", f"sample-{step}.png")
        with Image.open(grid) as img:
            if img.size != (RESOLUTION, RESOLUTION):
                fail(f"pretraining: sample-{step}.png is {img.size}")
    per_step = _expected_pretraining_launches(ucfg, ecfg.vit, RESOLUTION)
    per_sample = _expected_sampling_launches(ucfg, ecfg.vit, 1, RESOLUTION,
                                             PRETRAIN_SAMPLE_STEPS)
    want = {k: PRETRAIN_STEPS * (per_step[k] + per_sample[k])
            for k in per_step}
    if launches != want:
        fail(f"pretraining: launches {launches}, expected {want} "
             f"({per_step} a step, {per_sample} a sample)")
    first_metrics = metrics[0]
    profile = _warm_step_profile(world, result, args, data.name)
    steady = result["step_seconds"][1:]
    s_per_step = sum(steady) / len(steady)
    report = {
        "phase": "pretraining", "card": smi, "dtype": "bfloat16",
        "images": {"n": len(sizes), "min_hw": min(sizes),
                   "max_hw": max(sizes), "written_s": images_s},
        "setup_s": setup_s, "batch": args.train_batch_size,
        "resolution": args.resolution, "steps": PRETRAIN_STEPS,
        "wall_s": wall, "trainable_params": sum(
            t.numel() for g in trained.values() for t in g.values()),
        "step_seconds": result["step_seconds"], "s_per_step": s_per_step,
        "samples_per_s": args.train_batch_size / s_per_step,
        "loader_s_per_batch": loader_s,
        "loader_cv2_s_per_batch": loader_cv2_s,
        "loader_transform": result["loader_transform"],
        "native_vs_cv2_max_abs": native_vs_cv2,
        "native_vs_cv2_images": n_compared,
        "loader_large": {
            "side": LOADER_LARGE_SIDE, "n": LOADER_LARGE_IMAGES,
            "mean_file_bytes": {k: sum(v) / len(v)
                                for k, v in large_bytes.items()},
            "s_per_batch_by_workers": loader_large},
        "loader_wait_s": result["wait_seconds"],
        "max_memory_allocated_gb": peak / 1e9, "metrics": metrics,
        "launches": launches, "launches_per_step": per_step,
        "launches_per_sample": per_sample, "warm_step_profile": profile}
    del result, trained
    gc.collect()
    torch.cuda.empty_cache()

    # resumed from checkpoint-2 for one more step
    args = _pretrain_args(data.name, out.name, *sched, "--log_steps", "1",
                          "--n_save_sample", "1", "--save_inference_steps",
                          str(PRETRAIN_SAMPLE_STEPS),
                          "--resume_from_checkpoint", "latest")
    with _checkpoints_checked(checks):
        resumed, launches2, wall2 = _pretrain_run(args, world)
    if resumed["resumed_from"] != os.path.join(out.name, "checkpoint-2"):
        fail(f"pretraining: resumed from {resumed['resumed_from']}")
    _metrics_finite(resumed["metrics"], "pretraining, resumed")
    schedule = make_lr_schedule("linear", args.learning_rate, 1,
                                PRETRAIN_STEPS)
    lrs = [m["lr"] for m in metrics] + [m["lr"] for m in resumed["metrics"]]
    if lrs != [schedule(n) for n in (0, 1, 2, 2)]:
        fail(f"pretraining: learning rates {lrs}, the schedule gives "
             f"{[schedule(n) for n in range(PRETRAIN_STEPS)]}")
    if launches2 != {k: per_step[k] + per_sample[k] for k in per_step}:
        fail(f"pretraining, resumed: launches {launches2}")
    if [c["path"] for c in checks.get("saved", [])] != ["checkpoint-2"] or \
            [c["path"] for c in checks.get("restored", [])] != [
                "checkpoint-2"]:
        fail(f"pretraining: checkpoints {checks}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()

    # the artifact loads strictly, and a tuning step runs from it
    art = os.path.join(out.name, str(PRETRAIN_STEPS))
    loaded = artifacts.load_e4t_weights(art, {})
    modules.e4t_encoder.load_state_dict(loaded["e4t"], strict=True)
    wo.check_bank(loaded["offsets"], ucfg)
    tune_args = tuning_e4t.parse_args([
        "--pretrained_model_name_or_path", art, "--train_image_path", "-",
        "--max_train_steps", "1", "--mixed_precision", "bf16",
        "--train_batch_size", "2"])
    image = np.random.default_rng(0).integers(
        0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)
    tuned = tuning_e4t.tune(
        tune_args, modules, {k: v.cuda() for k, v in
                             loaded["offsets"].items()},
        world[2], "*s", resolve_templates("normal"), world[4], image,
        NoiseScheduleConfig(), bf16)
    _metrics_finite(tuned["metrics"], "a tuning step from the artifact")
    report.update({
        "resumed": {"wall_s": wall2, "launches": launches2},
        "checkpoints": checks, "learning_rates": lrs,
        "artifact": sorted(os.listdir(art)),
        "tuning_step_from_artifact": tuned["metrics"][0]})
    print(json.dumps(report))
    out.cleanup()
    total = {k: launches[k] + launches2[k] for k in launches}
    return total, {"first_step": first_metrics, "peak_gb": peak / 1e9,
                   "s_per_step": s_per_step}, data


def phase_routes_pretraining(smi, first_step, data):
    """One pretraining step from the same weights, data and draws as
    phase ``pretraining``'s first, with both opt-in routes on: its loss and
    grad norm against that step's; the GroupNorm launches include the VAE
    encode's sites."""
    import gc

    import torch

    from e4t_diffusion_torch import seeded

    world = seeded.pretraining_world()
    ucfg, vit = world[0].unet.config, world[0].e4t_encoder.config.vit
    with tempfile.TemporaryDirectory() as out:
        args = _pretrain_args(data.name, out, "--mixed_precision", "bf16",
                              "--max_train_steps", "1", "--n_save_sample",
                              "0")
        result, launches, wall = _pretrain_run(args, world, routes=True)
    metrics = result["metrics"]
    _metrics_finite(metrics, "routes_pretraining")
    want = _expected_pretraining_launches(ucfg, vit, RESOLUTION, routes=True)
    if launches != want:
        fail(f"routes_pretraining: launches {launches}, expected {want}")
    rel = {k: abs(metrics[0][k] - first_step[k]) / abs(first_step[k])
           for k in ("loss", "grad_norm")}
    if not max(rel.values()) <= PRETRAIN_ROUTE_REL:
        fail(f"pretraining, routes on vs off, first step: {rel} "
             f"({metrics[0]} against {first_step})")
    print(json.dumps({
        "phase": "routes_pretraining", "card": smi, "knobs": ROUTE_KNOBS,
        "batch": args.train_batch_size, "wall_s": wall,
        "step_seconds": result["step_seconds"], "metrics": metrics,
        "first_step_vs_routes_off_rel": rel, "launches": launches}))
    del result, world
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_f32_pretraining(smi, data):
    """Two full-width pretraining steps with ``--mixed_precision no`` (the
    CLI's default: f32 compute, the f32 attention kernels) at the largest
    batch of F32_PRETRAIN_BATCHES the card holds."""
    import gc

    import torch

    from e4t_diffusion_torch import seeded

    refused = []
    for batch in F32_PRETRAIN_BATCHES:
        world = seeded.pretraining_world()
        ucfg, vit = world[0].unet.config, world[0].e4t_encoder.config.vit
        head = _checksums([p for n, p in world[0].e4t_encoder
                           .named_parameters()
                           if not n.startswith("clip_vision.")])
        offsets = _checksums(world[1].values())
        torch.cuda.reset_peak_memory_stats()
        try:
            with tempfile.TemporaryDirectory() as out:
                args = _pretrain_args(
                    data.name, out, "--max_train_steps", "2",
                    "--n_save_sample", "0", "--train_batch_size", str(batch))
                result, launches, wall = _pretrain_run(args, world)
        except torch.cuda.OutOfMemoryError as err:
            refused.append({"batch": batch, "error": str(err)[:200]})
            del world
            gc.collect()
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated()
        if args.mixed_precision != "no":
            fail("the CLI's default --mixed_precision is not 'no'")
        _metrics_finite(result["metrics"], "f32_pretraining")
        trained = result["trainable"]
        if (_checksums(trained["offsets"].values()) == offsets
                or _checksums(trained["e4t"].values()) == head):
            fail("f32_pretraining: a trainable group did not change")
        per_step = _expected_pretraining_launches(
            ucfg, vit, RESOLUTION, dtype=torch.float32)
        want = {k: 2 * v for k, v in per_step.items()}
        if launches != want:
            fail(f"f32_pretraining: launches {launches}, expected {want}")
        steady = result["step_seconds"][1:]
        print(json.dumps({
            "phase": "f32_pretraining", "card": smi, "dtype": "float32",
            "batch": batch, "out_of_memory": refused, "wall_s": wall,
            "step_seconds": result["step_seconds"],
            "s_per_step": sum(steady) / len(steady),
            "samples_per_s": batch * len(steady) / sum(steady),
            "max_memory_allocated_gb": peak / 1e9,
            "metrics": result["metrics"], "launches": launches}))
        del result, trained, world
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    fail(f"f32 pretraining: no batch of {F32_PRETRAIN_BATCHES} fits: "
         f"{refused}")


# ---- the training extras ---------------------------------------------------

# (b): 8-bit tuning calls: the first two are held against the plain
# version (EXTRAS_HELD_UPDATES), the third is profiled (--profile_steps 1:
# calls [2, 3)), the fourth and fifth are timed
EXTRAS_8BIT_STEPS = 5
# (b), (d): the 8-bit updates whose every EXTRAS_HELD_SHARE-th tensor (and
# the largest, and the first with a ragged tail) is held against the plain
# version fed the same gradients: the second reads the codes the first
# stored; the resumed pretraining update reads the restored ones
EXTRAS_HELD_UPDATES = (1, 2)
EXTRAS_HELD_SHARE = 10
# (c): the dots policy at the largest of these batches that fits
DOTS_BATCHES = (16, 8, 4)
# (d): 8-bit pretraining updates, a checkpoint at EXTRAS_PRETRAIN_CKPT, the
# profile window [10, 11); one more update resumed from the checkpoint
EXTRAS_PRETRAIN_STEPS = 11
EXTRAS_PRETRAIN_CKPT = 10
# (a): f32 operations an element of the 8-bit update (dequantize 2, the
# moments 7, the step 4, the decay 4, two requantizations of 10, the two
# absmax 2); its bytes: g and p read and p written (f32), both moments'
# codes read and written (int8), and 16 bytes of scales a block
ADAM8BIT_OPS_PER_ELEMENT = 39
TRACKER_SILENT = "[trackers] tensorboardX unavailable"
# device-kernel events in the training extras' traces (printed with the
# phase times, beside profiler_empty)
TRACE_DEVICE_KERNELS = {}


def _adam8bit_work(shapes):
    """(elements, blocks, the bound) of one 8-bit update of tensors of
    ``shapes``."""
    n = sum(math.prod(s) for s in shapes)
    blocks = sum(-(-math.prod(s) // 256) for s in shapes)
    return n, blocks, _bound(12 * n + 4 * 256 * blocks + 16 * blocks,
                             ADAM8BIT_OPS_PER_ELEMENT * 256 * blocks, 0,
                             flop_rate=F32_FLOP_PER_S)


def _adam8bit_hyper(count):
    from e4t_diffusion_torch.training import optim8bit as o8

    return o8.Adam8bitHyper(
        lr=1.6e-5, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
        b1c=o8.bias_correction(0.9, count),
        b2c=o8.bias_correction(0.999, count))


def _adam8bit_tensors(shapes, seed):
    """Seeded parameters and gradients of ``shapes`` on the card, with a
    new 8-bit state each."""
    import torch

    from e4t_diffusion_torch.training import optim8bit as o8

    gen = torch.Generator("cuda").manual_seed(seed)
    params = [0.05 * torch.randn(s, generator=gen, device="cuda")
              for s in shapes]
    grads = [1e-3 * torch.randn(s, generator=gen, device="cuda")
             for s in shapes]
    return params, grads, [o8.init_state(p) for p in params]


def _adam8bit_checks(shapes, require_edges=True, timed=True):
    """(a) The kernel against its plain version at ``shapes`` (every
    trainable tensor of a tuning step, which holds ragged tails and
    tensors of more than 4096 blocks: ``require_edges``; or pretraining's):
    two updates from the same gradients on each side, then the parameters,
    codes and scales compared (bit for bit predicted; a code off by more
    than one fails); ``timed``: the kernel's time an update (CUDA events around its
    launch on a built pointer table; its device time under the profiler
    beside it), the wrapper's (the table built on the host included), the
    plain version's and torch's f32 AdamW's on the same tensors (a
    yardstick: not the same function), and the bound."""
    import gc

    import torch

    from e4t_diffusion_torch.ops import adam8bit
    from e4t_diffusion_torch.training import optim8bit as o8

    sizes = [math.prod(s) for s in shapes]
    if require_edges and (not any(n % 256 for n in sizes)
                          or max(sizes) <= 4096 * 256):
        fail(f"8-bit AdamW check: the {len(shapes)} shapes hold no ragged "
             f"tail or no tensor of more than 4096 blocks")
    params, grads, states = _adam8bit_tensors(shapes, 17)
    plain = [p.clone() for p in params]
    plain_states = [o8.init_state(p) for p in plain]
    for count in (1, 2):
        h = _adam8bit_hyper(count)
        adam8bit.adam8bit_update(params, grads, states, h)
        for p, g, st in zip(plain, grads, plain_states):
            o8.adam8bit_reference(p, g, st, h)
    torch.cuda.synchronize()
    diff = {"params_differing": 0, "scales_differing": 0,
            "codes_off_by_one": 0, "codes_off_by_more": 0}
    max_abs = 0.0
    for p, q, st, sq in zip(params, plain, states, plain_states):
        diff["params_differing"] += int((p != q).sum())
        max_abs = max(max_abs, float((p - q).abs().max()))
        for key in ("mu_scale", "nu_scale"):
            diff["scales_differing"] += int((st[key] != sq[key]).sum())
        for key in ("mu_q", "nu_q"):
            d = (st[key].int() - sq[key].int()).abs()
            diff["codes_off_by_one"] += int((d == 1).sum())
            diff["codes_off_by_more"] += int((d > 1).sum())
    if any(diff.values()):
        fail(f"the 8-bit AdamW kernel against its plain version at "
             f"{len(shapes)} tensors, not bit for bit: {diff}")
    if not timed:
        del params, grads, states, plain, plain_states
        gc.collect()
        torch.cuda.empty_cache()
        return {"tensors": len(shapes), "elements": sum(sizes),
                "updates_compared": 2, "bit_equal": True, **diff,
                "max_abs_err": max_abs}
    h = _adam8bit_hyper(3)

    def kernel_run():
        adam8bit.adam8bit_update(params, grads, states, h)

    def plain_run():
        for p, g, st in zip(plain, grads, plain_states):
            o8.adam8bit_reference(p, g, st, h)

    table, blocks = adam8bit.pointer_table(params, grads, states)
    ms = cuda_time_ms(lambda: adam8bit.launch_table(table, blocks, h),
                      reps=10)
    profiled_ms, how = device_time(kernel_run, reps=5)
    wall_ms = cuda_time_ms(kernel_run, reps=5)
    plain_ms = cuda_time_ms(plain_run, reps=2)
    del plain, plain_states
    gc.collect()
    # the wrapper's host time an update (no wait): its table kept, and
    # rebuilt for gradients at other addresses, as a training step's are
    moved = [g.clone() for g in grads]

    def host_ms(grad_lists):
        times = []
        for gs in grad_lists:
            t0 = time.perf_counter()
            adam8bit.adam8bit_update(params, gs, states, h)
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    host = {"host_new_grads_ms": host_ms([moved, grads] * 3),
            "host_ms": host_ms([grads] * 5)}
    del moved
    gc.collect()
    for p, g in zip(params, grads):
        p.grad = g
    adamw = torch.optim.AdamW(params, lr=1.6e-5, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-2)
    adamw_ms = cuda_time_ms(adamw.step, reps=3)
    state_bytes = sum(v.numel() * v.element_size() for st in states
                      for v in st.values() if isinstance(v, torch.Tensor))
    del adamw, params, grads, states, table
    gc.collect()
    torch.cuda.empty_cache()
    n, blocks, bound = _adam8bit_work(shapes)
    return {"tensors": len(shapes), "elements": n, "blocks": blocks,
            "updates_compared": 2, "bit_equal": not any(diff.values()),
            **diff, "max_abs_err": max_abs, "ms": ms,
            "profiled_ms": profiled_ms, "profiled_by": how,
            "wall_ms": wall_ms, **host, "plain_ms": plain_ms,
            "adamw_f32_ms": adamw_ms, "state_bytes": state_bytes,
            "launches_per_update": 1, **bound}


@contextlib.contextmanager
def _adam8bit_held(what, updates=EXTRAS_HELD_UPDATES):
    """Every 8-bit AdamW update whose count is in ``updates``, made by the
    run inside the block (through the optimizer as the CLI calls it), held
    against the plain version fed the same gradients: before the update
    the parameters, gradients and states of every EXTRAS_HELD_SHARE-th
    tensor of a group, its largest and its first with a ragged tail are
    copied; after it the plain version updates the copies, which must
    equal the kernel's parameters, codes and scales bit for bit. Yields
    the record: the updates held, tensors and elements compared."""
    import torch
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)

    from e4t_diffusion_torch.training import optim8bit as o8

    record = {"updates": [], "tensors": 0, "elements": 0}
    held = []

    def pick(params):
        sizes = [p.numel() for p in params]
        idx = set(range(0, len(params), EXTRAS_HELD_SHARE))
        idx.add(max(range(len(params)), key=sizes.__getitem__))
        idx.update([i for i, n in enumerate(sizes) if n % 256][:1])
        return [params[i] for i in sorted(idx)]

    def pre(opt, args, kwargs):
        if not isinstance(opt, o8.AdamW8bit):
            return
        for group in opt.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            count = opt.state[params[0]].get("step", 0) + 1
            if count not in updates:
                continue
            b1, b2 = group["betas"]
            hyper = o8.Adam8bitHyper(
                lr=group["lr"], b1=b1, b2=b2, eps=group["eps"],
                weight_decay=group["weight_decay"],
                b1c=o8.bias_correction(b1, count),
                b2c=o8.bias_correction(b2, count),
                step_bf16=group["step_bf16"])
            for p in pick(params):
                st = opt.state[p]
                copy = ({k: st[k].clone() for k in o8.STATE_KEYS} if st
                        else o8.init_state(p))
                held.append((p, p.detach().clone(), p.grad.clone(), copy,
                             hyper))
            record["updates"].append(count)

    def post(opt, args, kwargs):
        if not isinstance(opt, o8.AdamW8bit):
            return
        for p, q, g, st, hyper in held:
            o8.adam8bit_reference(q, g, st, hyper)
            real = opt.state[p]
            if not torch.equal(p.detach(), q) or not all(
                    torch.equal(real[k], st[k]) for k in o8.STATE_KEYS):
                fail(f"training_extras ({what}): update "
                     f"{record['updates'][-1]} of a {tuple(p.shape)} tensor "
                     f"differs from the plain version fed its gradient")
            record["tensors"] += 1
            record["elements"] += p.numel()
        held.clear()

    handles = (register_optimizer_step_pre_hook(pre),
               register_optimizer_step_post_hook(post))
    try:
        yield record
    finally:
        for h in handles:
            h.remove()
    if sorted(set(record["updates"])) != sorted(updates):
        fail(f"training_extras ({what}): held updates {record['updates']}, "
             f"expected {list(updates)}")


def _trace_summary(profile_dir, what):
    """The one trace ``--profile_steps`` wrote into ``profile_dir``: it
    parses, and holds host ops of a step (convolutions, products); its
    event counts, device kernels among them."""
    import glob

    files = glob.glob(os.path.join(profile_dir or "", "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"training_extras ({what}): traces {files} in {profile_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    if "aten::convolution" not in ops or not ops & {"aten::mm",
                                                    "aten::addmm"}:
        fail(f"training_extras ({what}): the trace holds no step's host ops")
    TRACE_DEVICE_KERNELS[what] = len(kernels)
    return {"file": os.path.basename(files[0]),
            "bytes": os.path.getsize(files[0]), "events": len(events),
            "host_ops": sum(e.get("cat") == "cpu_op" for e in events),
            "device_kernels": len(kernels),
            "adam8bit_kernels": sum("adam8bit" in k for k in kernels)}


def _first_step_against(metrics, ref, what):
    rel = {k: abs(metrics[k] - ref[k]) / abs(ref[k])
           for k in ("loss", "grad_norm")}
    if not max(rel.values()) <= TUNING_LOSS_REL:
        fail(f"training_extras ({what}): the first step {metrics} against "
             f"{ref}")
    return {"rel": rel, "bit_equal": all(metrics[k] == ref[k]
                                         for k in ("loss", "grad_norm"))}


def _extras_tuning(smi, ref):
    """(b) 8-bit tuning and (c) the dots policy, each from phase 7's
    seeded weights, against phase 7's run (``ref``)."""
    import gc
    import importlib.util

    import torch

    report, launches = {}, _want()
    with tempfile.TemporaryDirectory() as out, \
            _adam8bit_held("b") as held:
        counts, run = phase_tuning(
            smi, EXTRAS_8BIT_STEPS, extra=(
                "--use_8bit_adam", "--report_to", "tensorboard",
                "--profile_steps", "1", "--output_dir", out),
            name="training_extras_8bit",
            untimed=max(EXTRAS_HELD_UPDATES))
        trace = _trace_summary(run["profile_dir"], "tuning")
        logs = os.path.join(out, "logs")
        tensorboard = importlib.util.find_spec("tensorboardX") is not None
        if tensorboard and not os.listdir(logs):
            fail("training_extras (b): no TensorBoard events written")
        if not tensorboard and TRACKER_SILENT not in run["printed"]:
            fail("training_extras (b): the tracker did not say it logs "
                 "nothing without tensorboardX")
    if trace["adam8bit_kernels"] not in (0, 1):
        fail(f"training_extras (b): {trace['adam8bit_kernels']} 8-bit "
             f"kernels in the one traced step")
    for k, v in counts.items():
        launches[k] += v
    report["tuning_8bit"] = {
        "first_step_vs_phase_7": _first_step_against(
            run["first_step"], ref["first_step"], "b"),
        "optimizer_state_bytes": run["optimizer_state_bytes"],
        "peak_gb": run["peak_gb"], "phase_7_peak_gb": ref["peak_gb"],
        "peak_drop_gb": ref["peak_gb"] - run["peak_gb"],
        "warm_s_per_step": run["s_per_step"],
        "phase_7_warm_s_per_step": ref["s_per_step"],
        "step_seconds": run["step_seconds"], "trace": trace,
        "held_against_plain": held,
        "tracker": "tensorboardX" if tensorboard else "says it logs "
                   "nothing (no tensorboardX)"}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    refused = []
    for batch in DOTS_BATCHES:
        try:
            counts, run = phase_tuning(
                smi, TUNING_STEPS, extra=("--remat_policy", "dots"),
                batch=batch, name="training_extras_dots")
        except torch.cuda.OutOfMemoryError as err:
            refused.append({"batch": batch, "error": str(err)[:200]})
        else:
            break
        gc.collect()  # the failed steps' tensors, freed with the traceback
        torch.cuda.empty_cache()
    else:
        fail(f"training_extras (c): no batch of {DOTS_BATCHES} fits: "
             f"{refused}")
    for k, v in counts.items():
        launches[k] += v
    report["tuning_dots"] = {
        "batch": batch, "out_of_memory": refused,
        "peak_gb": run["peak_gb"], "phase_7_peak_gb": ref["peak_gb"],
        "warm_s_per_step": run["s_per_step"],
        "phase_7_warm_s_per_step": ref["s_per_step"],
        "step_seconds": run["step_seconds"]}
    if batch == 16:
        report["tuning_dots"]["first_step_vs_phase_7"] = _first_step_against(
            run["first_step"], ref["first_step"], "c")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches


def _extras_pretraining(data, ref):
    """(d) 8-bit pretraining under ZeRO-1 through a one-rank NCCL group:
    EXTRAS_PRETRAIN_STEPS updates with a checkpoint at
    EXTRAS_PRETRAIN_CKPT and the profile window [10, 11), then one update
    resumed from the checkpoint; each checkpoint read back bit for bit at
    its save and its restore; the first step against phase 13's (``ref``)."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from e4t_diffusion_torch import seeded
    from e4t_diffusion_torch.parallel import mesh as pmesh
    from e4t_diffusion_torch.training.optim8bit import (AdamW8bit,
                                                        state_bytes)

    pmesh.initialize(0, 1, torch.device("cuda"),
                     init_method=f"tcp://localhost:{_free_port()}")
    try:
        world = seeded.pretraining_world()
        ucfg, vit = world[0].unet.config, world[0].e4t_encoder.config.vit
        per_step = _expected_pretraining_launches(ucfg, vit, RESOLUTION)
        out = tempfile.TemporaryDirectory()
        flags = ("--mixed_precision", "bf16", "--n_save_sample", "0",
                 "--use_8bit_adam", "--zero1", "--checkpointing_steps",
                 str(EXTRAS_PRETRAIN_CKPT), "--max_train_steps",
                 str(EXTRAS_PRETRAIN_STEPS), "--profile_steps", "1")
        checks = {}
        torch.cuda.reset_peak_memory_stats()
        with _checkpoints_checked(checks), _adam8bit_held("d") as held:
            result, launches, wall = _pretrain_run(
                _pretrain_args(data.name, out.name, *flags), world,
                mesh=pmesh.get_mesh())
        peak = torch.cuda.max_memory_allocated()
        metrics = result["metrics"]
        _metrics_finite(metrics, "training_extras (d)")
        opt = result["optimizer"]
        if len(metrics) != EXTRAS_PRETRAIN_STEPS or not (
                isinstance(opt, ZeroRedundancyOptimizer)
                and isinstance(opt.optim, AdamW8bit)):
            fail(f"training_extras (d): {len(metrics)} updates on "
                 f"{type(opt).__name__}")
        want = {k: EXTRAS_PRETRAIN_STEPS * v for k, v in per_step.items()}
        want["adam8bit"] = EXTRAS_PRETRAIN_STEPS
        if launches != want:
            fail(f"training_extras (d): launches {launches}, expected "
                 f"{want}")
        trace = _trace_summary(result["profile_dir"], "pretraining")
        shapes = [tuple(t.shape) for g in result["trainable"].values()
                  for t in g.values()]
        report = {
            "updates": EXTRAS_PRETRAIN_STEPS, "wall_s": wall,
            "first_step_vs_phase_13": _first_step_against(
                metrics[0], ref["first_step"], "d"),
            "optimizer_state_bytes": state_bytes(opt),
            "peak_gb": peak / 1e9, "phase_13_peak_gb": ref["peak_gb"],
            "step_seconds": result["step_seconds"],
            "phase_13_warm_s_per_step": ref["s_per_step"], "trace": trace,
            "held_against_plain": held, "last_metrics": metrics[-1]}
        del result, opt
        gc.collect()
        torch.cuda.empty_cache()
        with _checkpoints_checked(checks), _adam8bit_held(
                "d, resumed", (EXTRAS_PRETRAIN_CKPT + 1,)) as held_resumed:
            resumed, launches2, _ = _pretrain_run(
                _pretrain_args(data.name, out.name, *flags,
                               "--resume_from_checkpoint", "latest"),
                world, mesh=pmesh.get_mesh())
        ckpt = f"checkpoint-{EXTRAS_PRETRAIN_CKPT}"
        if resumed["resumed_from"] != os.path.join(out.name, ckpt) or len(
                resumed["metrics"]) != 1 or resumed["profile_dir"]:
            fail(f"training_extras (d): resumed from "
                 f"{resumed['resumed_from']}, {resumed['metrics']}")
        _metrics_finite(resumed["metrics"], "training_extras (d), resumed")
        want = dict(per_step, adam8bit=1)
        if launches2 != want:
            fail(f"training_extras (d), resumed: launches {launches2}")
        if [c["path"] for c in checks.get("saved", [])] != [ckpt] or [
                c["path"] for c in checks.get("restored", [])] != [ckpt]:
            fail(f"training_extras (d): checkpoints {checks}")
        report.update(checkpoints=checks, resumed=resumed["metrics"][0],
                      resumed_held_against_plain=held_resumed)
        del resumed, world
        out.cleanup()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    report["adam8bit_at_pretraining_shapes"] = _adam8bit_checks(
        shapes, require_edges=False)
    total = {k: launches[k] + launches2[k] for k in launches}
    return report, total


def phase_training_extras(smi, tuning_ref, pretraining_ref, data):
    """The training CLIs' last flags on the card: (a) the 8-bit AdamW
    kernel at every trainable tensor of a tuning step against its plain
    version, (b) tuning with ``--use_8bit_adam`` (and the tracker and a
    trace), (c) tuning with ``--remat_policy dots``, (d) pretraining with
    ``--use_8bit_adam --zero1`` (a checkpoint, a resumed update, a trace),
    (e) the traces parsed. Returns (the launches of (b)-(d), (a)'s
    record)."""
    import gc

    import torch

    from e4t_diffusion_torch import seeded
    from e4t_diffusion_torch.training.train_step import (E4TTrainConfig,
                                                         split_trainable)

    modules, offsets = seeded.tuning_world(RESOLUTION)[:2]
    trainable, _ = split_trainable(modules, offsets,
                                   E4TTrainConfig(train_unet=True),
                                   torch.bfloat16)
    shapes = [tuple(t.shape) for g in trainable.values()
              for t in g.values()]
    del modules, offsets, trainable
    gc.collect()
    torch.cuda.empty_cache()
    report = {"phase": "training_extras", "card": smi,
              "adam8bit": _adam8bit_checks(shapes)}
    tuning, launches = _extras_tuning(smi, tuning_ref)
    report.update(tuning)
    report["pretraining_8bit_zero1"], counts = _extras_pretraining(
        data, pretraining_ref)
    for k, v in counts.items():
        launches[k] += v
    want = EXTRAS_8BIT_STEPS + EXTRAS_PRETRAIN_STEPS + 1
    if launches["adam8bit"] != want:
        fail(f"training_extras: {launches['adam8bit']} 8-bit AdamW "
             f"launches, expected {want}")
    report["launches"] = launches
    print(json.dumps(report))
    return launches, report["adam8bit"]


# ---- the parallel phase ----------------------------------------------------

# (a): flash sites (B, H, S, D, with the backward) run on two halves and on
# the whole: the heads split where H is even (tensor parallelism's cut),
# else the batch (the unCLIP UNet's first block has 5 heads)
PARALLEL_SPLIT_SITES = ((16, 8, 4096, 40, True), (8, 8, 1024, 80, True),
                        (8, 5, 9216, 64, False))
# (b): updates a world-1 run takes; the first warms up, the rest are timed
# (their median); 4, cut from 6 to make room for the training extras
PARALLEL_STEPS = 4
# (c): the CLIs' runs, with and without torchrun: pretraining updates
# (cut from 2 for the sd2_e4t phase) and sampling steps (cut from 4)
PARALLEL_CLI_BATCH = 4
PARALLEL_CLI_STEPS = 1
PARALLEL_CLI_SAMPLE_STEPS = 2
PARALLEL_CLI_TIMEOUT_S = 300


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _host_copy(groups):
    """{group: {name: tensor}} copied to the host (a later run's tensors
    are compared with these bit for bit)."""
    return {g: {k: t.detach().to("cpu", copy=True) for k, t in grp.items()}
            for g, grp in groups.items()}


def _same_bits(a, b, what):
    import torch

    if {g: sorted(x) for g, x in a.items()} != {g: sorted(x)
                                                 for g, x in b.items()}:
        fail(f"parallel: {what}: other tensors")
    bad = [f"{g}.{k}" for g in a for k in a[g]
           if not torch.equal(a[g][k], b[g][k])]
    if bad:
        fail(f"parallel: {what}: {len(bad)} tensors differ, e.g. {bad[:3]}")


def _optimizer_tensors(state):
    """An optimizer state dict's per-tensor state, on the host."""
    return {str(i): {k: v.detach().cpu() for k, v in st.items()}
            for i, st in state["state"].items()}


def _checkpoint_held(ckpt):
    """What a train-state checkpoint must hold bit for bit across two runs:
    its trainables, optimizer state and every rank's generator state."""
    return {"checkpoint trainables": ckpt["trainable"],
            "checkpoint optimizer": _optimizer_tensors(ckpt["optimizer"]),
            "checkpoint generators": {str(i): {"state": g} for i, g in
                                      enumerate(ckpt["generators"])}}


def _split_heads_checks():
    """(a) One split, no collective: the flash forward (and at the training
    sites the backward) on each half of the heads, put back together,
    equals the whole call bit for bit."""
    import torch

    from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    gen = torch.Generator("cuda").manual_seed(7)
    report = []
    for b, h, s, d, backward in PARALLEL_SPLIT_SITES:
        q, k, v, dout = (torch.randn((b, h, s, d), generator=gen,
                                     device="cuda", dtype=torch.bfloat16)
                         for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        axis = 1 if h % 2 == 0 else 0

        def call(q, k, v, dout):
            bb, hh = q.shape[:2]
            flat = [t.reshape(bb * hh, s, d).contiguous()
                    for t in (q, k, v, dout)]
            out, lse = flash_fwd(*flat[:3], scale)
            outs = [out, lse]
            if backward:
                outs += flash_bwd(*flat[:3], out, lse, flat[3], scale)
            return [t.reshape(bb, hh, *t.shape[1:]) for t in outs]

        whole = call(q, k, v, dout)
        n = q.shape[axis] // 2
        halves = [call(*(t.narrow(axis, i * n, n) for t in (q, k, v, dout)))
                  for i in range(2)]
        torch.cuda.synchronize()
        names = ["out", "lse", "dq", "dk", "dv"][:len(whole)]
        for name, ref, a, c in zip(names, whole, *halves):
            if not torch.equal(torch.cat([a, c], dim=axis), ref):
                fail(f"parallel: split {'heads' if axis else 'batch'} at "
                     f"BH {b * h} {s}²/d{d}: {name} differs from the whole "
                     f"call")
        report.append({"bh": b * h, "s": s, "d": d,
                       "split": "heads" if axis else "batch",
                       "checked": names, "bit_equal": True})
    return report


def _world1_runs(data_dir, mesh):
    """(b) The dp path at world size 1 under NCCL: PARALLEL_STEPS tuning
    steps (batch 16, 512px, ``--tensor_parallel 1``), bf16 pretraining
    steps and ``--zero1`` pretraining steps, each from seeded weights,
    without the process group and through it (``mesh``), bit for bit: the
    metrics, the trainables after the updates, the optimizer state
    (unsharded) and the checkpoint the last step wrote; each run's step
    time is the median of its steps after the first. Returns (report, the
    launches of the runs through the group)."""
    import gc

    import torch

    from e4t_diffusion_torch import seeded, tuning_e4t
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.parallel import mesh as pmesh
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.utils import artifacts

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    report, launches = {}, _want()

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    runs = {}
    for tag, m in (("tuning", None), ("tuning_group", mesh)):
        modules, offsets, tokenizer, class_id, image = seeded.tuning_world(
            RESOLUTION)
        args = tuning_e4t.parse_args([
            "--pretrained_model_name_or_path", "-", "--train_image_path",
            "-", "--max_train_steps", str(PARALLEL_STEPS),
            "--mixed_precision", "bf16", "--train_batch_size", "16",
            "--tensor_parallel", "1"])
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = tuning_e4t.tune(args, modules, offsets, tokenizer, "*s",
                                 resolve_templates("normal"), class_id,
                                 image, NoiseScheduleConfig(),
                                 torch.bfloat16, mesh=m)
        torch.cuda.synchronize()
        runs[tag] = {"wall_s": time.perf_counter() - t0,
                     "step_s": result["step_seconds"],
                     "metrics": result["metrics"],
                     "launches": _read_launches(),
                     "grad_bytes": 4 * sum(t.numel() for g in result[
                         "trainable"].values() for t in g.values()),
                     "held": {"trainables": _host_copy(
                         result["trainable"])}}
        del modules, offsets, result
        free()
    for tag, m, extra in (("pretraining", None, ()),
                          ("pretraining_group", mesh, ()),
                          ("zero1_group", mesh, ("--zero1",))):
        world = seeded.pretraining_world()
        with tempfile.TemporaryDirectory() as out:
            args = _pretrain_args(data_dir, out, "--mixed_precision", "bf16",
                                  "--max_train_steps",
                                  str(PARALLEL_STEPS),
                                  "--n_save_sample", "0",
                                  "--checkpointing_steps",
                                  str(PARALLEL_STEPS), *extra)
            result, counts, wall = _pretrain_run(args, world, mesh=m)
            state = pmesh.consolidated_state_dict(result["optimizer"])
            ckpt = torch.load(os.path.join(out,
                                           f"checkpoint-{PARALLEL_STEPS}",
                                           artifacts.TRAIN_STATE_FILE),
                              map_location="cpu", weights_only=True)
        runs[tag] = {"wall_s": wall, "step_s": result["step_seconds"],
                     "metrics": result["metrics"], "launches": counts,
                     "grad_bytes": 4 * sum(t.numel() for g in result[
                         "trainable"].values() for t in g.values()),
                     "held": {"trainables": _host_copy(result["trainable"]),
                              "optimizer": _optimizer_tensors(state),
                              **_checkpoint_held(ckpt)}}
        del world, result, state
        free()
    for ref, tag in (("tuning", "tuning_group"),
                     ("pretraining", "pretraining_group"),
                     ("pretraining", "zero1_group")):
        a, b = runs[ref], runs[tag]
        if a["metrics"] != b["metrics"]:
            fail(f"parallel: {tag}: metrics {b['metrics']} against "
                 f"{a['metrics']} without the group")
        if a["launches"] != b["launches"]:
            fail(f"parallel: {tag}: launches {b['launches']} against "
                 f"{a['launches']}")
        for part, tensors in a["held"].items():
            _same_bits(tensors, b["held"][part], f"{tag}, {part}")
        add(b["launches"])
        report[tag] = {"bit_equal": True, "metrics": b["metrics"][-1],
                       "warm_step_s_median": statistics.median(
                           b["step_s"][1:]),
                       "warm_step_s_median_without_group": statistics.median(
                           a["step_s"][1:]),
                       "step_s": b["step_s"],
                       "step_s_without_group": a["step_s"],
                       "wall_s": b["wall_s"],
                       "wall_s_without_group": a["wall_s"],
                       # what dp > 1 all-reduces (f32); dp = 1 skips it
                       "dp_all_reduce_bytes_per_update": b["grad_bytes"],
                       "launches": b["launches"]}
    for kernel in ("flash_fwd_lowdim", "flash_fwd_wide", "flash_bwd"):
        if not launches[kernel]:
            fail(f"parallel: the world-1 steps launched no {kernel}")
    return report, launches


VALIDATION_TIMEOUT_S = 600
VALIDATION_KEYS = {"metric", "prompt", "staged_ckpt", "tuned_ckpt",
                   "bf16_sample", "int8_sample", "int8_vs_bf16",
                   "clip_scores"}


def _start_validation(root):
    """Start ``python -m e4t_diffusion_torch.validate_real_weights`` in the
    background on the serving phase's model directory (``root/sd``, its
    artifact ``root/e4t``) as the one-command chain runs it: the checkpoint
    staged onto ``--sd_dir``, 1 tuning step (the CLI's defaults: f32,
    batch 4, 512px, 8-bit AdamW), then bf16 and static int8 sampling at 2
    steps, each step a process of its own. Stopped at exit if still
    running. Returns (the ``_start_clis`` handle, its output directory)."""
    import atexit

    import numpy as np
    from PIL import Image

    out = os.path.join(root, "validation")
    domain = os.path.join(root, "domain.png")
    Image.fromarray(np.random.default_rng(21).integers(
        0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)).save(domain)
    started = _start_clis([(
        "validate_real_weights", "e4t_diffusion_torch.validate_real_weights",
        ["--e4t_ckpt", os.path.join(root, "e4t"),
         "--sd_dir", os.path.join(root, "sd"), "--domain_image", domain,
         "--tune_steps", "1", "--num_inference_steps", "2",
         "--resolution", str(RESOLUTION), "--seed", "0", "--out_dir", out],
        False)], root)

    def stop():
        for proc, _ in started[1].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return started, out


def phase_validate_real_weights(smi, started, out):
    """Wait for ``_start_validation``'s chain and check its record: the JAX
    script's keys, the staged config naming ``--sd_dir``, the tuned
    artifact, both samples at 512px, a finite int8-vs-bf16 delta."""
    import numpy as np
    from PIL import Image

    t0 = time.perf_counter()
    walls = _wait_clis(started, VALIDATION_TIMEOUT_S, "validate_real_weights")
    waited = time.perf_counter() - t0
    with open(os.path.join(out, "validation.json"), encoding="utf-8") as f:
        record = json.load(f)
    if set(record) != VALIDATION_KEYS:
        fail(f"validate_real_weights: keys {sorted(record)}")
    with open(os.path.join(record["staged_ckpt"], "config.json"),
              encoding="utf-8") as f:
        staged = json.load(f)["pretrained_model_name_or_path"]
    sd_dir = os.path.join(os.path.dirname(out), "sd")
    tuned = sorted(os.listdir(record["tuned_ckpt"]))
    sizes = []
    for key in ("bf16_sample", "int8_sample"):
        with Image.open(record[key]) as img:
            sizes.append(img.size)
    delta = record["int8_vs_bf16"]
    report = {"phase": "validate_real_weights", "card": smi,
              "chain_s": walls["validate_real_weights"], "waited_s": waited,
              "record": record, "tuned_files": tuned, "sample_sizes": sizes}
    print(json.dumps(report))
    if not (staged == os.path.abspath(sd_dir)
            and {"config.json", "encoder.pt", "unet.pt"} <= set(tuned)
            and sizes == [(RESOLUTION, RESOLUTION)] * 2
            and np.isfinite(delta["rel_l2"]) and np.isfinite(delta["psnr_db"])
            and 0.0 < delta["rel_l2"] < 1.0):
        fail(f"validate_real_weights: {report}")
    return report


def _start_clis(runs, log_dir):
    """Start ``python -m module argv`` for every (name, module, argv,
    torchrun) of ``runs`` from the checkout's root, under ``torchrun
    --nproc_per_node 1`` or not, all at once on the one card, their output
    into ``log_dir``. Returns the handle ``_wait_clis`` takes."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    procs = {}
    for name, module, argv, torchrun in runs:
        launcher = (["-m", "torch.distributed.run", "--nproc_per_node", "1",
                     "--master_addr", "localhost", "--master_port",
                     str(_free_port())] if torchrun else [])
        log = open(os.path.join(log_dir, f"{name}.log"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, *launcher, "-m", module, *argv], cwd=repo,
            env=env, stdout=log, stderr=subprocess.STDOUT), log)
    return time.perf_counter(), procs


def _wait_clis(started, timeout=PARALLEL_CLI_TIMEOUT_S, what="parallel"):
    """Wait for the processes ``_start_clis`` started; fail on a non-zero
    exit or at ``timeout`` seconds from their start, and stop every one
    still running whenever this returns or raises. Returns {name: wall
    seconds from the common start to its exit}."""
    t0, procs = started
    walls = {}
    try:
        for name, (proc, log) in procs.items():
            rc = proc.wait(timeout=max(
                1.0, timeout - (time.perf_counter() - t0)))
            walls[name] = time.perf_counter() - t0
            if rc:
                log.seek(0)
                fail(f"{what}: {name} exited {rc}:\n{log.read()[-6000:]}")
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return walls


@contextlib.contextmanager
def _torchrun_clis(data_dir, report):
    """(c) The CLIs under ``torchrun --nproc_per_node 1``: the inference CLI
    with ``--data_parallel_serving`` and a PARALLEL_CLI_STEPS-step
    ``pretrain_e4t --zero1``, each also launched without torchrun, on a
    written full-width model directory (seeded bf16 weights); the images
    and the checkpoint bit for bit. The four processes start on entry and
    run while the block does (each spends most of its wall starting,
    loading and writing, and none reads what another writes); on exit
    they are waited for and compared, their walls and the verdict put in
    ``report``."""
    import types

    import numpy as np
    import torch
    from PIL import Image

    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.utils import artifacts

    with tempfile.TemporaryDirectory() as root:
        torch.manual_seed(0)
        mods = E4TModules.create(UNetConfig(), VAEConfig(), CLIPTextConfig(),
                                 E4TEncoderConfig(), dtype=torch.bfloat16,
                                 device="cuda")
        offsets = wo.init_offset_bank(
            mods.unet.config, torch.Generator("cuda").manual_seed(1),
            device="cuda")
        artifact = _write_serving_artifact(
            root, types.SimpleNamespace(modules=mods, offsets=offsets))
        del mods, offsets
        torch.cuda.empty_cache()
        image = os.path.join(root, "in.png")
        Image.fromarray(np.random.default_rng(0).integers(
            0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)).save(image)
        infer = ["--pretrained_model_name_or_path", artifact,
                 "--image_path_or_url", image, "--prompt", PROMPTS[0],
                 "--num_inference_steps", str(PARALLEL_CLI_SAMPLE_STEPS),
                 "--guidance_scale",
                 "7.5", "--num_images_per_prompt", "2", "--height",
                 str(RESOLUTION), "--width", str(RESOLUTION), "--seed", "0",
                 "--data_parallel_serving"]
        pre = ["--pretrained_model_name_or_path", os.path.join(root, "sd"),
               "--train_image_dataset", data_dir, "--domain_class_token",
               "face", "--prompt_template", "normal", "--train_batch_size",
               str(PARALLEL_CLI_BATCH), "--resolution", str(RESOLUTION),
               "--max_train_steps", str(PARALLEL_CLI_STEPS),
               "--checkpointing_steps", str(PARALLEL_CLI_STEPS),
               "--n_save_sample", "0", "--mixed_precision", "bf16",
               "--zero1", "--report_to", "tensorboard", "--seed", "0"]
        grids, states = {}, {}
        tags = {"plain": False, "torchrun": True}
        started = _start_clis(
            [(f"inference_{tag}_s", "e4t_diffusion_torch.inference",
              infer + ["--output", os.path.join(root, f"grid-{tag}.png")],
              torchrun) for tag, torchrun in tags.items()]
            + [(f"pretrain_{tag}_s", "e4t_diffusion_torch.pretrain_e4t",
                pre + ["--output_dir", os.path.join(root, f"pre-{tag}")],
                torchrun) for tag, torchrun in tags.items()], root)
        try:
            yield
        except BaseException:
            for proc, log in started[1].values():
                proc.kill()
                proc.wait()
                log.close()
            raise
        report.update(_wait_clis(started))
        for tag in tags:
            grids[tag] = np.asarray(Image.open(
                os.path.join(root, f"grid-{tag}.png")))
            out = os.path.join(root, f"pre-{tag}")
            ckpt = torch.load(os.path.join(
                out, f"checkpoint-{PARALLEL_CLI_STEPS}",
                artifacts.TRAIN_STATE_FILE), map_location="cpu",
                weights_only=True)
            step_dir = os.path.join(out, str(PARALLEL_CLI_STEPS))
            states[tag] = {**_checkpoint_held(ckpt), "artifact": {
                name: torch.load(os.path.join(step_dir, name),
                                 map_location="cpu", weights_only=True)
                for name in ("weight_offsets.pt", "encoder.pt")}}
        if grids["plain"].shape != (RESOLUTION, 2 * RESOLUTION, 3):
            fail(f"parallel: inference grid {grids['plain'].shape}")
        if not np.array_equal(grids["plain"], grids["torchrun"]):
            fail("parallel: the inference CLI under torchrun rendered other "
                 "images")
        for part, tensors in states["plain"].items():
            _same_bits(tensors, states["torchrun"][part],
                       f"pretrain_e4t --zero1 under torchrun, {part}")
    report["bit_equal"] = True


# (d): the multi-card runs, f32 (the CPU tests' tolerances): a pretraining
# step at dp=2 (one row a rank) against world 1 at two rows, with the same
# draws; sampling at tp=2 and at dp=2 against world 1
MULTI_CARD_TIMEOUT_S = 600
MULTI_LOSS_REL = 1e-5
MULTI_UPDATE_REL = 1e-3
MULTI_IMAGE_TOL = 1e-4


def _multi_card_work(mesh_for):
    """(d)'s work on this process's card: ``mesh_for(tp)`` gives the grid
    (None: one process). Returns {"step": metrics, before and after of the
    trainables (host), "images": {"tp": ..., "dp": ...}}, the images of
    the whole batch."""
    import gc

    import numpy as np
    import torch

    from e4t_diffusion_torch import seeded
    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.diffusion.pipeline import (
        E4TModules, StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.parallel import mesh as pmesh
    from e4t_diffusion_torch.templates import resolve_templates
    from e4t_diffusion_torch.training import train_step as ts
    from e4t_diffusion_torch.training.setup import TemplateSampler

    out = {}
    modules, offsets, tokenizer, placeholder_id, class_id = \
        seeded.pretraining_world()
    sampler = TemplateSampler(resolve_templates("normal"), tokenizer, "*s",
                              placeholder_id, seed=0)
    ids, ph = sampler.sample(2)
    rng = np.random.default_rng(0)
    side = RESOLUTION // 8
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in {
        "pixel_values": rng.uniform(-1, 1, (2, 3, RESOLUTION, RESOLUTION)
                                    ).astype(np.float32),
        "input_ids": ids, "placeholder_idx": ph,
        "uncond_ids": sampler.uncond_ids, "class_token_id": class_id,
        "noise": rng.standard_normal((2, 4, side, side)).astype(np.float32),
        "timesteps": rng.integers(0, 1000, (2,)),
        "posterior_noise": rng.standard_normal((2, 4, side, side)).astype(
            np.float32)}.items()}
    mesh = mesh_for(1) or pmesh.Mesh()
    batch = {k: (v[mesh.rows(2)] if k in ts._PER_SAMPLE else v)
             for k, v in batch.items()}
    cfg = ts.E4TTrainConfig(train_unet=False, max_grad_norm=None)
    trainable, _ = ts.split_trainable(modules, offsets, cfg, torch.float32)
    before = _host_copy(trainable)
    flat = [t for g in trainable.values() for t in g.values()]
    opt = ts.make_optimizer(flat, 1.6e-5)
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable, opt,
                              lambda n: 1.6e-5, mesh=mesh)
    out["step"] = {"metrics": {k: float(v) for k, v in step(batch).items()},
                   "before": before, "after": _host_copy(trainable)}
    del modules, offsets, trainable, opt, step, flat
    gc.collect()
    torch.cuda.empty_cache()
    out["images"] = {}
    for kind, tp in (("tp", 2), ("dp", 1)):
        grid = mesh_for(tp)
        if grid is None and out["images"]:  # one process: one reference
            out["images"][kind] = out["images"]["tp"]
            continue
        torch.manual_seed(0)
        mods = E4TModules.create(dtype=torch.float32, device="cuda")
        bank = wo.init_offset_bank(mods.unet.config,
                                   torch.Generator("cuda").manual_seed(1),
                                   device="cuda")
        if grid is not None:
            pmesh.apply_tensor_parallel(mods.unet, grid)
        pipe = StableDiffusionE4TPipeline(
            mods, bank, tokenizer, AttributeDict({
                "placeholder_token": "*s", "domain_class_token": "face",
                "domain_embed_scale": 0.1}),
            already_added_placeholder_token=True, mesh=grid,
            data_parallel=grid is not None and kind == "dp")
        image = np.random.default_rng(1).integers(
            0, 256, (RESOLUTION, RESOLUTION, 3), dtype=np.uint8)
        out["images"][kind] = pipe(PROMPTS, image, num_inference_steps=STEPS,
                                   guidance_scale=7.5,
                                   num_images_per_prompt=1, seed=0)
        del mods, pipe
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _multi_card_rank(rank, world, port, out_dir):
    """One rank of (d), on card ``rank``, in a NCCL group of ``world``."""
    import torch
    import torch.distributed as dist

    from e4t_diffusion_torch.parallel import mesh as pmesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pmesh.initialize(rank, world, torch.device("cuda", rank),
                     init_method=f"tcp://localhost:{port}")
    try:
        out = _multi_card_work(lambda tp: pmesh.get_mesh(tp))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(target, world, timeout, what):
    """``world`` processes (spawn) running ``target(rank, world, port,
    out_dir)``, each saving ``out_dir/rank<r>.pt``; the saved objects in
    rank order. A rank that fails or outlives ``timeout`` fails the run
    (the others are killed)."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        procs = [ctx.Process(target=target, args=(r, world, port, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode for p in procs):
            fail(f"parallel: {what} ranks exited "
                 f"{[p.exitcode for p in procs]}")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# (e): the bf16 UNet at tp=2, two ranks on one card over gloo (NCCL refuses
# two ranks a card; gloo moves the CUDA tensors through the host): the
# noise prediction and its input gradient at batch TP_BF16_BATCH, 512px,
# against tp=1 in bf16 and against f32. Each row-parallel site's partial
# products are f32 (cuBLAS's accumulator, not rounded to bf16) summed over
# tp in f32, then rounded to bf16 once, as tp=1 rounds its product once.
TP_BF16_BATCH = 2
TP_BF16_TIMEOUT_S = 300
# bf16's own error sets the scale: tp=1 and tp=2 are two bf16 roundings of
# one f32 computation, each its own distance from f32. Held: tp=2's rel-L2
# against f32, and against tp=1, at most TP_BF16_RATIO times tp=1's
# against f32 (eps and dx), and tp=2 against tp=1 below TP_BF16_REL_L2
TP_BF16_RATIO = 1.5
TP_BF16_REL_L2 = 5e-2


def _tp_bf16_work(mesh, dtype):
    """The full-width UNet (seeded) in ``dtype``, split over ``mesh``'s tp
    (None: whole), on one seeded batch: eps and d(sum(eps * dout))/dx, f32
    on the host."""
    import torch

    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.parallel import mesh as pmesh

    torch.manual_seed(0)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(UNetConfig())
    unet.to(dtype).eval().requires_grad_(False)
    if mesh is not None:
        pmesh.apply_tensor_parallel(unet, mesh)
    gen = torch.Generator("cuda").manual_seed(1)
    side = RESOLUTION // 8
    x = torch.randn((TP_BF16_BATCH, 4, side, side), generator=gen,
                    device="cuda")
    ctx = torch.randn((TP_BF16_BATCH, 77, unet.config.cross_attention_dim),
                      generator=gen, device="cuda")
    dout = torch.randn(x.shape, generator=gen, device="cuda")
    t = torch.linspace(100, 900, TP_BF16_BATCH, device="cuda").long()
    x = x.to(dtype).requires_grad_(True)
    eps = unet(x, t, ctx.to(dtype))
    (eps.float() * dout).sum().backward()
    out = {"eps": eps.detach().float().cpu(), "dx": x.grad.float().cpu()}
    del unet, x, eps
    torch.cuda.empty_cache()
    return out


def _tp_bf16_rank(rank, world, port, out_dir):
    """One rank of (e), on card 0, in a gloo group of ``world``."""
    import torch
    import torch.distributed as dist

    from e4t_diffusion_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = _tp_bf16_work(pmesh.get_mesh(world), torch.bfloat16)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_bf16_checks():
    """(e): the bf16 tp=2 UNet pass and backward against tp=1 and f32."""
    import torch

    f32 = _tp_bf16_work(None, torch.float32)
    one = _tp_bf16_work(None, torch.bfloat16)
    ranks = _spawn_ranks(_tp_bf16_rank, 2, TP_BF16_TIMEOUT_S, "bf16 tp=2")

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    report = {"batch": TP_BF16_BATCH, "resolution": RESOLUTION,
              "rel_l2_limit": TP_BF16_REL_L2, "ratio_limit": TP_BF16_RATIO}
    for key in ("eps", "dx"):
        if not torch.isfinite(ranks[0][key]).all():
            fail(f"parallel: bf16 tp=2 {key} is not finite")
        if not torch.equal(ranks[0][key], ranks[1][key]):
            fail(f"parallel: bf16 tp=2 ranks' {key} differ")
        got = {"tp2_vs_tp1": rel(ranks[0][key], one[key]),
               "tp1_vs_f32": rel(one[key], f32[key]),
               "tp2_vs_f32": rel(ranks[0][key], f32[key])}
        report[key] = got
        scale = TP_BF16_RATIO * got["tp1_vs_f32"]
        if not (got["tp2_vs_tp1"] <= min(scale, TP_BF16_REL_L2)
                and got["tp2_vs_f32"] <= scale):
            fail(f"parallel: bf16 tp=2 {key}: {got}")
    return report


def _multi_card_checks():
    """(d) Two cards under NCCL: a dp=2 f32 pretraining step against world
    1 with the same draws (loss, update), tp=2 and dp=2 sampling against
    world 1, within the CPU tests' tolerances. Returns the differences."""
    import torch

    ref = _multi_card_work(lambda tp: None)
    torch.cuda.empty_cache()
    ranks = _spawn_ranks(_multi_card_rank, 2, MULTI_CARD_TIMEOUT_S,
                         "multi-card")
    report = {}
    want = ref["step"]
    for r, got in enumerate(ranks):
        rel = abs(got["step"]["metrics"]["loss"] - want["metrics"]["loss"]) \
            / abs(want["metrics"]["loss"])
        updates = {}
        for g, tensors in want["after"].items():
            keys = sorted(tensors)
            start = torch.cat([want["before"][g][k].ravel()
                               for k in keys]).double()
            a = torch.cat([got["step"]["after"][g][k].ravel()
                           for k in keys]).double() - start
            b = torch.cat([tensors[k].ravel() for k in keys]).double() - start
            updates[g] = float((a - b).norm() / b.norm())
        diffs = {kind: float(abs(got["images"][kind] - img).max())
                 for kind, img in ref["images"].items()}
        if not (rel <= MULTI_LOSS_REL and max(updates.values())
                <= MULTI_UPDATE_REL and max(diffs.values())
                <= MULTI_IMAGE_TOL):
            fail(f"parallel: rank {r} of 2 cards: loss rel {rel}, updates "
                 f"{updates}, images {diffs}")
        report[f"rank{r}"] = {"loss_rel": rel, "update_rel": updates,
                              "image_max_abs": diffs}
    return report


def phase_parallel(smi, data_dir):
    """The parallel layer on the card (``parallel/mesh.py``): (a) the flash
    kernels on each half of the heads against the whole call, (b) the
    tuning, pretraining and ZeRO-1 steps through a one-rank NCCL process
    group against the same steps without one, (c) the inference and
    pretraining CLIs under ``torchrun --nproc_per_node 1`` against the same
    runs without it, (e) the bf16 UNet at tp=2 on the one card (two gloo
    ranks) against tp=1 and f32, and (d) with two or more cards, the
    multi-rank runs. Every other comparison on one card is bit for bit.
    Returns the launches of (b)'s runs through the group."""
    import torch
    import torch.distributed as dist

    from e4t_diffusion_torch.parallel import mesh as pmesh

    report = {"phase": "parallel", "card": smi, "cli": {}}
    # (a) and (e) check values only and hold a few GB (batch 2 at most), so
    # they run beside (c)'s processes; (b) is timed, so it runs alone
    with _torchrun_clis(data_dir, report["cli"]):
        report["split_heads"] = _split_heads_checks()
        report["tp2_bf16_one_card_gloo"] = _tp_bf16_checks()
    pmesh.initialize(0, 1, torch.device("cuda"),
                     init_method=f"tcp://localhost:{_free_port()}")
    try:
        report["world1"], launches = _world1_runs(data_dir, pmesh.get_mesh())
    finally:
        dist.destroy_process_group()
    worlds = [1]
    cards = torch.cuda.device_count()
    if cards >= 2:
        report["multi_card"] = _multi_card_checks()
        worlds.append(2)
    print(json.dumps(report))
    print(json.dumps({"parallel_worlds": worlds, "cards": cards}))
    return launches


# ---------------------------------------------------------------------------
# E4T on an SD v2-family base: stabilityai/stable-diffusion-2-1 at 768px
# ---------------------------------------------------------------------------

# SD 2.1 as its published unet/, text_encoder/ and scheduler/ configs give
# it (UNetConfig.sd2, CLIPTextConfig.sd2, v-prediction): 64-dim heads, 5,
# 10 and 20 of them at levels 0-2 and 20 at the mid block; 768px, 96²
# latents. Training runs at the CLIs' batch 16, or the largest of these
# that fits; sampling at 2 prompts x 4 images, CFG 7.5
SD2_RESOLUTION = 768
SD2_TRAIN_BATCHES = (16, 8, 4)
SD2_PRETRAIN_STEPS = 2
SD2_TUNING_STEPS = 3
# the static int8 run's calibration trajectory (E4T_INT8_CALIB_STEPS; the
# serving default is 8)
SD2_CALIB_STEPS = 2
# (heads, latent side) of the UNet's attention levels at 768px: levels 0-2
# and the mid block, whose 144 tokens reach flash in training
SD2_LEVELS = ((5, 96), (10, 48), (20, 24), (20, 12))
# the largest share of the f32 score tensor a plain version may hold at
# once (its other temporaries are a few times that)
PLAIN_SCORE_BYTES = 4 << 30


def _sd2_kernel_cases(gen, batch=16):
    """(fwd, bwd, int8): the flash forward and backward at d64 at the SD
    2.1 training step's sites, batch 16 at 768px: self-attention and the
    77-token cross attention at every level, the mid block's 144 tokens
    included (BH = batch x heads), each against its plain version (over
    slices of BH where the scores would not fit whole) and its synchronous
    design, timed beside SDPA and the bound. The sampling run's d64 flash
    sites (batch 8: BH 40 9216², 80 2304², 160 576²) are the unCLIP UNet's,
    timed in ``unclip_flash``. ``int8``: the int8 kernels at the SD 2.1
    UNet's serving shapes (batch 8, 768px), untimed: the int8 attention
    kernel at those three d64 sites in both modes, the conv kernel at every
    distinct quantized conv and the quantization kernel at every distinct
    linear input (the 1024-wide cross context and the linear proj_in /
    proj_out among them), each against its plain version at the tolerances
    of the SD v1 cases."""
    import torch

    from e4t_diffusion_torch.models.unet import UNetConfig

    fwd, bwd = [], []
    for heads, side in SD2_LEVELS:
        bh, sq = batch * heads, side * side
        for sk in (sq, 77):
            chunks = max(1, -(-bh * sq * sk * 4 // PLAIN_SCORE_BYTES))
            fwd.append(_fwd_case(bh, sq, sk, 64, gen, timed=True,
                                 plain_chunks=chunks))
            bwd.append(_bwd_case(bh, sq, sk, 64, gen, timed=True,
                                 plain_chunks=chunks))
            torch.cuda.empty_cache()
    n, ucfg = len(PROMPTS) * IMAGES_PER_PROMPT, UNetConfig.sd2()
    int8 = [_int8_flash_case(n * heads, side * side, side * side, 64, mode,
                             gen, timed=False)
            for mode in ("qk", "qkpv") for heads, side in SD2_LEVELS[:3]]
    int8 += [_conv_case(n, *key, gen, timed=False, sites=sites)
             for key, sites in sorted(
                 _unet_conv_shapes(n, SD2_RESOLUTION, ucfg).items())]
    int8 += [_quantize_case(shape, gen, timed=False, sites=sites)
             for shape, sites in sorted(
                 _unet_linear_shapes(n, SD2_RESOLUTION, ucfg).items())]
    return fwd, bwd, int8


def _sd2_step_shapes(ucfg, vit_cfg, batch, resolution):
    """{"BHxSqxSkxD": [forward launches, backward launches]} of one
    training step (tuning or pretraining) at ``batch``: every UNet site
    with at least FLASH_MIN_SEQ query tokens (the step is all-flash), the
    tap pass's down and mid blocks and the full pass's every block, each
    forward run twice under whole-call remat; the frozen ViT's forward.
    ``_expected_tuning_launches`` counts the same launches by kernel."""
    from e4t_diffusion_torch.models.weight_offsets import attention_sites
    from e4t_diffusion_torch.ops.attention import FLASH_MIN_SEQ

    side = resolution // 8
    levels = len(ucfg.block_out_channels)
    shapes = {}
    for path, dim, _ in attention_sites(ucfg):
        block, index = path.split(".")[:2]
        if block == "up_blocks":
            level, passes = levels - 1 - int(index), 1
        else:
            level = int(index) if block == "down_blocks" else levels - 1
            passes = 2
        sq = (side >> level) ** 2
        if sq < FLASH_MIN_SEQ:
            continue
        heads = ucfg.heads_for_block(level)
        sk = sq if path.endswith("attn1") else 77
        key = f"{batch * heads}x{sq}x{sk}x{dim // heads}"
        counts = shapes.setdefault(key, [0, 0])
        counts[0] += 2 * passes
        counts[1] += passes
    tokens = vit_cfg.grid ** 2 + 1
    if tokens >= FLASH_MIN_SEQ:
        key = (f"{batch * vit_cfg.num_heads}x{tokens}x{tokens}x"
               f"{vit_cfg.width // vit_cfg.num_heads}")
        shapes.setdefault(key, [0, 0])[0] += vit_cfg.num_layers
    return shapes


def _sd2_base(root):
    """(a) The seeded SD 2.1 diffusers directory (bf16 weights): UNet,
    VAE and the OpenCLIP-H text tower through ``_write_sd_model``, with a
    v-prediction schedule; no image encoder, no class embedding."""
    import torch

    from e4t_diffusion_torch.models.clip_text import (CLIPTextConfig,
                                                      CLIPTextModel)
    from e4t_diffusion_torch.models.unet import (UNet2DConditionModel,
                                                 UNetConfig)
    from e4t_diffusion_torch.models.vae import AutoencoderKL, VAEConfig

    torch.manual_seed(30)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(UNetConfig.sd2())
        vae = AutoencoderKL(VAEConfig(sample_size=SD2_RESOLUTION))
        text = CLIPTextModel(CLIPTextConfig.sd2())
    for m in (unet, vae, text):
        m.to(torch.bfloat16)
    path = _write_sd_model(os.path.join(root, "sd2"), unet, vae, text)
    n_params = sum(p.numel() for m in (unet, vae, text)
                   for p in m.parameters())
    del unet, vae, text
    torch.cuda.empty_cache()
    return path, n_params


@contextlib.contextmanager
def _trained_groups(module, name, frozen_of, trained_of, report, dtype):
    """While active, ``module.<name>`` (the training function a CLI's main
    calls: ``pretrain`` or ``tune``) records in ``report`` which of its
    frozen groups changed a bit and which trained groups did not change
    (``frozen_of`` / ``trained_of``: its positional arguments -> {group:
    tensors}; the frozen ones compared in the compute ``dtype``, as the
    trainer holds them; the trained ones after the run are the result's
    "trainable" groups, in the same order), and its result under
    "result"."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        frozen = frozen_of(args)
        before = {g: _checksums(t, dtype) for g, t in frozen.items()}
        trained = {g: _checksums(t) for g, t in trained_of(args).items()}
        result = real(*args, **kwargs)
        report["frozen_changed"] = sorted(
            g for g, t in frozen.items() if _checksums(t) != before[g])
        report["trained_unchanged"] = sorted(
            g for g in trained if _checksums(
                result["trainable"][g].values()) == trained[g])
        report["result"] = result
        return result

    setattr(module, name, wrapped)
    try:
        yield report
    finally:
        setattr(module, name, real)


def _sd2_train(module, name, argv, frozen_of, trained_of, what):
    """One in-process CLI run (``module.main(argv + --train_batch_size
    b)``) at the largest batch of SD2_TRAIN_BATCHES that fits, the launch
    counters set to 0 just before and read just after; the trained groups
    changed, the frozen ones bit for bit, loss and grad norm finite at
    every step (bf16). Returns the report."""
    import gc

    import torch

    for batch in SD2_TRAIN_BATCHES:
        report = {"batch": batch, "oom_at": [b for b in SD2_TRAIN_BATCHES
                                              if b > batch]}
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with _trained_groups(module, name, frozen_of, trained_of,
                                 report, torch.bfloat16):
                module.main(argv + ["--train_batch_size", str(batch)])
        except torch.cuda.OutOfMemoryError:
            report.pop("result", None)
            gc.collect()
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        report["wall_s"] = time.perf_counter() - t0
        report["launches"] = _read_launches()
        report["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
        result = report.pop("result")
        metrics = result["metrics"]
        if not all(math.isfinite(m[k]) for m in metrics
                   for k in ("loss", "loss_diff", "loss_reg", "grad_norm")):
            fail(f"sd2_e4t {what}: non-finite metrics {metrics}")
        if report["frozen_changed"] or report["trained_unchanged"]:
            fail(f"sd2_e4t {what}: frozen groups changed "
                 f"{report['frozen_changed']} or trained groups unchanged "
                 f"{report['trained_unchanged']}")
        report["metrics"] = metrics
        report["trainable_shapes"] = [tuple(t.shape) for g in result[
            "trainable"].values() for t in g.values()]
        report["step_seconds"] = result["step_seconds"]
        warm = result["step_seconds"][1:] or result["step_seconds"]
        report["warm_s_per_step"] = sum(warm) / len(warm)
        report["samples_per_s"] = batch / report["warm_s_per_step"]
        del result
        gc.collect()
        torch.cuda.empty_cache()
        return report
    fail(f"sd2_e4t {what}: no batch of {SD2_TRAIN_BATCHES} fits")


def _sd2_sampling(pipe, image, report):
    """(d) The tuned artifact's pipeline: DDIM-4 twice (the rerun bit for
    bit) and DPM++ 2M-4 at 768px, 2 prompts x 4 images, CFG 7.5, each run's
    launches against ``_expected_sampling_launches``; one UNet pass on
    flash against einsum; static int8 (calibrated on SD2_CALIB_STEPS
    steps), and dynamic int8 with the int8 attention kernel and both
    opt-in routes on, against bf16, final latents, with their launches
    derived from the SD2 UNet's int8, attention and GroupNorm sites."""
    import numpy as np
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import (
        StableDiffusionE4TPipeline)
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.ops.attention import flash_threshold

    mods = pipe.modules
    dev = mods.unet.conv_in.weight.device
    ucfg, vit = mods.unet.config, mods.e4t_encoder.config.vit
    n = len(PROMPTS) * IMAGES_PER_PROMPT
    per_run = _expected_sampling_launches(ucfg, vit, n, SD2_RESOLUTION,
                                          STEPS)
    # 5 self-attention sites at each of 96², 48² and 24² a pass, two passes
    # a step; cross-attention, the mid block and the ViT-H stay on einsum
    if per_run != _want(flash_fwd_lowdim=30 * STEPS):
        fail(f"sd2_e4t: sampling launch derivation {per_run}")
    kwargs = dict(num_inference_steps=STEPS, guidance_scale=7.5,
                  num_images_per_prompt=IMAGES_PER_PROMPT, seed=0)
    runs, images = {}, {}
    for name, scheduler in (("ddim_first", "ddim"), ("ddim_warm", "ddim"),
                            ("dpm", "dpm_solver++")):
        if name == "ddim_warm":
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(PROMPTS, image, scheduler_type=scheduler, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        if out.shape != (n, 3, SD2_RESOLUTION, SD2_RESOLUTION) or not (
                np.isfinite(out).all() and 0.0 <= out.min()
                and out.max() <= 1.0):
            fail(f"sd2_e4t {name}: images {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
        if launches != per_run:
            fail(f"sd2_e4t {name}: launches {launches}, expected {per_run}")
        runs[name] = {"s": seconds, "images_per_s": n / seconds,
                      "launches": launches}
        images[name] = out
    runs["ddim_warm"]["max_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    report["runs"] = runs
    report["launches_per_step"] = {k: v // STEPS for k, v in per_run.items()
                                   if v}
    report["rerun_bit_equal"] = bool(np.array_equal(images["ddim_first"],
                                                    images["ddim_warm"]))
    if not report["rerun_bit_equal"]:
        fail(f"sd2_e4t: two same-seed DDIM runs differ by "
             f"{float(np.abs(images['ddim_first'] - images['ddim_warm']).max())}")
    gen = torch.Generator(dev).manual_seed(31)
    side = SD2_RESOLUTION // 8
    x = torch.randn(n, 4, side, side, device=dev, generator=gen)
    ctx = torch.randn(n, 77, ucfg.cross_attention_dim, device=dev,
                      generator=gen)
    t = torch.full((n,), 500, device=dev)
    with torch.inference_mode():
        eps = mods.unet(x, t, ctx).float()
        with flash_threshold(1 << 62):
            eps_plain = mods.unet(x, t, ctx).float()
    report["unet_kernel_vs_einsum_rel_l2"] = _rel(eps, eps_plain)
    del eps, eps_plain, x, ctx
    if not report["unet_kernel_vs_einsum_rel_l2"] <= UNET_ROUTE_REL_L2:
        fail(f"sd2_e4t: UNet eps, kernel vs einsum: {report}")

    conv_sites = sum(_unet_conv_shapes(n, SD2_RESOLUTION, ucfg).values())
    linear_sites = sum(_unet_linear_shapes(n, SD2_RESOLUTION,
                                           ucfg).values())
    int8 = StableDiffusionE4TPipeline(
        mods, pipe.offsets, pipe.tokenizer, pipe.e4t_config,
        scheduler=pipe.scheduler, already_added_placeholder_token=True,
        int8="static")
    want8 = _want(flash_fwd_lowdim=30 * (SD2_CALIB_STEPS + STEPS),
                  int8_conv=2 * conv_sites * STEPS,
                  int8_quantize=2 * linear_sites * STEPS)
    lat_kwargs = dict(kwargs, output_type="latent")
    saved = os.environ.get("E4T_INT8_CALIB_STEPS")
    os.environ["E4T_INT8_CALIB_STEPS"] = str(SD2_CALIB_STEPS)
    try:
        _reset_launches()
        t0 = time.perf_counter()
        lat8 = torch.from_numpy(int8(PROMPTS, image, **lat_kwargs))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        if saved is None:
            os.environ.pop("E4T_INT8_CALIB_STEPS", None)
        else:
            os.environ["E4T_INT8_CALIB_STEPS"] = saved
    lat = torch.from_numpy(pipe(PROMPTS, image, **lat_kwargs))
    report["int8_static"] = {
        "s_with_calibration": seconds, "launches": launches,
        "conv_sites_per_unet_pass": conv_sites,
        "linear_sites_per_unet_pass": linear_sites,
        "calibrated_sites": len(int8.act_amax),
        "linear_projection_sites": sum(
            k.endswith(("proj_in", "proj_out")) for k in int8.act_amax),
        "final_latents_vs_bf16_rel_l2": _rel(lat8, lat)}
    if launches != want8:
        fail(f"sd2_e4t int8: launches {launches}, expected {want8}")
    if not (torch.isfinite(lat8).all() and report["int8_static"][
            "final_latents_vs_bf16_rel_l2"] <= INT8_VS_BF16_REL_L2):
        fail(f"sd2_e4t int8 against bf16: {report['int8_static']}")
    # the opt-in routes on this base: dynamic int8 with the int8 attention
    # kernel ("qkpv") at the d64 flash sites, E4T_FUSED_GN=1, and
    # E4T_SHORTSEQ_MH_ATTN=8 (the mid block's 144 tokens and the ViT-H on
    # the short-sequence kernel); final latents against bf16
    routed = StableDiffusionE4TPipeline(
        mods, pipe.offsets, pipe.tokenizer, pipe.e4t_config,
        scheduler=pipe.scheduler, already_added_placeholder_token=True,
        int8=True, int8_attn="qkpv")
    attn = _expected_unclip_launches(ucfg, n, SD2_RESOLUTION, 2 * STEPS,
                                     routes=True)
    if attn != _want(flash_fwd_lowdim=30 * STEPS,
                     flash_fwd_shortseq=2 * STEPS):
        fail(f"sd2_e4t: routed sampling launch derivation {attn}")
    gn_sites = sum(_group_norm_sites(
        ucfg, VAEConfig(sample_size=SD2_RESOLUTION), 1, SD2_RESOLUTION,
        parts=("unet",))["unet"].values())
    want_routed = _want(
        flash_fwd_int8=attn["flash_fwd_lowdim"],
        flash_fwd_shortseq=attn["flash_fwd_shortseq"]
        + _vit_shortseq_sites(vit, n),
        group_norm=2 * STEPS * gn_sites, int8_conv=2 * conv_sites * STEPS,
        int8_quantize=2 * linear_sites * STEPS)
    with _routes_on():
        _reset_launches()
        t0 = time.perf_counter()
        lat_routed = torch.from_numpy(routed(PROMPTS, image, **lat_kwargs))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
    report["int8_attn_qkpv_routes_on"] = {
        "knobs": ROUTE_KNOBS, "s": seconds, "launches": launches,
        "group_norm_sites_per_unet_pass": gn_sites,
        "final_latents_vs_bf16_rel_l2": _rel(lat_routed, lat)}
    if launches != want_routed:
        fail(f"sd2_e4t int8 attention, routes on: launches {launches}, "
             f"expected {want_routed}")
    if not (torch.isfinite(lat_routed).all()
            and report["int8_attn_qkpv_routes_on"][
                "final_latents_vs_bf16_rel_l2"] <= INT8_VS_BF16_REL_L2):
        fail(f"sd2_e4t int8 attention, routes on, against bf16: "
             f"{report['int8_attn_qkpv_routes_on']}")
    del int8, routed, lat8, lat, lat_routed
    report["profile_ddim"] = _profile(lambda: pipe(PROMPTS, image,
                                                   **kwargs))
    return runs


def phase_sd2_e4t(smi, data_dir):
    """E4T on a full-width SD 2.1 base (seeded random weights) through the
    port's CLIs, in process: (a) the diffusers directory; (b)
    ``pretrain_e4t`` on the pretraining phase's images, SD2_PRETRAIN_STEPS
    bf16 steps at 768px, a checkpoint and the artifact; (c) ``tuning_e4t``
    from that artifact, SD2_TUNING_STEPS bf16 steps; (d) sampling from the
    tuned artifact (``inference.build_pipeline``). Both training runs take
    the batch 16 the CLIs default to, or the largest of SD2_TRAIN_BATCHES
    that fits, and their resolution from the UNet's sample_size; every
    launch count is derived from the port's own routes. Returns (the
    launches of (b), (c) and a (d) run by path, the tuning step's flash
    launches by shape)."""
    import gc

    import numpy as np
    import torch
    from PIL import Image

    from e4t_diffusion_torch import inference, pretrain_e4t, tuning_e4t
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
    from e4t_diffusion_torch.utils import artifacts

    ucfg, vit = UNetConfig.sd2(), E4TEncoderConfig().vit
    if not (tap_feature_dim(ucfg) == 10880
            and CLIPTextConfig.sd2().hidden_size == 1024):
        fail("sd2_e4t: the SD 2.1 configs are not SD 2.1's")
    report = {"phase": "sd2_e4t", "card": smi,
              "resolution": SD2_RESOLUTION}
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sd, report["base_params"] = _sd2_base(root)
        report["write_base_s"] = time.perf_counter() - t0

        def head(e4t):
            return [p for n, p in e4t.named_parameters()
                    if not n.startswith("clip_vision.")]

        pre_out = os.path.join(root, "pre")
        pre = _sd2_train(
            pretrain_e4t, "pretrain", [
                "--pretrained_model_name_or_path", sd,
                "--train_image_dataset", data_dir,
                "--domain_class_token", "face", "--prompt_template",
                "normal", "--max_train_steps", str(SD2_PRETRAIN_STEPS),
                "--checkpointing_steps", str(SD2_PRETRAIN_STEPS),
                "--n_save_sample", "0", "--mixed_precision", "bf16",
                "--report_to", "tensorboard", "--output_dir", pre_out,
                "--seed", "0"],
            lambda a: {"unet": list(a[1].unet.parameters()),
                       "vae": list(a[1].vae.parameters()),
                       "text": list(a[1].text_encoder.parameters()),
                       "vit": list(a[1].e4t_encoder.clip_vision
                                   .parameters())},
            lambda a: {"offsets": list(a[2].values()),
                       "e4t": head(a[1].e4t_encoder)}, "pretraining")
        art = os.path.join(pre_out, str(SD2_PRETRAIN_STEPS))
        ckpt = os.path.join(pre_out, f"checkpoint-{SD2_PRETRAIN_STEPS}",
                            artifacts.TRAIN_STATE_FILE)
        if not (os.path.exists(ckpt) and sorted(os.listdir(art)) == [
                "config.json", "encoder.pt", "weight_offsets.pt"]):
            fail(f"sd2_e4t pretraining: no checkpoint or artifact in "
                 f"{os.listdir(pre_out)}")
        per_step = _expected_tuning_launches(ucfg, vit, SD2_RESOLUTION)
        want = {k: SD2_PRETRAIN_STEPS * v for k, v in per_step.items()}
        if pre["launches"] != want:
            fail(f"sd2_e4t pretraining: launches {pre['launches']}, "
                 f"expected {want}")
        del pre["trainable_shapes"]
        pre["launches_per_step"] = per_step
        pre["flash_by_shape_per_step"] = _sd2_step_shapes(
            ucfg, vit, pre["batch"], SD2_RESOLUTION)
        report["pretraining"] = pre
        paths["sd2_pretraining"] = pre["launches"]

        image = os.path.join(root, "subject.png")
        Image.fromarray(np.random.default_rng(32).integers(
            0, 256, (SD2_RESOLUTION, SD2_RESOLUTION, 3),
            dtype=np.uint8)).save(image)
        tune_out = os.path.join(root, "tune")
        tune = _sd2_train(
            tuning_e4t, "tune", [
                "--pretrained_model_name_or_path", art,
                "--train_image_path", image,
                "--max_train_steps", str(SD2_TUNING_STEPS),
                "--mixed_precision", "bf16", "--output_dir", tune_out,
                "--seed", "0"],
            lambda a: {"vae": list(a[1].vae.parameters()),
                       "vit": list(a[1].e4t_encoder.clip_vision
                                   .parameters())},
            lambda a: {"unet": list(a[1].unet.parameters()),
                       "offsets": list(a[2].values()),
                       "e4t": head(a[1].e4t_encoder)}, "tuning")
        want = {k: SD2_TUNING_STEPS * v for k, v in per_step.items()}
        if tune["launches"] != want:
            fail(f"sd2_e4t tuning: launches {tune['launches']}, expected "
                 f"{want}")
        tune["launches_per_step"] = per_step
        tune["flash_by_shape_per_step"] = _sd2_step_shapes(
            ucfg, vit, tune["batch"], SD2_RESOLUTION)
        # the 8-bit AdamW kernel at every distinct shape this step trains
        # (the whole SD 2.1 UNet, the offsets at its sites, the 1024-wide
        # encoder) against its plain version, bit for bit
        tune["adam8bit_at_sd2_tuning_shapes"] = _adam8bit_checks(
            sorted(set(tune.pop("trainable_shapes"))), timed=False)
        report["tuning"] = tune
        paths["sd2_tuning"] = tune["launches"]
        tuned = os.path.join(tune_out, str(SD2_TUNING_STEPS))
        if not os.path.exists(os.path.join(tuned, "unet.pt")):
            fail(f"sd2_e4t tuning: no artifact in {tune_out}")

        t0 = time.perf_counter()
        pipe = inference.build_pipeline(inference.parse_args([
            "--pretrained_model_name_or_path", tuned,
            "--image_path_or_url", image]))
        report["load_tuned_s"] = time.perf_counter() - t0
        subject = np.asarray(Image.open(image))
        sampling = {}
        runs = _sd2_sampling(pipe, subject, sampling)
        report["sampling"] = sampling
        paths["sd2_sampling"] = runs["ddim_warm"]["launches"]
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return paths, tune["flash_by_shape_per_step"]


def kernels_line(cases, paths, unclip_call, adam8bit, sd2_step=None):
    """The kernels record: one row per kernel, its launches on each path
    (``paths``: launch counts by path) and its times at the main path's
    heaviest site, with every timed site beside it; ``unclip_call``: the
    unclip phase's flash launches by shape and their profiled time;
    ``adam8bit``: the training extras' check of the 8-bit AdamW kernel;
    ``sd2_step``: the SD 2.1 tuning step's flash launches by shape
    (``_sd2_step_shapes``)."""
    fwd_cases = (cases["sampling"] + cases["unclip_flash"]
                 + cases["sd2_fwd"] + cases["tuning_fwd"] + [cases["grid"]]
                 + [c for c in cases["ragged"]
                    if c["kernel"] != "flash_bwd"])
    bwd_cases = cases["tuning_bwd"] + cases["sd2_bwd"] + [
        cases["grid_bwd"]] + [
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
        c for c in cases["ragged"] + cases["sd2_int8"]
        if c["kernel"] == "flash_fwd_int8"]
    convs = cases["int8_conv"] + [
        c for c in cases["ragged"] + cases["sd2_int8"]
        if c["kernel"] == "int8_conv"]
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
    # the unCLIP UNet's three d64 sites as the kernels phase timed them, and
    # one warm call of the unclip phase: its launches at each shape and the
    # kernel's device time over the profiled call (None: not measured);
    # the bound is that of the launches counted
    kernels[0]["unclip_sites"] = [
        {k: c[k] for k in timed_keys + ("parent_ms",)}
        for c in cases["unclip_flash"]]
    # the SD 2.1 training step's d64 sites at batch 16, 768px (E4T on an
    # SD2 base; its sampling sites are the unCLIP UNet's), and the step's
    # sum: each shape's time and bound times its launches a step
    for index, key in ((0, "sd2_fwd"), (2, "sd2_bwd")):
        kernels[index]["sd2_training_sites"] = [
            {k: c[k] for k in timed_keys + ("parent_ms", "plain_chunks")
             if k in c} for c in cases[key]]
    if sd2_step is not None:
        for index, key, which in ((0, "sd2_fwd", 0), (2, "sd2_bwd", 1)):
            timed = {f"{c['bh']}x{c['sq']}x{c['sk']}x{c['d']}": c
                     for c in cases[key]}
            counted = {shape: n[which] for shape, n in sd2_step.items()
                       if shape in timed}
            kernels[index]["per_sd2_training_step"] = {
                "launches_by_shape": counted,
                **{t: sum(n * timed[shape][t]
                          for shape, n in counted.items())
                   for t in ("ms", "bound_ms", "library_ms",
                             "parent_ms")}}
    shapes = unclip_call["launches_by_shape"]
    kernels[0]["per_unclip_call"] = {
        "launches_by_shape": shapes,
        "profiled_ms": unclip_call["profiled_ms"],
        "bound_ms": sum(
            shapes.get(f"{c['bh']}x{c['sq']}x{c['sk']}x{c['d']}", 0)
            * c["bound_ms"] for c in cases["unclip_flash"])}
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
    vae = cases["int8_conv_vae"]
    kernels[-1]["max_abs_err"] = max(
        [kernels[-1]["max_abs_err"]]
        + [max(c["out_max_abs"], c["f32_out_max_abs"]) for c in vae])
    kernels[-1]["per_vae_decode"] = {
        key: sum(c["sites_per_decode"] * c[key] for c in vae)
        for key in ("ms", "dynamic_ms", "plain_ms", "library_ms",
                    "bound_ms")}
    kernels[-1]["vae_routes"] = (
        "quant.int8_conv2d from bf16 NCHW x: ms on a static scale, "
        "dynamic_ms with the live abs-max; n_tile_fill: the share of the "
        "160-channel tiles that O fills")
    kernels[-1]["vae_per_site"] = [
        {k: c[k] for k in ("c", "o", "h", "w", "k", "stride", "pad",
                           "sites_per_decode", "n_tile_fill", "ms",
                           "dynamic_ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")} for c in vae]
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
            c for c in cases["ragged"] + cases["sd2_int8"]
            if c["kernel"] == "int8_quantize"]),
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
    aux_q = cases["int8_quantize_aux"]
    conv1 = cases["vit_conv1"]
    kernels[-1]["max_abs_err"] = max(
        [kernels[-1]["max_abs_err"], conv1["out_max_abs"]]
        + [c["out_max_abs"] for c in aux_q])
    kernels[-1]["per_aux_run"] = {
        key: sum(c["sites_per_aux_run"] * c[key] for c in aux_q)
        for key in ("ms", "plain_ms", "bound_ms")}
    kernels[-1]["aux_per_site"] = [
        {**{k: c[k] for k in q_keys if k != "sites_per_unet_pass"},
         "sites_per_aux_run": c["sites_per_aux_run"]} for c in aux_q]
    kernels[-1]["vit_conv1_route"] = {
        k: conv1[k] for k in ("n", "c", "o", "h", "w", "k", "stride",
                              "route_checks", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library")}
    kernels[-1]["vit_conv1_route"]["route"] = (
        "quant.int8_patch_conv: this kernel on NHWC x, then torch._int_mm "
        "over the patch matrix (K 588 padded to 592), static scale")

    gn = cases["group_norm"]
    gn_parts = ("unet", "vae_decode", "vae_encode", "unclip_unet",
                "vae_decode_768")
    gn_all = [c for part in gn_parts for c in gn[part]] + [
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
        "per_vae_encode_batch_16": per_run("vae_encode"),
        "per_unclip_unet_pass_batch_8": per_run("unclip_unet"),
        "per_vae_decode_768_batch_4": per_run("vae_decode_768"),
        "per_site": {part: [{k: c[k] for k in gn_keys} for c in gn[part]]
                     for part in gn_parts}})
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
    kernels.append({
        "name": "adam8bit", "route": "cuda",
        "source": "e4t_diffusion_torch/csrc/adam8bit.cu",
        "replaces": "e4t_diffusion_tpu/training/optim8bit.py:109",
        "replaces_note": "XLA code in the JAX package (adam_core :109-117 "
                         "with _q_blocks :43 and _dq_blocks :60), no "
                         "Pallas kernel",
        "launches": sum(p["adam8bit"] for p in paths.values()),
        "launches_by_path": {k: p["adam8bit"] for k, p in paths.items()},
        "max_abs_err": adam8bit["max_abs_err"], "ms": adam8bit["ms"],
        "plain_ms": adam8bit["plain_ms"], "bound_ms": adam8bit["bound_ms"],
        "bound_by": adam8bit["bound_by"], "library_ms": None,
        "adamw_f32_ms": adam8bit["adamw_f32_ms"],
        "at": f"all {adam8bit['tensors']} trainable tensors of a tuning "
              f"step, {adam8bit['elements']} f32 elements, one launch an "
              f"update",
        "times": "ms: CUDA events around the launch on a built pointer "
                 "table, median of 10; profiled_ms: its device time under "
                 "torch.profiler; wall_ms: CUDA events around the wrapper "
                 "(the table built on the host included); adamw_f32_ms: "
                 "torch's f32 AdamW on the same tensors, a yardstick (not "
                 "the same function)",
        "check": {k: adam8bit[k] for k in (
            "updates_compared", "bit_equal", "params_differing",
            "scales_differing", "codes_off_by_one", "codes_off_by_more",
            "profiled_ms", "profiled_by", "wall_ms", "state_bytes")}})
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
    from e4t_diffusion_torch import seeded

    timings = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        timings[name] = time.perf_counter() - t0
        print(json.dumps({"phase_done": name, "wall_s": timings[name]}),
              flush=True)
        return out

    # the default paths: the routes off, the loader's native transform on
    for knob in (*ROUTE_KNOBS, "E4T_DISABLE_NATIVE"):
        os.environ.pop(knob, None)
    smi = run("environment", phase_environment)
    run("build", phase_build)
    if sys.argv[1:] == ["--parallel"]:
        # the parallel phase alone
        with tempfile.TemporaryDirectory() as data_dir:
            seeded.write_pretraining_images(data_dir, PRETRAIN_IMAGES)
            run("parallel", phase_parallel, smi, data_dir)
        return
    if sys.argv[1:] == ["--sd2"]:
        # the SD 2.1 kernel cases and the sd2_e4t phase alone
        cases = {}
        gen = torch.Generator("cuda").manual_seed(0)
        cases["sd2_fwd"], cases["sd2_bwd"], cases["sd2_int8"] = run(
            "sd2_kernels", _sd2_kernel_cases, gen)
        print(json.dumps({"phase": "sd2_kernels", **cases}))
        with tempfile.TemporaryDirectory() as data_dir:
            seeded.write_pretraining_images(data_dir, PRETRAIN_IMAGES)
            run("sd2_e4t", phase_sd2_e4t, smi, data_dir)
        print(json.dumps({"phase_seconds": timings}))
        return
    if sys.argv[1:] == ["--multi-card"]:
        # (d) of the parallel phase alone, on a machine of two or more cards
        if torch.cuda.device_count() < 2:
            fail("--multi-card needs two cards")
        print(json.dumps({"multi_card": run("multi_card",
                                            _multi_card_checks)}))
        return
    cases = run("kernels", phase_kernels)
    sampling, pipe, image, warm_s = run("sampling", phase_main_path, smi)
    components = run("components", phase_components, smi, pipe)
    vit_ablations = run("vit_ablations", phase_vit_ablations, smi, pipe)
    schedulers = run("schedulers", phase_schedulers, smi, pipe, image)
    int8_sampling = run("int8_sampling", phase_int8_sampling, smi, pipe,
                        image)
    served = tempfile.TemporaryDirectory()
    serving = run("serving", phase_serving, smi, pipe, served.name)
    # the real-weights chain's three processes run beside the next phases
    validation = _start_validation(served.name)
    routes_sampling = run("routes_sampling", phase_routes_sampling, smi,
                          pipe, image, warm_s)
    f32_sampling = run("f32_sampling", phase_f32_sampling, smi, pipe, image)
    del pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        unclip, unclip_files = run("unclip", phase_unclip, smi, root)
        clip_score = run("clip_score", phase_clip_score, smi, root,
                         unclip_files)
    torch.cuda.empty_cache()
    run("validate_real_weights", phase_validate_real_weights, smi,
        *validation)
    served.cleanup()
    tuning, tuning_ref = run("tuning", phase_tuning, smi)
    torch.cuda.empty_cache()
    routes_tuning, _ = run("routes_tuning", phase_tuning, smi, 2, True,
                           tuning_ref["first_step"])
    torch.cuda.empty_cache()
    run("tiny_card_vs_cpu", phase_tiny_vs_cpu)
    f32_tuning_tiny = run("f32_tuning_vs_cpu", phase_f32_tuning_vs_cpu)
    f32_tuning = run("f32_tuning", phase_f32_tuning, smi)
    torch.cuda.empty_cache()
    pretraining, pretraining_ref, data = run("pretraining",
                                             phase_pretraining, smi)
    torch.cuda.empty_cache()
    routes_pretraining = run("routes_pretraining", phase_routes_pretraining,
                             smi, pretraining_ref["first_step"], data)
    f32_pretraining = run("f32_pretraining", phase_f32_pretraining, smi,
                          data)
    torch.cuda.empty_cache()
    extras, adam8bit = run("training_extras", phase_training_extras, smi,
                           tuning_ref, pretraining_ref, data)
    torch.cuda.empty_cache()
    sd2, sd2_step = run("sd2_e4t", phase_sd2_e4t, smi, data.name)
    torch.cuda.empty_cache()
    parallel = run("parallel", phase_parallel, smi, data.name)
    data.cleanup()
    paths = {"sampling": sampling, "components": components,
             "vit_ablations": vit_ablations, "schedulers": schedulers,
             "int8_sampling": int8_sampling, "serving": serving,
             "routes_sampling": routes_sampling,
             "f32_sampling": f32_sampling, "unclip": unclip,
             "clip_score": clip_score, "tuning": tuning,
             "routes_tuning": routes_tuning,
             "f32_tuning_vs_cpu": f32_tuning_tiny, "f32_tuning": f32_tuning,
             "pretraining": pretraining,
             "routes_pretraining": routes_pretraining,
             "f32_pretraining": f32_pretraining,
             "training_extras": extras, **sd2, "parallel": parallel}

    kernels = kernels_line(cases, paths,
                           unclip_files["flash_per_call"], adam8bit,
                           sd2_step)
    print(json.dumps({"phase_seconds": timings,
                      "profiler_empty": PROFILER_EMPTY,
                      "trace_device_kernels": TRACE_DEVICE_KERNELS}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
