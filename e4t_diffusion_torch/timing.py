"""Timing and site-discovery helpers of the port's measurement scripts.

``chip_smoke.py`` and the timing scripts of this package
(``time_int8_conv.py``, ``time_group_norm.py``, ``time_attn_small.py``)
share them: the card's ``nvidia-smi`` line, CUDA-event and profiler
device times (``device_time``: kineto's raw device records, with a
fallback to CUDA events where a session comes back empty), the work's
bound on the H100's peaks, and the quantized conv and linear sites and
the GroupNorm sites of a UNet pass, read off forwards on the meta device.
Importing this module touches no device and imports neither torch nor
anything of the package; each function imports what it needs when called,
so a timing script can load this file by path beside another checkout's
package, one older than this file included.
"""
from __future__ import annotations

import subprocess
import time

# the main path's sampling run: two prompts x 4 images at 512px
PROMPTS = ["a photo of *s", "a *s face in monet style"]
IMAGES_PER_PROMPT = 4
RESOLUTION = 512

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; the dense bf16 and
# int8 tensor-core rates and f32 on the CUDA cores (FFMA), utils/flops.py's
# (held equal to them by a test; written out here, so that loading this
# file imports nothing of the package); exp2 on the special-function units:
# 16 per clock per SM (CUDA C++ Programming Guide throughput table, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost clock.
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
EXP_PER_S = 16 * 132 * 1.98e9

# f32 attention kernels against their plain versions in f32 on the same
# f32 inputs (out, lse, dq, dk, dv, rel-L2): full f32 FFMA on both sides,
# the sums taken in another order
KERNEL_F32_REL_L2 = 1e-5
# GroupNorm kernel against its f32 plain version: bf16 output rounding
# (rel-L2 ~2e-3)
GN_BF16_REL_L2 = 1e-2


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {out.stderr.strip()}")
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


def note_empty(prof):
    PROFILER_EMPTY["sessions"] += 1
    if not len(prof.events()):
        PROFILER_EMPTY["sessions_without_host_events"] += 1


# set once device_events has been held against key_averages in a run
_DEVICE_EVENTS_HELD = []


def device_events(prof):
    """{kernel name: [device us, count]} of a profiler session: its device
    records that are not user annotations, read off kineto's raw events as
    ``key_averages`` reads them (names demangled, an asynchronous record
    counted with no time). ``key_averages`` gives the same self device
    times but first builds the host ops' event tree in Python, which took
    most of chip_smoke.py's profiling time (seconds to tens of seconds a
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
            raise RuntimeError(f"profiler: kineto's device records disagree with "
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
    (seen on the H100 machine, up to three sessions in a row): such a
    session is measured again, and after three empty
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
        us = sum(us for us, _ in device_events(prof).values())
        if us > 0:
            return us / reps / 1e3, "device"
        note_empty(prof)
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


def bound(n_bytes, flops, exps, int8_ops=0, flop_rate=BF16_FLOP_PER_S):
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


def rel(a, b):
    return ((a.float() - b).norm() / b.norm()).item()


def unet_conv_shapes(batch, resolution, unet_config=None):
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


def unet_linear_shapes(batch, resolution, unet_config=None):
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


def group_norm_sites(unet_config, vae_config, batch, resolution,
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
