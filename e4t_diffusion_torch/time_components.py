#!/usr/bin/env python3
"""Per-component times of the sampling path on one NVIDIA GPU, with MFU.

    python3 e4t_diffusion_torch/time_components.py [--sd2]

The counterpart of the JAX package's ``scripts/bench_components.py``.
Prints the card's ``nvidia-smi`` line, then one JSON line of per-call
milliseconds, each the median over ``E4T_BENCH_ITERS`` calls on distinct
inputs timed by CUDA events (after one warm call), for: the full UNet
forward (``unet_fwd``), the forward with the E4T tap
(``return_encoder_outputs="with_eps"``: ``unet_fwd_with_tap``), the text
encoder on input embeddings, the ViT-H encode (``encode_image``), the E4T
fuse head, the VAE decode and the offset fold. The UNet comes in bf16, in
int8 on dynamic and on calibrated static activation scales, and with the
int8 attention kernel (``E4T_BENCH_ATTN_MODE``, "qk" by default) over bf16
and over static int8; the ViT-H and the VAE decode in bf16 and on their
int8 towers, dynamic and static (``--int8_aux``'s sites). A static row
calibrates its scales on one bf16 call first.

Beside each row that ``utils/flops.py`` counts, ``<row>_mfu``: the count
over the time over the bf16 peak (989 TFLOP/s; an int8 row is held to the
same peak, so above 1 it would beat the bf16 roofline), and for the int8
rows ``<row>_int8_peak_share`` against the int8 peak (1,979 TOP/s). The
UNet rows count ``unet_forward`` (the tap adds no product), the towers
``vit_forward`` and ``vae_decode``, the text encoder
``text_encoder_forward``; as in the JAX script, the int8-attention rows,
the fuse head and the fold are not counted.

Knobs: ``E4T_BENCH_BATCH`` (8), ``E4T_BENCH_RES`` (512; 768 with
``--sd2``), ``E4T_BENCH_ITERS`` (10), ``E4T_BENCH_ONLY`` (a comma list of
row names, default all), ``E4T_BENCH_ATTN_MODE``; and the port's per-call
knobs (``E4T_FLASH_THRESHOLD_BYTES``, ``E4T_FUSED_GN``,
``E4T_SHORTSEQ_MH_ATTN`` ...). ``--sd2``: SD 2.1 (``UNetConfig.sd2``, the
OpenCLIP-H text tower, 1024-wide E4T words). Seeded random bf16 weights;
TF32 off. Needs a GPU; imports no JAX. ``time_components(modules,
offsets, ...)`` is what ``chip_smoke.py`` calls on its pipeline's modules.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = ("unet_fwd", "unet_fwd_int8", "unet_fwd_int8_static",
        "unet_fwd_int8_attn", "unet_fwd_int8_static_attn",
        "unet_fwd_with_tap", "text_encoder", "vit_encode",
        "vit_encode_int8", "vit_encode_int8_static", "e4t_fuse",
        "vae_decode", "vae_decode_int8", "vae_decode_int8_static",
        "fold_offsets")
INT8_ROWS = tuple(r for r in ROWS if "int8" in r)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def events_ms(fn: Callable[[int], object], n: int) -> float:
    """Median over ``n`` calls ``fn(i)`` (i = 0..n-1, distinct inputs) of
    one call's CUDA-event time, after one warm call ``fn(0)``."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def row_flops(modules, batch: int, resolution: int) -> Dict[str, int]:
    """{row: FLOPs of one call} for the rows ``utils/flops.py`` counts."""
    from e4t_diffusion_torch.utils import flops as fl

    unet = batch * fl.unet_forward(modules.unet.config, resolution // 8)
    vit = fl.vit_forward(modules.e4t_encoder.config.vit, batch)
    vae = batch * fl.vae_decode(modules.vae.config, resolution // 8)
    out = {r: unet for r in ("unet_fwd", "unet_fwd_int8",
                             "unet_fwd_int8_static", "unet_fwd_with_tap")}
    out.update({r: vit for r in ROWS if r.startswith("vit_encode")})
    out.update({r: vae for r in ROWS if r.startswith("vae_decode")})
    out["text_encoder"] = fl.text_encoder_forward(
        modules.text_encoder.config, batch)
    return out


def add_mfu(results: Dict, flops_of: Dict[str, int]) -> None:
    """``<row>_mfu`` against the bf16 peak beside every counted row, and
    ``<row>_int8_peak_share`` against the int8 peak for the int8 rows."""
    from e4t_diffusion_torch.utils import flops as fl

    for row, f in flops_of.items():
        ms = results.get(f"{row}_ms")
        if ms is None:
            continue
        rate = f / (ms * 1e-3)
        results[f"{row}_mfu"] = rate / fl.H100_BF16_PEAK
        if row in INT8_ROWS:
            results[f"{row}_int8_peak_share"] = rate / fl.H100_INT8_PEAK


def time_components(modules, offsets, batch: int = 8, resolution: int = 512,
                    iters: int = 10, rows: Optional[Sequence[str]] = None,
                    attn_mode: str = "qk", seed: int = 0) -> Dict:
    """Times ``rows`` (default all of ``ROWS``) of ``modules`` (an
    ``E4TModules`` on the card; its dtype is the rows' bf16) and the offset
    bank ``offsets``. Returns {"<row>_ms": ms, ..., "<row>_mfu": ...,
    "est_cfg_step_ms" (when its four rows ran), "batch", "resolution",
    "calls": {row: timed and warm calls}, "calib_calls": {row: the bf16
    calibration calls a static row made first}}."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import (
        _aux_sites, _unet_sites, make_aux_calibration_fn)
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.ops import quant
    from e4t_diffusion_torch.ops.attention import int8_flash_attention

    rows = list(ROWS if rows is None else rows)
    unknown = sorted(set(rows) - set(ROWS))
    if unknown:
        raise ValueError(f"no component row {unknown}: one of {ROWS}")
    unet, vae = modules.unet, modules.vae
    text, e4t = modules.text_encoder, modules.e4t_encoder
    dtype = unet.conv_in.weight.dtype
    dev = unet.conv_in.weight.device
    gen = torch.Generator(dev).manual_seed(seed)
    lat = resolution // 8
    n_ctx = text.config.max_position_embeddings

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    lats = [randn(batch, 4, lat, lat) for _ in range(iters)]
    ctxs = [randn(batch, n_ctx, unet.config.cross_attention_dim)
            for _ in range(iters)]
    t = torch.zeros(batch, dtype=torch.long, device=dev)
    results: Dict = {}
    calls: Dict[str, int] = {}
    calib: Dict[str, int] = {}
    aux_amax = {}

    def unet_amax():
        with quant.calibration(unet) as amax:
            unet(lats[0], t, ctxs[0])
        return amax

    def time_row(name, fn, contexts=()):
        with contextlib.ExitStack() as stack:
            for ctx in contexts:
                stack.enter_context(ctx)
            results[f"{name}_ms"] = events_ms(fn, iters)
        calls[name] = iters + 1

    def unet_row(name, sites=None, attn=False, **kwargs):
        contexts = [] if sites is None else [quant.int8_sites(unet, sites)]
        if attn:
            contexts.append(int8_flash_attention(attn_mode))
        time_row(name, lambda i: unet(lats[i], t, ctxs[i], **kwargs),
                 contexts)

    pixels = [torch.rand(batch, 3, resolution, resolution, generator=gen,
                         device=dev).to(dtype) * 2 - 1 for _ in range(iters)]
    dec = [randn(batch, 4, lat, lat) for _ in range(iters)]

    def aux(static):
        if static and not aux_amax:
            aux_amax.update(make_aux_calibration_fn(modules)(
                torch.zeros_like(pixels[0]), randn(batch, 4, lat, lat)))
        return dict(_aux_sites(modules, aux_amax if static else None))

    with torch.inference_mode():
        for name in rows:
            if name == "unet_fwd":
                unet_row(name)
            elif name == "unet_fwd_int8":
                unet_row(name, _unet_sites(unet, {}, True, None))
            elif name == "unet_fwd_int8_attn":
                # the int8 attention alone, bf16 GEMMs and convolutions
                unet_row(name, attn=True)
            elif name in ("unet_fwd_int8_static",
                          "unet_fwd_int8_static_attn"):
                sites = _unet_sites(unet, {}, "static", unet_amax())
                calib[name] = 1
                unet_row(name, sites, attn=name.endswith("_attn"))
            elif name == "unet_fwd_with_tap":
                unet_row(name, return_encoder_outputs="with_eps")
            elif name == "text_encoder":
                embeds = [randn(batch, n_ctx, text.config.hidden_size)
                          for _ in range(iters)]
                time_row(name, lambda i: text(inputs_embeds=embeds[i])[0])
            elif name.startswith("vit_encode"):
                contexts = []
                if name != "vit_encode":
                    static = name.endswith("_static")
                    if static:
                        calib[name] = int(not aux_amax)
                    vit = e4t.clip_vision
                    contexts = [quant.int8_sites(vit, aux(static)[vit])]
                time_row(name, lambda i: e4t.encode_image(pixels[i]),
                         contexts)
            elif name == "e4t_fuse":
                cfg = e4t.config
                feats = [randn(batch, cfg.n_fused, cfg.vit.width)
                         for _ in range(iters)]
                tap = [randn(batch, cfg.unet_feature_dim)
                       for _ in range(iters)]
                time_row(name, lambda i: e4t.fuse(feats[i], tap[i]))
            elif name.startswith("vae_decode"):
                contexts = []
                if name != "vae_decode":
                    static = name.endswith("_static")
                    if static:
                        calib[name] = int(not aux_amax)
                    contexts = [quant.int8_sites(vae, aux(static)[vae])]
                time_row(name, lambda i: vae.decode(dec[i]), contexts)
            elif name == "fold_offsets":
                jitter = [1e-4 * i / max(iters - 1, 1) for i in range(iters)]
                time_row(name, lambda i: wo.fold_offset_bank(
                    unet, {k: v + jitter[i] for k, v in offsets.items()}))
    parts = ("unet_fwd_with_tap_ms", "unet_fwd_ms", "text_encoder_ms",
             "e4t_fuse_ms")
    if all(k in results for k in parts):
        results["est_cfg_step_ms"] = sum(results[k] for k in parts)
    add_mfu(results, row_flops(modules, batch, resolution))
    results.update({"batch": batch, "resolution": resolution,
                    "attn_mode": attn_mode, "calls": calls,
                    "calib_calls": calib})
    return results


def _modules(sd2: bool, dtype, seed: int = 0):
    """Full-width E4T modules (SD v1, or SD 2.1 with ``sd2``) with seeded
    random weights on the card, and an offset bank."""
    import torch

    from e4t_diffusion_torch.diffusion.pipeline import E4TModules
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
    from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
    from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
    from e4t_diffusion_torch.models.vae import VAEConfig

    ucfg = UNetConfig.sd2() if sd2 else UNetConfig()
    tcfg = CLIPTextConfig.sd2() if sd2 else CLIPTextConfig()
    ecfg = E4TEncoderConfig(word_embedding_dim=tcfg.hidden_size,
                            unet_feature_dim=tap_feature_dim(ucfg))
    torch.manual_seed(seed)
    modules = E4TModules.create(ucfg, VAEConfig(), tcfg, ecfg, dtype=dtype,
                                device="cuda")
    offsets = wo.init_offset_bank(
        ucfg, torch.Generator("cuda").manual_seed(seed + 1), device="cuda")
    return modules, offsets


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sd2", action="store_true",
                        help="SD 2.1 at 768px instead of SD v1 at 512px")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)  # run as a file from the checkout
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_components: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    print(smi)
    batch = int(os.environ.get("E4T_BENCH_BATCH", "8"))
    res = int(os.environ.get("E4T_BENCH_RES", "768" if args.sd2 else "512"))
    iters = int(os.environ.get("E4T_BENCH_ITERS", "10"))
    only = os.environ.get("E4T_BENCH_ONLY", "")
    modules, offsets = _modules(args.sd2, torch.bfloat16)
    results = time_components(
        modules, offsets, batch, res, iters,
        rows=only.split(",") if only else None,
        attn_mode=os.environ.get("E4T_BENCH_ATTN_MODE", "qk"))
    results.update({"model": "sd2.1" if args.sd2 else "sd-v1",
                    "card": smi})
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
