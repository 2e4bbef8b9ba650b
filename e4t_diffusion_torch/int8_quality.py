"""int8 against bf16 serving quality at SD-v1 geometry:
``python -m e4t_diffusion_torch.int8_quality``.

Counterpart of the JAX package's ``scripts/int8_quality.py``. Trained SD
weights are not at hand, but how quantization error propagates through the
network depends on the layer shapes, the activation magnitudes and the
denoise loop's feedback, which structured random weights reproduce
(``utils/structured_init``: fan-in-scaled weights, unit norm scales, zero
biases; the real offset-bank init). Per denoise step it measures the
relative L2 distance between the full-precision trajectory and the int8
one (``pipeline.make_trajectory_fn``), against the distance between two
full-precision trajectories from different noise (the "unrelated samples"
scale), and decodes each config's final latents through one VAE for
image-space rel-L2 and PSNR.

Knobs (environment, as the JAX script reads them): E4T_QUAL_STEPS (50;
8 tiny), E4T_QUAL_RES (512; 32 tiny), E4T_QUAL_BATCH (1), E4T_QUAL_MODE, a
comma list of configs (default static):
  static | dynamic | static_pc   the int8 UNet (ops/quant.py)
  attn_qk | attn_qkpv            the int8 attention kernel alone (its
                                 flash-routed sites: none on the CPU)
  static_attn                    static int8 and "qk" attention
  static~G1:G2:...               static int8 with the sites whose JAX path
                                 holds any Gi on dynamic scales
  calib_gap                      no trajectory: the sites whose live range
                                 over a full-length calibration exceeds
                                 the short calibration's
  both                           static,dynamic
E4T_QUAL_SCHEDULER (ddim | dpmpp), E4T_QUAL_TINY (1: the tiny configs),
E4T_QUAL_IMAGE (1: decode and score images; 0 skips),
E4T_QUAL_CALIB_STEPS (min(8, steps)). ``--device cpu`` runs on the CPU
(f32); the default is the GPU (bf16). One JSON line per config.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from e4t_diffusion_torch.diffusion.pipeline import (
    E4TModules, make_calibration_fn, make_trajectory_fn, resolve_device,
    resolve_dtype)
from e4t_diffusion_torch.diffusion.schedulers import (
    DDIMScheduler, DPMSolverMultistepScheduler)
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.utils.structured_init import structured_fill_

# (UNet int8 mode, attention int8 mode) by config name
CONFIGS = {
    "static": ("static", False),
    "static_pc": ("static_pc", False),
    "dynamic": (True, False),
    "attn_qk": (False, "qk"),
    "attn_qkpv": (False, "qkpv"),
    "static_attn": ("static", "qk"),
}
GUIDANCE, EMBED_SCALE = 7.5, 0.1


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per leading index: ||a - b|| / ||b||."""
    num = np.linalg.norm((a - b).reshape(a.shape[0], -1), axis=1)
    den = np.linalg.norm(b.reshape(b.shape[0], -1), axis=1)
    return num / np.maximum(den, 1e-12)


def image_metrics(img_q, img_ref, img_anchor) -> dict:
    """Whole-batch image rel-L2 and PSNR (pixels in [0, 1])."""
    num = float(np.linalg.norm(img_q - img_ref))
    den = float(max(np.linalg.norm(img_ref), 1e-12))
    mse = float(np.mean((img_q - img_ref) ** 2))
    anchor = float(np.linalg.norm(img_anchor - img_ref)) / den
    return {"image_rel_l2": num / den,
            "image_psnr_db": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
            "image_anchor_rel_l2": anchor,
            "image_fraction_of_unrelated": (num / den) / max(anchor, 1e-12)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; runs on the GPU unless 'cpu' "
                             "is given")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    dtype = resolve_dtype("auto", device)
    tiny = os.environ.get("E4T_QUAL_TINY", "0") == "1"
    steps = int(os.environ.get("E4T_QUAL_STEPS", "8" if tiny else "50"))
    res = int(os.environ.get("E4T_QUAL_RES", "32" if tiny else "512"))
    batch = int(os.environ.get("E4T_QUAL_BATCH", "1"))
    mode = os.environ.get("E4T_QUAL_MODE", "static")
    calib_steps = int(os.environ.get("E4T_QUAL_CALIB_STEPS",
                                     str(min(8, steps))))

    gen = torch.Generator(device).manual_seed(0)
    modules = (E4TModules.tiny(dtype, device) if tiny
               else E4TModules.create(dtype=dtype, device=device))
    for m in modules.all():
        structured_fill_(m, gen)
    # the real offset-bank init: quantization folds the (1 + O) weights
    offsets = wo.init_offset_bank(modules.unet.config, gen, device)
    hidden = modules.text_encoder.config.hidden_size
    length = modules.text_encoder.config.max_position_embeddings
    lat = res // 2 ** (len(modules.vae.config.block_out_channels) - 1)
    latents0, latents1 = (torch.randn(batch, 4, lat, lat, generator=gen,
                                      device=device) for _ in range(2))
    pixels = torch.rand(1, 3, res, res, generator=gen, device=device) * 2 - 1
    inputs = (pixels,
              0.02 * torch.randn(1, length, hidden, generator=gen,
                                 device=device).to(dtype),
              torch.full((batch,), 4, device=device),
              torch.zeros(1, length, dtype=torch.long, device=device),
              0.02 * torch.randn(hidden, generator=gen,
                                 device=device).to(dtype))
    sched = (DPMSolverMultistepScheduler()
             if os.environ.get("E4T_QUAL_SCHEDULER", "ddim") == "dpmpp"
             else DDIMScheduler())

    def noise():
        return torch.Generator(device).manual_seed(42)

    def run_traj(int8, latents, act_amax=None, int8_attn=False,
                 static_exclude=""):
        prev = os.environ.get("E4T_INT8_STATIC_EXCLUDE")
        os.environ["E4T_INT8_STATIC_EXCLUDE"] = static_exclude
        try:
            fn = make_trajectory_fn(modules, sched, steps, GUIDANCE,
                                    EMBED_SCALE, int8=int8,
                                    int8_attn=int8_attn)
            traj = fn(offsets, latents, *inputs, noise(), act_amax=act_amax)
            return traj.float().cpu().numpy()
        finally:
            if prev is None:
                os.environ.pop("E4T_INT8_STATIC_EXCLUDE", None)
            else:
                os.environ["E4T_INT8_STATIC_EXCLUDE"] = prev

    def calibrate(n_steps):
        return make_calibration_fn(modules, sched, n_steps, GUIDANCE,
                                   EMBED_SCALE)(offsets, latents0, *inputs,
                                                noise())

    print(f"[int8_quality] {'tiny' if tiny else 'SD-v1'} geometry, {res}px, "
          f"{steps} steps, batch {batch}, {dtype} on {device}",
          file=sys.stderr)
    t_ref = run_traj(False, latents0)
    t_anchor = run_traj(False, latents1)  # same weights, other noise
    anchor = _rel(t_anchor, t_ref)

    decode = None
    if os.environ.get("E4T_QUAL_IMAGE", "1") == "1":
        vae = modules.vae

        @torch.inference_mode()
        def decode(final):
            z = torch.from_numpy(final).to(device, dtype)
            img = vae.decode(z / vae.config.scaling_factor)
            return (img / 2 + 0.5).clamp(0, 1).float().cpu().numpy()

        img_ref, img_anchor = decode(t_ref[-1]), decode(t_anchor[-1])

    modes = ["static", "dynamic"] if mode == "both" else mode.split(",")
    if (device.type != "cuda"
            and any(CONFIGS.get(m, ("", False))[1] for m in modes)):
        print("[int8_quality] WARNING: the int8 attention modes act only at "
              "flash-routed sites, which the CPU has none of: they measure "
              "0 divergence here", file=sys.stderr)
    results, short = [], None
    for m in modes:
        if m == "calib_gap":
            full = calibrate(steps)
            short = short or calibrate(calib_steps)
            rows = sorted(
                ((float(full[n]["amax"]) / max(float(s["amax"]), 1e-12),
                  float(s["amax"]), float(full[n]["amax"]), n)
                 for n, s in short.items()), reverse=True)
            out = {"metric": "int8_static_calib_gap",
                   "unit": "live_amax / calibrated_amax (>1 clips)",
                   "calib_steps": calib_steps, "full_steps": steps,
                   "n_sites": len(rows),
                   "n_clipping": sum(r[0] > 1.0 + 1e-6 for r in rows),
                   "worst": [{"site": quant.jax_path(r[3]), "ratio": r[0],
                              "calib_amax": r[1], "live_amax": r[2]}
                             for r in rows[:20]]}
        else:
            static_exclude = ""
            if m.startswith("static~"):
                static_exclude = m.split("~", 1)[1].replace(":", ",")
                int8, int8_attn = "static", False
            else:
                int8, int8_attn = CONFIGS[m]
            act_amax = None
            if int8 in ("static", "static_pc"):
                short = short or calibrate(calib_steps)
                act_amax = short
            t_q = run_traj(int8, latents0, act_amax, int8_attn,
                           static_exclude)
            d = _rel(t_q, t_ref)
            out = {"metric": f"int8_{m}_vs_bf16_rel_l2_final",
                   "value": float(d[-1]),
                   "unit": "relative L2 (final latents)",
                   "anchor_unrelated_rel_l2": float(anchor[-1]),
                   "fraction_of_unrelated": float(
                       d[-1] / max(anchor[-1], 1e-12)),
                   "per_step_rel_l2": [float(x) for x in d],
                   "steps": steps, "res": res,
                   "geometry": "tiny" if tiny else "sd-v1",
                   "scheduler": type(sched).__name__,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
            if act_amax is not None:
                out["calib_steps"] = calib_steps
            if decode is not None:
                out.update(image_metrics(decode(t_q[-1]), img_ref,
                                         img_anchor))
        results.append(out)
        print(json.dumps(out))
    return results


if __name__ == "__main__":
    main()
