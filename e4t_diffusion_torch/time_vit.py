#!/usr/bin/env python3
"""ViT-H-14 tower ablations on one NVIDIA GPU: where do its milliseconds
go?

    python3 e4t_diffusion_torch/time_vit.py

The counterpart of the JAX package's ``scripts/bench_vit.py``. Times the
tower alone (224px input, the shape ``encode_image`` feeds it; bf16, seeded
random weights) under ablations that isolate the candidate costs:

  base        the full ViT-H-14 forward
  gelu_tanh   tanh-approximate GELU instead of open_clip's exact erf
              (``ViTConfig.gelu_approximate``)
  no_attn     the attention products skipped, the projections kept
              (``ablate_attn``)
  no_ln       ``ln_1`` / ``ln_2`` skipped in every block (``ablate_ln``)
  shortseq    the 32 257-token self-attention sites on the short-sequence
              kernel (``E4T_SHORTSEQ_MH_ATTN``, 8 heads a cell): the
              port's counterpart of the JAX script's ``flash`` row, since
              the port routes those sites to that kernel (at batch 8 they
              stay on einsum attention otherwise)

Every row shares the base tower's weights. Each time is the median over
``E4T_BENCH_ITERS`` calls on distinct inputs by CUDA events, after one
warm call; ``<row>_mfu`` is the BASE analytic count (``utils/flops.
vit_forward``) over that time over the bf16 peak, so that an ablation's
gain reads as recovered milliseconds. Prints the card's ``nvidia-smi``
line, then one JSON line.

Knobs: ``E4T_BENCH_BATCH`` (8), ``E4T_BENCH_ITERS`` (10),
``E4T_VIT_CONFIGS`` (a comma list of the names above; default all). Needs
a GPU; imports no JAX. ``time_vit(tower, ...)`` is what ``chip_smoke.py``
calls on its pipeline's tower.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = ("base", "gelu_tanh", "no_attn", "no_ln", "shortseq")
ABLATION_FIELDS = {"base": {}, "gelu_tanh": {"gelu_approximate": True},
                   "no_attn": {"ablate_attn": True},
                   "no_ln": {"ablate_ln": True}}
SHORTSEQ_HEADS = 8


def ablated(tower, fields: Dict):
    """A ``VisionTransformer`` with ``fields`` set on ``tower``'s config that
    shares ``tower``'s parameters (none of them copied)."""
    import torch

    from e4t_diffusion_torch.models.vit import VisionTransformer

    if not fields:
        return tower
    cfg = dataclasses.replace(tower.config, **fields)
    with torch.device("meta"):
        out = VisionTransformer(cfg)
    own = tower.state_dict()
    out.load_state_dict({k: own[k] for k in out.state_dict()}, strict=True,
                        assign=True)
    return out.eval().requires_grad_(False)


@contextlib.contextmanager
def _shortseq(heads: int):
    from e4t_diffusion_torch.ops.shortseq import KNOB

    saved = os.environ.get(KNOB)
    os.environ[KNOB] = str(heads)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(KNOB, None)
        else:
            os.environ[KNOB] = saved


def time_vit(tower, batch: int = 8, iters: int = 10,
             configs: Optional[Sequence[str]] = None, seed: int = 1) -> Dict:
    """Times ``configs`` (default ``CONFIGS``) of
    ``tower`` (a ``VisionTransformer`` on the card). Returns {"<row>_ms",
    "<row>_mfu", "batch", "calls": {row: forwards made}}."""
    import torch

    from e4t_diffusion_torch import time_components as tc
    from e4t_diffusion_torch.utils import flops as fl

    configs = list(CONFIGS if configs is None else configs)
    for name in configs:
        if name not in CONFIGS:
            raise ValueError(f"no ViT ablation {name!r}: one of {CONFIGS}")
    weight = tower.conv1.weight
    size = tower.config.image_size
    gen = torch.Generator(weight.device).manual_seed(seed)
    pixels = [torch.randn(batch, 3, size, size, generator=gen,
                          device=weight.device).to(weight.dtype)
              for _ in range(iters)]
    analytic = fl.vit_forward(tower.config, batch)
    results: Dict = {}
    calls: Dict[str, int] = {}
    with torch.inference_mode():
        for name in configs:
            if name == "shortseq":
                model, ctx = tower, _shortseq(SHORTSEQ_HEADS)
            else:
                model = ablated(tower, ABLATION_FIELDS[name])
                ctx = contextlib.nullcontext()
            with ctx:
                ms = tc.events_ms(lambda i: model(pixels[i]), iters)
            calls[name] = iters + 1
            results[f"{name}_ms"] = ms
            results[f"{name}_mfu"] = (analytic / (ms * 1e-3)
                                      / fl.H100_BF16_PEAK)
    results.update({"batch": batch, "calls": calls,
                    "note": "tower only at 224px; encode_image adds the "
                            "resize and normalisation. Every row's MFU uses "
                            "the base analytic FLOPs."})
    return results


def main(argv=None) -> Dict:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.parse_args(argv)
    sys.path.insert(0, REPO)  # run as a file from the checkout
    if not torch.cuda.is_available():
        sys.exit("time_vit: needs an NVIDIA GPU")
    from e4t_diffusion_torch.models.vit import ViTConfig, VisionTransformer
    from e4t_diffusion_torch.time_components import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    print(smi)
    torch.manual_seed(0)
    with torch.device("cuda"):
        tower = VisionTransformer(ViTConfig.vit_h_14())
    tower = tower.to(torch.bfloat16).eval().requires_grad_(False)
    sel = os.environ.get("E4T_VIT_CONFIGS", "")
    results = time_vit(tower, int(os.environ.get("E4T_BENCH_BATCH", "8")),
                       int(os.environ.get("E4T_BENCH_ITERS", "10")),
                       sel.split(",") if sel else None)
    results["card"] = smi
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
