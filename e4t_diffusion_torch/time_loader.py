#!/usr/bin/env python3
"""Input-pipeline throughput: the native transform against cv2.

    python3 e4t_diffusion_torch/time_loader.py [--batches 40]
        [--batch-size 16] [--resolution 512] [--source-px 768]
        [--n-images 256] [--source DIR] [--workers 0 8]

The counterpart of the JAX package's ``scripts/bench_loader.py``: the host
side of ``data/dataset.E4TDataLoader`` alone (decode, area resize, random
crop, flip, normalise), with no device work, once with the native C++
transform (``data/native_ops``, the loader's default) and once with the
numpy/cv2 one (``E4T_DISABLE_NATIVE=1``), at each ``--workers`` count (0 and
1: one decode thread). Without ``--source`` it writes ``--n-images``
photo-like JPEGs of ``--source-px`` x 4/3 of that into a temporary
directory. Prints one JSON line per variant and worker count:
``{"metric": "loader_images_per_sec", "variant": "native" | "cv2",
"loader_images_per_sec": ..., "s_per_batch": ..., ...}``, over
``--batches`` batches after 3 warm ones. The phase-1 loop waits on the
loader once its rate falls below the step's (batch / s per step).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

VARIANTS = ("native", "cv2")


def make_dataset(root: str, n: int, px: int) -> str:
    """``n`` non-square (px x 4/3 px) JPEGs of smooth content with grain."""
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        h, w = px, int(px * 4 / 3)
        base = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(base).resize((w, h),
                                                      Image.BILINEAR))
        noise = rng.integers(0, 30, img.shape, dtype=np.uint8)
        Image.fromarray(img + noise).save(
            os.path.join(root, f"{i:04d}.jpg"), quality=92)
    return root


def run_variant(source: str, variant: str, batch_size: int, resolution: int,
                batches: int, num_workers: int = 0,
                warmup: int = 3) -> Dict:
    """The loader's images per second under ``variant`` over ``batches``
    batches after ``warmup``."""
    from e4t_diffusion_torch.data import native_ops
    from e4t_diffusion_torch.data.dataset import E4TDataLoader

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    saved = os.environ.get(native_ops.DISABLE_KNOB)
    os.environ[native_ops.DISABLE_KNOB] = "1" if variant == "cv2" else "0"
    try:
        loader = E4TDataLoader(source, batch_size=batch_size,
                               resolution=resolution, random_crop=True,
                               process_index=0, process_count=1,
                               num_workers=num_workers)
    finally:
        if saved is None:
            os.environ.pop(native_ops.DISABLE_KNOB)
        else:
            os.environ[native_ops.DISABLE_KNOB] = saved
    if loader.transform_kind != variant:
        raise RuntimeError(f"the loader took {loader.transform_kind}, "
                           f"not {variant}")
    it = iter(loader)
    try:
        for _ in range(warmup):
            next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            b = next(it)
        wall = time.perf_counter() - t0
    finally:
        it.close()  # stop the threads before the next variant runs
    if b["pixel_values"].shape != (batch_size, 3, resolution, resolution):
        raise RuntimeError(f"a batch of shape {b['pixel_values'].shape}")
    return {"metric": "loader_images_per_sec", "variant": variant,
            "loader_images_per_sec": batches * batch_size / wall,
            "s_per_batch": wall / batches, "unit": "images/sec",
            "batch": batch_size, "resolution": resolution,
            "workers": num_workers}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--source-px", type=int, default=768)
    ap.add_argument("--n-images", type=int, default=256)
    ap.add_argument("--source", default=None,
                    help="existing image dir (default: synthesize)")
    ap.add_argument("--workers", type=int, nargs="*", default=[0, 8],
                    help="worker counts to sweep")
    args = ap.parse_args(argv)

    records = []
    with tempfile.TemporaryDirectory() as tmp:
        source = args.source or make_dataset(
            os.path.join(tmp, "images"), args.n_images, args.source_px)
        for workers in args.workers:
            for variant in VARIANTS:
                records.append(run_variant(
                    source, variant, args.batch_size, args.resolution,
                    args.batches, num_workers=workers))
                print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
