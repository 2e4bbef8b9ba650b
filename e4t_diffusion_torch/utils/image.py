"""Image utilities: grids and local image loading.

The port's own copy of ``e4t_diffusion_tpu/utils/image.py``; its two
transforms come from ``data/dataset.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image

from e4t_diffusion_torch.data.dataset import center_crop, smallest_max_size


def image_grid(imgs, rows: int, cols: int) -> Image.Image:
    if len(imgs) != rows * cols:
        raise ValueError(f"{len(imgs)} images for a {rows}x{cols} grid")
    w, h = imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid


def load_image(path: str, resolution: Optional[int] = None) -> Image.Image:
    """Local-path image loader (+ optional SmallestMaxSize/center-crop).
    URLs are rejected: stage files locally."""
    if path.startswith(("http://", "https://")):
        raise ValueError(f"URL inputs are not supported; download {path} "
                         f"locally first.")
    img = Image.open(path).convert("RGB")
    if resolution:
        arr = smallest_max_size(np.asarray(img), resolution)
        img = Image.fromarray(center_crop(arr, resolution))
    return img



def to_pil(images01) -> list:
    """(B, 3, H, W) floats in [0, 1] (numpy or torch) -> a list of PIL
    images, rounded to uint8."""
    if hasattr(images01, "detach"):
        images01 = images01.detach().float().cpu().numpy()
    arr = (np.asarray(images01).transpose(0, 2, 3, 1) * 255).round().astype(
        np.uint8)
    return [Image.fromarray(a) for a in arr]
