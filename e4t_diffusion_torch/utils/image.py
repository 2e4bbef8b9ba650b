"""Image utilities: grids and local image loading.

The port's own copy of ``e4t_diffusion_tpu/utils/image.py`` and of the two
transforms it uses from ``e4t_diffusion_tpu/data/dataset.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image


def smallest_max_size(image: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side == size (albumentations SmallestMaxSize),
    cv2.INTER_AREA interpolation."""
    import cv2

    h, w = image.shape[:2]
    scale = size / min(h, w)
    if scale == 1.0:
        return image
    new_w, new_h = round(w * scale), round(h * scale)
    return cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top:top + size, left:left + size]


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

