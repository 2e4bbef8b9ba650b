"""Image transforms of the training input pipeline.

The port's own copy of the transform half of
``e4t_diffusion_tpu/data/dataset.py``: SmallestMaxSize with cv2.INTER_AREA
(the reference's interpolation=3), center or random crop, a p=0.5
horizontal flip and x / 127.5 - 1, HWC uint8 -> CHW float32. The draws come
from numpy's ``default_rng(seed)`` in the same order, so a seed gives the
JAX package's crops and flips. cv2 is imported only when a resize is
needed. The dataset sources (folders, tar shards) come with pretraining.
"""
from __future__ import annotations

import numpy as np


def smallest_max_size(image: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side == size (albumentations SmallestMaxSize),
    cv2.INTER_AREA interpolation."""
    h, w = image.shape[:2]
    scale = size / min(h, w)
    if scale == 1.0:
        return image
    import cv2

    new_w, new_h = round(w * scale), round(h * scale)
    return cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top:top + size, left:left + size]


def random_crop(image: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    h, w = image.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return image[top:top + size, left:left + size]


def make_transform(size: int, random_crop_flag: bool = False,
                   hflip: bool = True, seed: int = 0):
    """HWC uint8 -> CHW float32 in [-1, 1] at ``size`` x ``size``."""
    rng = np.random.default_rng(seed)

    def apply(image: np.ndarray) -> np.ndarray:
        image = smallest_max_size(image, size)
        if random_crop_flag:
            image = random_crop(image, size, rng)
        else:
            image = center_crop(image, size)
        if hflip and rng.random() < 0.5:
            image = image[:, ::-1]
        image = image.astype(np.float32) / 127.5 - 1.0
        return np.ascontiguousarray(image.transpose(2, 0, 1))

    return apply


def load_image_rgb(path_or_file) -> np.ndarray:
    """A local image as an RGB uint8 HWC array."""
    from PIL import Image

    with Image.open(path_or_file) as img:
        return np.asarray(img.convert("RGB"))
