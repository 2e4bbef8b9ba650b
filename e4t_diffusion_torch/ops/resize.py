"""Image preprocessing for the CLIP-vision path.

Counterpart of ``e4t_diffusion_tpu/ops/resize.py``: bicubic resize to 224²
with ``align_corners=True`` and no antialias, written as two separable
(out, in) resampling matrices, then [-1, 1] -> [0, 1] and the CLIP
mean/std normalization.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel; a=-0.75 is torch's bicubic."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=32)
def _bicubic_matrix(in_size: int, out_size: int,
                    align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix for one axis."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        m[0, 0] = 1.0
        return m.astype(np.float32)
    for o in range(out_size):
        if align_corners:
            src = o * (in_size - 1) / (out_size - 1)
        else:
            src = (o + 0.5) * in_size / out_size - 0.5
        i0 = int(np.floor(src))
        for tap in range(-1, 3):
            i = i0 + tap
            w = _cubic_kernel(np.array(src - i))
            ic = min(max(i, 0), in_size - 1)  # replicate border
            m[o, ic] += float(w)
    return m.astype(np.float32)


def resize_bicubic_align_corners(x: torch.Tensor, out_h: int,
                                 out_w: int) -> torch.Tensor:
    """Bicubic resize of NCHW images (align_corners=True), computed in f32,
    returned in x's dtype."""
    _, _, h, w = x.shape
    mh = torch.from_numpy(_bicubic_matrix(h, out_h, True)).to(x.device)
    mw = torch.from_numpy(_bicubic_matrix(w, out_w, True)).to(x.device)
    y = torch.matmul(mh, x.float())            # (n, c, out_h, w)
    y = torch.matmul(y, mw.transpose(0, 1))    # (n, c, out_h, out_w)
    return y.to(x.dtype)


def clip_preprocess(x: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """Resize + [-1,1]->[0,1] + CLIP normalize; NCHW in [-1, 1] in."""
    x = resize_bicubic_align_corners(x, image_size, image_size)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype,
                        device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, dtype=x.dtype,
                       device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std
