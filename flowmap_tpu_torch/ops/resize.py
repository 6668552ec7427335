"""Bilinear resize with `F.interpolate(align_corners=False)` semantics.

Counterpart of `flowmap_tpu/ops/resize.py:resize_bilinear`. The JAX package
builds the resize from static slices (integer factors) or one-hot matmuls
because gathers are slow on the TPU; PyTorch's own non-antialiased bilinear
interpolation is exactly the reference semantics (source coordinate
(dst + 0.5) * in/out - 0.5, corners clamped to the image).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Resize NCHW images to `shape` = (ho, wo)."""
    if tuple(images.shape[-2:]) == tuple(shape):
        return images
    return F.interpolate(
        images, size=tuple(shape), mode="bilinear", align_corners=False,
        antialias=False,
    )
