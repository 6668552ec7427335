"""Batch resizing and cropping for the model and flow resolutions.

Counterpart of `flowmap_tpu/utils/cropping.py` (reference
`flowmap/misc/cropping.py`). The model batch is resized to a pixel budget
(or an exact shape) and centre-cropped to a multiple of the patch size; the
flow batch is the same at `flow_scale_multiplier` times the resolution;
intrinsics are adjusted for the crops. The two PIL helpers serve dataset
loading and import PIL only when called.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..ops.resize import resize_bilinear
from ..types import Batch


@dataclass(frozen=True)
class CroppingCfg:
    image_shape: Union[tuple[int, int], int] = 43200  # exact shape or ~pixels
    flow_scale_multiplier: int = 4
    patch_size: int = 32


def resize_batch(batch: Batch, shape: tuple[int, int]) -> Batch:
    b, f, c, h, w = batch.videos.shape
    videos = resize_bilinear(batch.videos.reshape(b * f, c, h, w), shape)
    return dataclasses.replace(batch, videos=videos.reshape(b, f, c, *shape))


def compute_patch_cropped_shape(shape: tuple[int, int], patch_size: int) -> tuple[int, int]:
    h, w = shape
    return (h // patch_size) * patch_size, (w // patch_size) * patch_size


def center_crop_images(images: torch.Tensor, new_shape: tuple[int, int]) -> torch.Tensor:
    *_, h, w = images.shape
    h_new, w_new = new_shape
    row = (h - h_new) // 2
    col = (w - w_new) // 2
    return images[..., row : row + h_new, col : col + w_new]


def center_crop_intrinsics(
    intrinsics: Optional[torch.Tensor],
    old_shape: tuple[int, int],
    new_shape: tuple[int, int],
) -> Optional[torch.Tensor]:
    """Adjust normalised intrinsics for a centre crop (fx and fy scale; the
    principal point stays at the crop's centre)."""
    if intrinsics is None:
        return None
    h_old, w_old = old_shape
    h_new, w_new = new_shape
    intrinsics = torch.as_tensor(intrinsics)
    scale = torch.ones((3, 3), dtype=intrinsics.dtype, device=intrinsics.device)
    scale[0, 0] = w_old / w_new
    scale[1, 1] = h_old / h_new
    return intrinsics * scale


def patch_crop_batch(batch: Batch, patch_size: int) -> Batch:
    _, _, _, h, w = batch.videos.shape
    new_shape = compute_patch_cropped_shape((h, w), patch_size)
    return dataclasses.replace(
        batch,
        intrinsics=center_crop_intrinsics(batch.intrinsics, (h, w), new_shape),
        videos=center_crop_images(batch.videos, new_shape),
    )


def get_image_shape(original_shape: tuple[int, int], cfg: CroppingCfg) -> tuple[int, int]:
    if isinstance(cfg.image_shape, tuple):
        return cfg.image_shape
    h, w = original_shape
    scale = (cfg.image_shape / (h * w)) ** 0.5
    return (round(h * scale), round(w * scale))


def crop_and_resize_batch_for_model(
    batch: Batch, cfg: CroppingCfg
) -> tuple[Batch, tuple[int, int]]:
    """Returns (model batch, the shape before the crop, for un-cropping an export)."""
    image_shape = get_image_shape(tuple(batch.videos.shape[-2:]), cfg)
    batch = resize_batch(batch, image_shape)
    _, _, _, h, w = batch.videos.shape
    return patch_crop_batch(batch, cfg.patch_size), (h, w)


def crop_and_resize_batch_for_flow(batch: Batch, cfg: CroppingCfg) -> Batch:
    image_shape = get_image_shape(tuple(batch.videos.shape[-2:]), cfg)
    flow_shape = tuple(dim * cfg.flow_scale_multiplier for dim in image_shape)
    batch = resize_batch(batch, flow_shape)
    return patch_crop_batch(batch, cfg.patch_size * cfg.flow_scale_multiplier)


def resize_to_cover(image, shape: tuple[int, int]):
    """Uniformly scale and centre-crop a PIL image to cover `shape` (LANCZOS).
    Returns (image, the scaled shape before the crop)."""
    from PIL import Image

    w_old, h_old = image.size
    h_new, w_new = shape
    scale_factor = max(h_new / h_old, w_new / w_old)
    h_scaled = round(h_old * scale_factor)
    w_scaled = round(w_old * scale_factor)
    image_scaled = image.resize((w_scaled, h_scaled), Image.LANCZOS)
    x = (w_scaled - w_new) // 2
    y = (h_scaled - h_new) // 2
    return image_scaled.crop((x, y, x + w_new, y + h_new)), (h_scaled, w_scaled)


def resize_to_cover_with_intrinsics(images: list, shape: tuple[int, int], intrinsics):
    scaled_images = []
    old_shape = None
    for image in images:
        image, old_shape = resize_to_cover(image, shape)
        scaled_images.append(image)
    if intrinsics is not None and old_shape is not None:
        intrinsics = center_crop_intrinsics(intrinsics, old_shape, shape)
    return scaled_images, intrinsics
