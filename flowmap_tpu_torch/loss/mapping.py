"""Pointwise robust distance mappings (L1 / L2 / Huber) with the aspect fix.

Counterpart of `flowmap_tpu/loss/mapping.py` (reference `loss/mapping/*.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch


@dataclass(frozen=True)
class MappingCfg:
    name: Literal["l1", "l2", "huber"] = "huber"
    delta: Optional[float] = 0.01  # only used by huber


def fix_aspect_ratio(points: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """Scale normalized coordinates by (w, h) / sqrt(h w) so distances are isotropic."""
    h, w = image_shape
    scale = (h * w) ** 0.5
    correction = torch.tensor(
        [w / scale, h / scale], dtype=points.dtype, device=points.device
    )
    return points * correction


def apply_mapping(
    cfg: MappingCfg,
    a: torch.Tensor,
    b: torch.Tensor,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Aspect-corrected robust distance between (..., 2) coordinate arrays."""
    delta = fix_aspect_ratio(a, image_shape) - fix_aspect_ratio(b, image_shape)
    return apply_mapping_components(cfg, delta[..., 0], delta[..., 1])


def apply_mapping_components(
    cfg: MappingCfg, du: torch.Tensor, dv: torch.Tensor
) -> torch.Tensor:
    """Mapping of an already aspect-corrected componentwise delta."""
    if cfg.name == "l2":
        return 0.5 * (du * du + dv * dv)
    norm = torch.sqrt(du * du + dv * dv + 1e-24)
    if cfg.name == "l1":
        return norm
    if cfg.name == "huber":
        # torch huber divided by delta so the linear slope matches L1.
        d = cfg.delta
        return torch.where(norm < d, 0.5 * norm * norm, d * (norm - 0.5 * d)) / d
    raise ValueError(f"unknown mapping: {cfg.name}")
