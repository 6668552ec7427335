"""Extrinsics: Procrustes alignment (default) or regressed poses.

Counterpart of `flowmap_tpu/model/extrinsics/extrinsics.py` (reference
`extrinsics_procrustes.py:22-59`, `extrinsics_regressed.py:17-83`). The
Procrustes subset is the static linspace of pixel indices
(`randomize_points=False`); randomized subsets draw from a torch.Generator.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np
import torch
import torch.nn as nn

from ...ops.geometry import get_extrinsics
from ...ops.procrustes import quaternion_to_matrix
from ...ops.surface import align_surfaces
from ...types import BackboneOutput, Flows


@dataclass(frozen=True)
class ExtrinsicsProcrustesCfg:
    name: Literal["procrustes"] = "procrustes"
    num_points: Optional[int] = 1000
    randomize_points: bool = False


@dataclass(frozen=True)
class ExtrinsicsRegressedCfg:
    name: Literal["regressed"] = "regressed"


ExtrinsicsCfg = ExtrinsicsProcrustesCfg | ExtrinsicsRegressedCfg


class ExtrinsicsParams(nn.Module):
    """Trainable pose parameters (regressed extrinsics only)."""

    def __init__(self, cfg: ExtrinsicsCfg, num_frames: Optional[int]):
        super().__init__()
        if isinstance(cfg, ExtrinsicsRegressedCfg):
            if num_frames is None or num_frames < 2:
                raise ValueError("regressed extrinsics need num_frames >= 2")
            rotations = torch.zeros((num_frames - 1, 4))
            rotations[:, -1] = 1.0  # identity quaternions, scipy (x, y, z, w)
            self.translations = nn.Parameter(torch.zeros((num_frames - 1, 3)))
            self.rotations = nn.Parameter(rotations)


def _scipy_quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-8)
    return quaternion_to_matrix(torch.cat([q[..., 3:4], q[..., :3]], dim=-1))


@functools.lru_cache(maxsize=16)
def _linspace_indices(num_points: int, size: int, device: torch.device) -> torch.Tensor:
    """The static subset, copied to the device once."""
    return torch.as_tensor(np.linspace(0, size - 1, num_points).astype(np.int64), device=device)


def procrustes_indices(cfg: ExtrinsicsProcrustesCfg, h: int, w: int, device,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if cfg.num_points is None:
        return torch.arange(h * w, device=device)
    if cfg.randomize_points:
        return torch.randint(0, h * w, (cfg.num_points,), generator=generator).to(device)
    return _linspace_indices(cfg.num_points, h * w, torch.device(device))


def apply_extrinsics(
    cfg: ExtrinsicsCfg,
    params: ExtrinsicsParams,
    flows: Flows,
    backbone_output: BackboneOutput,
    surfaces: torch.Tensor,  # (b, f, h, w, 3)
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:  # (b, f, 4, 4)
    b, f, h, w, _ = surfaces.shape
    if isinstance(cfg, ExtrinsicsRegressedCfg):
        if b != 1:
            raise ValueError("regressed extrinsics only make sense for one scene")
        rotation = _scipy_quaternion_to_matrix(params.rotations)
        top = torch.cat([rotation, params.translations[..., None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return get_extrinsics(torch.cat([top, bottom], dim=-2))[None]
    indices = procrustes_indices(cfg, h, w, surfaces.device, generator)
    return align_surfaces(surfaces, flows.backward, backbone_output.weights, indices)
