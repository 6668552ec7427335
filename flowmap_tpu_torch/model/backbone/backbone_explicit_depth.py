"""Explicit per-pixel depth backbone (no network).

Counterpart of `flowmap_tpu/model/backbone/backbone_explicit_depth.py`
(reference `backbone_explicit_depth.py:19-44`): depth is an (f, h, w)
parameter and the correspondence weights are sigmoid(sensitivity * w).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
import torch.nn as nn

from ...types import BackboneOutput, Batch, Flows


@dataclass(frozen=True)
class BackboneExplicitDepthCfg:
    name: Literal["explicit_depth"] = "explicit_depth"
    initial_depth: float = 0.1
    weight_sensitivity: float = 100.0


class BackboneExplicitDepth(nn.Module):
    def __init__(self, cfg: BackboneExplicitDepthCfg, num_frames: int, image_shape):
        super().__init__()
        h, w = image_shape
        self.cfg = cfg
        self.depth = nn.Parameter(torch.full((num_frames, h, w), cfg.initial_depth))
        self.weights = nn.Parameter(torch.zeros((num_frames - 1, h, w)))

    def forward(self, batch: Batch, flows: Flows) -> BackboneOutput:
        if batch.videos.shape[0] != 1:
            raise ValueError("explicit depth only supports batch size 1")
        return BackboneOutput(
            depths=self.depth[None],
            weights=torch.sigmoid(self.cfg.weight_sensitivity * self.weights)[None],
        )
