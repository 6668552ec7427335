"""Backbone registry: config-discriminated construction (reference
`flowmap/model/backbone/__init__.py:13-18`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .backbone_explicit_depth import BackboneExplicitDepth, BackboneExplicitDepthCfg
from .backbone_midas import BackboneMidas, BackboneMidasCfg

BackboneCfg = BackboneExplicitDepthCfg | BackboneMidasCfg


def init_backbone(
    cfg: BackboneCfg,
    num_frames: Optional[int],
    image_shape: Optional[tuple[int, int]],
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """The backbone module for `cfg`; call it as `backbone(batch, flows)`."""
    if isinstance(cfg, BackboneExplicitDepthCfg):
        if num_frames is None or image_shape is None:
            raise ValueError("explicit depth needs num_frames and image_shape")
        return BackboneExplicitDepth(cfg, num_frames, image_shape)
    if isinstance(cfg, BackboneMidasCfg):
        return BackboneMidas(cfg, num_frames, image_shape, generator)
    raise ValueError(f"unknown backbone cfg: {cfg}")
