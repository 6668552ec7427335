"""Model composition: backbone -> intrinsics -> unproject -> extrinsics.

Counterpart of `flowmap_tpu/model/model.py` (reference
`flowmap/model/model.py:41-110`). `FlowMapModel` owns every trainable
parameter under the JAX parameter tree's names (`backbone`, `intrinsics`,
`extrinsics`); `forward` is the per-step model function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..ops.geometry import sample_image_grid, unproject
from ..types import BackboneOutput, Batch, Flows, ModelOutput
from ..utils.device import resolve_device
from .backbone import BackboneCfg, init_backbone
from .extrinsics import ExtrinsicsCfg, ExtrinsicsParams, apply_extrinsics
from .intrinsics import (
    IntrinsicsCfg,
    IntrinsicsParams,
    IntrinsicsState,
    apply_intrinsics,
    init_intrinsics_state,
)


@dataclass(frozen=True)
class ModelCfg:
    backbone: BackboneCfg
    intrinsics: IntrinsicsCfg
    extrinsics: ExtrinsicsCfg
    use_correspondence_weights: bool = True


@dataclass
class ModelState:
    """Non-parameter state carried across steps."""

    intrinsics: IntrinsicsState


class FlowMapModel(nn.Module):
    def __init__(self, cfg: ModelCfg, num_frames=None, image_shape=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = init_backbone(cfg.backbone, num_frames, image_shape, generator)
        self.intrinsics = IntrinsicsParams(cfg.intrinsics)
        self.extrinsics = ExtrinsicsParams(cfg.extrinsics, num_frames)


def init_model(
    cfg: ModelCfg,
    seed: int = 0,
    num_frames: Optional[int] = None,
    image_shape: Optional[tuple[int, int]] = None,
    device: str | torch.device = "cuda",
) -> tuple[FlowMapModel, ModelState]:
    """Randomly initialised model (from `seed`) and its initial state."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    model = FlowMapModel(cfg, num_frames, image_shape, generator).to(device)
    return model, ModelState(intrinsics=init_intrinsics_state(cfg.intrinsics, device))


def forward(
    model: FlowMapModel,
    state: ModelState,
    batch: Batch,
    flows: Flows,
    step: int,
    intrinsics_indices: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = True,
) -> tuple[ModelOutput, ModelState]:
    cfg = model.cfg
    _, _, _, h, w = batch.videos.shape
    backbone_out = model.backbone(batch, flows)
    if not cfg.use_correspondence_weights:
        backbone_out = BackboneOutput(
            depths=backbone_out.depths, weights=torch.ones_like(backbone_out.weights)
        )
    intrinsics, new_intrinsics_state = apply_intrinsics(
        cfg.intrinsics, model.intrinsics, state.intrinsics, batch, flows,
        backbone_out, step, indices=intrinsics_indices, generator=generator,
        train=train,
    )
    xy, _ = sample_image_grid((h, w), batch.videos.device, batch.videos.dtype)
    surfaces = unproject(xy, backbone_out.depths, intrinsics[:, :, None, None])
    extrinsics = apply_extrinsics(
        cfg.extrinsics, model.extrinsics, flows, backbone_out, surfaces, generator
    )
    output = ModelOutput(
        depths=backbone_out.depths,
        surfaces=surfaces,
        intrinsics=intrinsics,
        extrinsics=extrinsics,
        backward_correspondence_weights=backbone_out.weights,
    )
    return output, ModelState(intrinsics=new_intrinsics_state)
