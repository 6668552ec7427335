"""Reprojection losses (flow consistency) and their weighted, gated sum.

Counterpart of `flowmap_tpu/loss/loss.py` (reference `loss/loss_flow.py`,
`loss/loss.py`). The flow loss with the huber mapping at model resolution
goes through `ops/kernels/flow_loss.py` (the CUDA kernel on a card, its plain
version on the CPU); other mappings use the plain form directly. The
tracking loss and its kernel are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence

import torch

from ..ops.kernels.flow_loss import flow_loss, flow_loss_plain
from ..types import Flows, ModelOutput
from .mapping import MappingCfg


@dataclass(frozen=True)
class LossFlowCfg:
    name: Literal["flow"] = "flow"
    enable_after: int = 0
    weight: float = 1000.0
    mapping: MappingCfg = field(default_factory=MappingCfg)


@dataclass(frozen=True)
class LossTrackingCfg:
    name: Literal["tracking"] = "tracking"
    enable_after: int = 50
    weight: float = 100.0
    mapping: MappingCfg = field(default_factory=MappingCfg)


LossCfg = LossFlowCfg | LossTrackingCfg


def loss_flow(
    cfg: LossFlowCfg,
    flows: Flows,
    model_output: ModelOutput,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Induced forward+backward flow vs observed flow, robustly mapped and
    masked (`loss_flow.py:31-70`)."""
    surfaces = model_output.surfaces
    if (
        cfg.mapping.name == "huber"
        and surfaces.shape[0] == 1
        and tuple(surfaces.shape[2:4]) == tuple(image_shape)
    ):
        loss_sum, valid_sum = flow_loss(
            surfaces, model_output.extrinsics, model_output.intrinsics, flows,
            image_shape, cfg.mapping.delta,
        )
    else:
        loss_sum, valid_sum = flow_loss_plain(
            surfaces, model_output.extrinsics, model_output.intrinsics, flows,
            image_shape, cfg.mapping,
        )
    return loss_sum / torch.clamp(valid_sum, min=1.0)


def compute_losses(
    cfgs: Sequence[LossCfg],
    flows: Flows,
    tracks: Optional[object],
    model_output: ModelOutput,
    step: int,
    image_shape: tuple[int, int],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted, gated sum of the enabled losses (`loss.py:31-47`)."""
    total = torch.zeros((), device=model_output.surfaces.device)
    individual: dict[str, torch.Tensor] = {}
    for cfg in cfgs:
        if isinstance(cfg, LossTrackingCfg):
            raise NotImplementedError(
                "the tracking loss (track_loss kernel and pack_tracks) is the "
                "next slice of the port; use loss=[LossFlowCfg()]"
            )
        if not isinstance(cfg, LossFlowCfg):
            raise ValueError(f"unknown loss cfg: {cfg}")
        value = loss_flow(cfg, flows, model_output, image_shape)
        gate = 1.0 if step >= cfg.enable_after else 0.0
        weighted = cfg.weight * gate * value
        individual[cfg.name] = weighted
        total = total + weighted
    return total, individual
