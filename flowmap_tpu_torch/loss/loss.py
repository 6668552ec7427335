"""Reprojection losses (flow and point-track consistency) and their
weighted, gated sum.

Counterpart of `flowmap_tpu/loss/loss.py` (reference `loss/loss_flow.py`,
`loss/loss_tracking.py`, `loss/loss.py`). With the huber mapping, batch 1
and surfaces at model resolution, the flow loss goes through
`ops/kernels/flow_loss.py` and the packed tracking loss through
`ops/kernels/track_loss.py` (the CUDA kernels on a card, their plain
versions on the CPU); other mappings, and a ragged list of track segments,
use the plain forms directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence

import torch

from ..ops.kernels.flow_loss import flow_loss, flow_loss_plain
from ..ops.kernels.track_loss import track_loss, track_loss_plain
from ..ops.surface import compute_track_flow
from ..types import Flows, ModelOutput, Tracks, TracksPacked
from .mapping import MappingCfg, apply_mapping


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


def _kernel_route(mapping: MappingCfg, surfaces: torch.Tensor, image_shape) -> bool:
    """What the loss kernels cover: the huber mapping, batch 1, surfaces at
    model resolution. Anything else takes the plain form, which is general."""
    return (
        mapping.name == "huber"
        and surfaces.shape[0] == 1
        and tuple(surfaces.shape[2:4]) == tuple(image_shape)
    )


def loss_flow(
    cfg: LossFlowCfg,
    flows: Flows,
    model_output: ModelOutput,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Induced forward+backward flow vs observed flow, robustly mapped and
    masked (`loss_flow.py:31-70`)."""
    surfaces = model_output.surfaces
    if _kernel_route(cfg.mapping, surfaces, image_shape):
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


def loss_tracking(
    cfg: LossTrackingCfg,
    tracks: Sequence[Tracks] | TracksPacked,
    model_output: ModelOutput,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Per track segment: all-pairs source->target reprojection error against
    the tracked locations, masked by joint visibility (`loss_tracking.py:28-61`).

    Takes a ragged segment list (reference semantics, one pass per segment)
    or a `TracksPacked` (uniform windows, all segments at once: the same
    loss)."""
    surfaces = model_output.surfaces
    if isinstance(tracks, TracksPacked):
        if _kernel_route(cfg.mapping, surfaces, image_shape):
            loss_sum, valid_sum = track_loss(
                surfaces, model_output.extrinsics, model_output.intrinsics, tracks,
                image_shape, cfg.mapping.delta,
            )
        else:
            loss_sum, valid_sum = track_loss_plain(
                surfaces, model_output.extrinsics, model_output.intrinsics, tracks,
                image_shape, cfg.mapping,
            )
        return loss_sum / torch.clamp(valid_sum, min=1.0)
    loss_sum = torch.zeros((), dtype=surfaces.dtype, device=surfaces.device)
    valid_sum = torch.zeros((), dtype=surfaces.dtype, device=surfaces.device)
    for segment in tracks:
        f = segment.xy.shape[1]
        s = segment.start_frame
        xy_target, visibility = compute_track_flow(
            surfaces[:, s : s + f],
            model_output.extrinsics[:, s : s + f],
            model_output.intrinsics[:, s : s + f],
            segment,
        )
        mapped = apply_mapping(cfg.mapping, xy_target, segment.xy[:, None], image_shape)
        loss_sum = loss_sum + torch.sum(mapped * visibility)
        valid_sum = valid_sum + torch.sum(visibility)
    return loss_sum / torch.clamp(valid_sum, min=1.0)


def compute_losses(
    cfgs: Sequence[LossCfg],
    flows: Flows,
    tracks: Optional[Sequence[Tracks] | TracksPacked],
    model_output: ModelOutput,
    step: int,
    image_shape: tuple[int, int],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted, gated sum of the enabled losses (`loss.py:31-47`)."""
    total = torch.zeros((), device=model_output.surfaces.device)
    individual: dict[str, torch.Tensor] = {}
    for cfg in cfgs:
        if isinstance(cfg, LossFlowCfg):
            value = loss_flow(cfg, flows, model_output, image_shape)
        elif isinstance(cfg, LossTrackingCfg):
            if tracks is None:
                raise ValueError("tracking loss requires tracks")
            if not isinstance(tracks, TracksPacked) and len(tracks) == 0:
                continue
            value = loss_tracking(cfg, tracks, model_output, image_shape)
        else:
            raise ValueError(f"unknown loss cfg: {cfg}")
        gate = 1.0 if step >= cfg.enable_after else 0.0
        weighted = cfg.weight * gate * value
        individual[cfg.name] = weighted
        total = total + weighted
    return total, individual
