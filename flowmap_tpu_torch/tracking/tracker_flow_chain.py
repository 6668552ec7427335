"""Flow-chaining point tracker (no pretrained weights required).

Counterpart of `flowmap_tpu/tracking/tracker_flow_chain.py`. The reference's
tracking supervision comes from CoTracker: per segment, a query grid tracked
across a +-radius window with a visibility estimate. This module produces
the same (xy, visibility) supervision by chaining the precomputed
bidirectional optical flow:

- positions propagate frame to frame by bilinear-sampling the dense flow
  field at the current track position;
- visibility combines in-frame checks with forward/backward cycle
  consistency (||F_fwd(x) + F_bwd(x + F_fwd(x))|| below a threshold), the
  standard occlusion test.

It is precompute without gradients: a plain loop over hops under
`torch.no_grad()`, on the device of the flows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_points
from ..types import Batch, Flows, Tracks


@dataclass(frozen=True)
class TrackPredictorFlowChainCfg:
    name: Literal["flow_chain"] = "flow_chain"
    grid_size: int = 35
    cycle_threshold: float = 0.02  # normalized-coordinate cycle error
    min_visibility: float = 0.5


def _sample_flow(flow_field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample an (h, w, 2) flow field at (p, 2) points: (p, 2)."""
    out = grid_sample_points(flow_field.permute(2, 0, 1)[None], xy[None], padding_mode="border")
    return out[0].transpose(0, 1)


def _chain_direction(
    flows_ahead: torch.Tensor,  # (n, h, w, 2) flow to apply at hop i
    flows_return: torch.Tensor,  # (n, h, w, 2) reverse flow for the cycle check
    query: torch.Tensor,  # (p, 2)
    cycle_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain `query` through n hops: per-hop (positions, visibility)."""
    xy = query
    visible = torch.ones(query.shape[0], dtype=torch.bool, device=query.device)
    positions, visibility = [], []
    for fwd, bwd in zip(flows_ahead, flows_return):
        step = _sample_flow(fwd, xy)
        xy = xy + step
        # Following the reverse flow from the new position should return to
        # (approximately) the old one.
        back = _sample_flow(bwd, xy)
        cycle_error = torch.linalg.norm(step + back, dim=-1)
        in_frame = torch.all((xy >= 0.0) & (xy < 1.0), dim=-1)
        visible = visible & in_frame & (cycle_error < cycle_threshold)
        positions.append(xy)
        visibility.append(visible)
    return torch.stack(positions), torch.stack(visibility)


@torch.no_grad()
def chain_tracks_segment(
    flows: Flows,
    query: torch.Tensor,  # (p, 2)
    center: int,
    start: int,
    stop: int,
    cycle_threshold: float,
) -> Tracks:
    """Track `query` (on frame `center`) across [start, stop)."""
    p = query.shape[0]
    parts_xy, parts_vis = [], []

    # Backward chain: center -> center-1 -> ... -> start.
    if center - start > 0:
        ahead = torch.flip(flows.backward[0, start:center], dims=(0,))
        back = torch.flip(flows.forward[0, start:center], dims=(0,))
        pos_b, vis_b = _chain_direction(ahead, back, query, cycle_threshold)
        parts_xy.append(torch.flip(pos_b, dims=(0,)))
        parts_vis.append(torch.flip(vis_b, dims=(0,)))

    parts_xy.append(query[None])
    parts_vis.append(torch.ones((1, p), dtype=torch.bool, device=query.device))

    # Forward chain: center -> center+1 -> ... -> stop-1.
    if stop - 1 - center > 0:
        ahead = flows.forward[0, center : stop - 1]
        back = flows.backward[0, center : stop - 1]
        pos_f, vis_f = _chain_direction(ahead, back, query, cycle_threshold)
        parts_xy.append(pos_f)
        parts_vis.append(vis_f)

    return Tracks(
        xy=torch.cat(parts_xy)[None], visibility=torch.cat(parts_vis)[None], start_frame=start
    )


def generate_video_tracks_flow_chain(
    batch: Batch,
    flows: Flows,
    cfg: TrackPredictorFlowChainCfg,
    interval: int = 5,
    radius: int = 20,
) -> list[Tracks]:
    """Segment scheduling identical to the reference
    (`tracking/__init__.py:49-70`), with flow-chained tracks."""
    f = batch.videos.shape[1]
    g = (np.arange(cfg.grid_size) + 0.5) / cfg.grid_size
    query = torch.as_tensor(
        np.stack(np.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2).astype(np.float32)
    ).to(flows.forward.device)
    return [
        chain_tracks_segment(
            flows, query, center, max(center - radius, 0), min(center + radius + 1, f),
            cfg.cycle_threshold,
        )
        for center in range(0, f, interval)
    ]
