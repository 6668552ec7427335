"""The bench's flagship configuration as the port runs it (`bench.py:93-104`).

A 150-frame 160x224 synthetic scene; MiDaS-small with folded BN, the exp
depth mapping and a bf16 compute dtype; softmin intrinsics that regress
after step 1000 over a 100-step window; Procrustes extrinsics over 1000
points; the warp radii autosized from the scene's flows; the flow and
tracking losses, with exact tracks in the reference's segment structure
(every 5 frames a 35x35 grid over +-20 frames) packed to uniform windows.
`chip_smoke.py` and `scripts/torch_step_profile.py` both drive it.
"""

from __future__ import annotations

import torch

from ..model import (
    BackboneMidasCfg,
    ExtrinsicsProcrustesCfg,
    IntrinsicsSoftminCfg,
    ModelCfg,
    RegressionCfg,
)
from ..loss.loss import LossCfg, LossFlowCfg, LossTrackingCfg
from ..tracking.tracking import pack_tracks
from ..types import Batch, Flows, TracksPacked
from ..utils.synthetic import SyntheticSceneCfg, make_scene, make_track_segments
from .overfit import _autosize_warp_radius

NUM_FRAMES = 150
IMAGE_SHAPE = (160, 224)


def scene(
    device: str | torch.device = "cuda",
    num_frames: int = NUM_FRAMES,
    image_shape: tuple[int, int] = IMAGE_SHAPE,
) -> tuple[Batch, Flows, torch.Tensor]:
    """(batch, flows, GT depths) of the synthetic scene, on `device`."""
    return make_scene(SyntheticSceneCfg(num_frames=num_frames, image_shape=image_shape), device)


def tracks(
    batch: Batch,
    depths: torch.Tensor,
    interval: int = 5,
    radius: int = 20,
    grid_size: int = 35,
) -> TracksPacked:
    """The scene's exact tracks, packed, on the device of `batch`."""
    segments = make_track_segments(batch, depths, interval, radius, grid_size)
    return pack_tracks(segments, batch.videos.shape[1])


def loss_cfgs(tracking_after: int = 50) -> list[LossCfg]:
    """The bench's loss set: flow, and tracking from step `tracking_after`."""
    return [LossFlowCfg(), LossTrackingCfg(enable_after=tracking_after)]


def model_cfg(
    flows: Flows, compute_dtype: str = "bfloat16", warp_impl: str = "fused"
) -> ModelCfg:
    """The flagship model with its warp radii sized from `flows`. `warp_impl`
    "pallas" takes the bounded-radius warp kernel at any radius, which
    "fused" takes only when the shift-warp's tap window exceeds 256."""
    cfg = ModelCfg(
        backbone=BackboneMidasCfg(
            mapping="exp", bn="folded", compute_dtype=compute_dtype, warp_impl=warp_impl
        ),
        intrinsics=IntrinsicsSoftminCfg(regression=RegressionCfg(after_step=1000, window=100)),
        extrinsics=ExtrinsicsProcrustesCfg(num_points=1000),
    )
    return _autosize_warp_radius(cfg, flows, flows.backward.shape[-3])
