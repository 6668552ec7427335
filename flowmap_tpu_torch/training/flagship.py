"""The bench's flagship configuration as the port runs it (`bench.py:93-104`).

A 150-frame 160x224 synthetic scene; MiDaS-small with folded BN, the exp
depth mapping and a bf16 compute dtype; softmin intrinsics that regress
after step 1000 over a 100-step window; Procrustes extrinsics over 1000
points; the warp radii autosized from the scene's flows; the flow and
tracking losses, with exact tracks in the reference's segment structure
(every 5 frames a 35x35 grid over +-20 frames) packed to uniform windows.
`chip_smoke.py` and `scripts/torch_step_profile.py` both drive it.

`source_video` and `precompute` are the product's path to those inputs
(`flowmap_tpu/overfit.py:66-81`): a 150-frame 640x896 source video, the
crops of `configs/overfit.yaml` (43200 pixels, flow at 4x, patches of 32: a
160x224 model batch and a 640x896 flow batch), GMFlow flows in both
directions with their consistency masks, and flow-chained tracks in place of
the scene's exact ones.
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
from ..flow.predictors import FlowPredictorCfg, FlowPredictorGMFlowCfg, compute_flows
from ..loss.loss import LossCfg, LossFlowCfg, LossTrackingCfg
from ..tracking.tracker_flow_chain import TrackPredictorFlowChainCfg
from ..tracking.tracking import TrackPrecomputationCfg, compute_tracks, pack_tracks
from ..types import Batch, Flows, TracksPacked
from ..utils.cropping import (
    CroppingCfg,
    crop_and_resize_batch_for_flow,
    crop_and_resize_batch_for_model,
)
from ..utils.synthetic import SyntheticSceneCfg, make_scene, make_track_segments, make_video
from .overfit import _autosize_warp_radius

NUM_FRAMES = 150
IMAGE_SHAPE = (160, 224)
SOURCE_SHAPE = (640, 896)


def scene(
    device: str | torch.device = "cuda",
    num_frames: int = NUM_FRAMES,
    image_shape: tuple[int, int] = IMAGE_SHAPE,
) -> tuple[Batch, Flows, torch.Tensor]:
    """(batch, flows, GT depths) of the synthetic scene, on `device`."""
    return make_scene(SyntheticSceneCfg(num_frames=num_frames, image_shape=image_shape), device)


def source_video(
    device: str | torch.device = "cuda",
    num_frames: int = NUM_FRAMES,
    image_shape: tuple[int, int] = SOURCE_SHAPE,
) -> Batch:
    """The synthetic scene's video at the source resolution, on `device`."""
    return make_video(SyntheticSceneCfg(num_frames=num_frames, image_shape=image_shape), device)


def precompute(
    video_batch: Batch,
    cropping: CroppingCfg = CroppingCfg(),
    flow: FlowPredictorCfg = FlowPredictorGMFlowCfg(),
    tracking: TrackPredictorFlowChainCfg = TrackPredictorFlowChainCfg(),
    track_precomputation: TrackPrecomputationCfg = TrackPrecomputationCfg(),
) -> tuple[Batch, Flows, TracksPacked]:
    """From a full-resolution video to the train step's inputs, on the
    video's device: (model batch, flows at the model resolution, packed
    tracks chained through those flows)."""
    batch, _ = crop_and_resize_batch_for_model(video_batch, cropping)
    batch_for_flow = crop_and_resize_batch_for_flow(video_batch, cropping)
    _, f, _, h, w = batch.videos.shape
    flows = compute_flows(batch_for_flow, (h, w), flow)
    segments = compute_tracks(batch_for_flow, tracking, track_precomputation, flows=flows)
    return batch, flows, pack_tracks(segments, f)


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
    flows: Flows,
    compute_dtype: str = "bfloat16",
    warp_impl: str = "fused",
    weights_resolution: str = "native",
    fused_weight_mlp: bool = False,
) -> ModelCfg:
    """The flagship model with its warp radii sized from `flows`. `warp_impl`
    "pallas" takes the bounded-radius warp kernel at any radius, which
    "fused" takes only when the shift-warp's tap window exceeds 256.
    `weights_resolution="full"` is the reference's formulation (with "fused"
    and a full-resolution radius of at most 6, the corr-weights kernel);
    `fused_weight_mlp` runs the native path's MLP as one kernel."""
    cfg = ModelCfg(
        backbone=BackboneMidasCfg(
            mapping="exp", bn="folded", compute_dtype=compute_dtype, warp_impl=warp_impl,
            weights_resolution=weights_resolution, fused_weight_mlp=fused_weight_mlp,
        ),
        intrinsics=IntrinsicsSoftminCfg(regression=RegressionCfg(after_step=1000, window=100)),
        extrinsics=ExtrinsicsProcrustesCfg(num_points=1000),
    )
    return _autosize_warp_radius(cfg, flows, flows.backward.shape[-3])
