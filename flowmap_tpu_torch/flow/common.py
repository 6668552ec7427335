"""Bidirectional flow machinery shared by the flow predictors.

Counterpart of `flowmap_tpu/flow/common.py` (reference
`flowmap/flow/flow_predictor.py:39-103`): the photometric consistency mask
((1 - max |delta rgb|)^8 through a flow-displaced sample of the next frame),
bilinear rescaling of flows and masks to the model resolution, and the
bidirectional compute (the predictor on the video and on its time reversal).
Everything here is supervision, made once per scene without gradients, on
the device of the batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.geometry import sample_image_grid
from ..ops.kernels.dense_warp import dense_warp_bilinear_planar
from ..ops.resize import resize_bilinear
from ..types import Batch, Flows


def rescale_flow(flow: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(b, p, h, w, 2) normalised flow to (b, p, *shape, 2)."""
    b, p, h, w, _ = flow.shape
    out = resize_bilinear(flow.reshape(b * p, h, w, 2).permute(0, 3, 1, 2), shape)
    return out.permute(0, 2, 3, 1).reshape(b, p, *shape, 2)


def rescale_mask(mask: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(b, p, h, w) mask to (b, p, *shape)."""
    b, p, h, w = mask.shape
    return resize_bilinear(mask.reshape(b * p, 1, h, w), shape).reshape(b, p, *shape)


@torch.no_grad()
def compute_consistency_mask(
    videos: torch.Tensor,  # (b, f, 3, h, w)
    flow: torch.Tensor,  # (b, f - 1, h, w, 2) normalised
    warp_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # (b, f - 1, h, w)
    """Photometric-consistency weight: sample the next frame at the
    flow-displaced positions (outside the image it is black) and compare
    colours, (1 - max channel delta)^8. `warp_dtype` is the dense warp's
    compute dtype: bfloat16 where the flow itself came from a bfloat16 net."""
    b, f, c, h, w = videos.shape
    source = videos[:, :-1].reshape(b * (f - 1), c, h, w)
    target = videos[:, 1:].reshape(b * (f - 1), c, h, w)
    source_xy, _ = sample_image_grid((h, w), videos.device)
    flow_pairs = flow.reshape(b * (f - 1), h, w, 2)
    px = (source_xy[..., 0] + flow_pairs[..., 0]) * w - 0.5
    py = (source_xy[..., 1] + flow_pairs[..., 1]) * h - 0.5
    target_pixels = dense_warp_bilinear_planar(target, px, py, "zeros", warp_dtype)
    deltas = (source - target_pixels).abs().amax(dim=1)
    return ((1.0 - deltas) ** 8).reshape(b, f - 1, h, w)


@torch.no_grad()
def compute_bidirectional_flow(
    predict: Callable[[torch.Tensor], torch.Tensor],
    batch: Batch,
    flow_shape: tuple[int, int],
    mask_warp_dtype: Optional[torch.dtype] = None,
) -> Flows:
    """Run `predict` ((b, f, 3, h, w) -> (b, f - 1, h, w, 2)) on the video
    and on its time reversal; mask, rescale to `flow_shape`, and flip the
    backward results back into forward time. `mask_warp_dtype` defaults to
    the predictor's own `compute_dtype` where it has one, else float32."""
    if mask_warp_dtype is None:
        owner = getattr(predict, "__self__", None)
        mask_warp_dtype = (
            getattr(predict, "compute_dtype", None)
            or getattr(owner, "compute_dtype", None)
            or torch.float32
        )

    def one_direction(videos: torch.Tensor):
        flow = predict(videos)
        mask = compute_consistency_mask(videos, flow, mask_warp_dtype)
        return rescale_flow(flow, flow_shape), rescale_mask(mask, flow_shape)

    forward, forward_mask = one_direction(batch.videos)
    backward, backward_mask = one_direction(torch.flip(batch.videos, dims=(1,)))
    return Flows(
        forward=forward,
        backward=torch.flip(backward, dims=(1,)),
        forward_mask=forward_mask,
        backward_mask=torch.flip(backward_mask, dims=(1,)),
    )
