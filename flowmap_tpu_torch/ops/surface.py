"""Surface alignment and track reprojection, the pose-from-depth core.

Counterpart of `flowmap_tpu/ops/surface.py` (reference
`projection.py:213-298`): `align_surfaces` (single-device: the JAX package's
explicit frame-sharded collectives branch has no counterpart here),
`compute_track_flow` for one ragged segment, and the packed forms over all
segments at once.
"""

from __future__ import annotations

import torch

from ..types import Tracks, TracksPacked
from .geometry import (
    earlier,
    get_extrinsics,
    later,
    reproject_points,
    rigid_inverse,
    sample_image_grid,
)
from .grid_sample import bilinear_onehot_weights, grid_sample_points
from .procrustes import align_rigid


def align_surfaces(
    surfaces: torch.Tensor,  # (b, f, h, w, 3)
    backward_flows: torch.Tensor,  # (b, p, h, w, 2)
    backward_weights: torch.Tensor,  # (b, p, h, w)
    indices: torch.Tensor,  # (k,) flat pixel indices
) -> torch.Tensor:  # (b, f, 4, 4)
    """Align each adjacent pair's surfaces at `indices`, then chain the poses."""
    b, f, h, w, _ = surfaces.shape
    xy, _ = sample_image_grid((h, w), surfaces.device, surfaces.dtype)
    k = indices.shape[0]

    xyz_later = later(surfaces).reshape(b, f - 1, h * w, 3)[:, :, indices]
    xy_earlier = (xy + backward_flows).reshape(b, f - 1, h * w, 2)[:, :, indices]
    xyz_earlier = grid_sample_points(
        earlier(surfaces).reshape(b * (f - 1), h, w, 3).permute(0, 3, 1, 2),
        xy_earlier.reshape(b * (f - 1), k, 2),
        padding_mode="border",
    )
    xyz_earlier = xyz_earlier.permute(0, 2, 1).reshape(b, f - 1, k, 3)

    weights = backward_weights.reshape(b, f - 1, h * w)[..., indices]
    return get_extrinsics(align_rigid(xyz_later, xyz_earlier, weights))


def compute_track_flow(
    surfaces: torch.Tensor,  # (b, f, h, w, 3)
    extrinsics: torch.Tensor,  # (b, f, 4, 4)
    intrinsics: torch.Tensor,  # (b, f, 3, 3)
    tracks: Tracks,
) -> tuple[torch.Tensor, torch.Tensor]:  # (b, fs, ft, p, 2), (b, fs, ft, p) bool
    """Reproject track-sampled surface points from every source frame into
    every target frame, with the joint visibility / in-frame mask
    (reference `projection.py:255-298`)."""
    b, f, h, w, _ = surfaces.shape
    p = tracks.xy.shape[2]
    xyz = grid_sample_points(
        surfaces.reshape(b * f, h, w, 3).permute(0, 3, 1, 2),
        tracks.xy.reshape(b * f, p, 2),
        padding_mode="border",
    )
    xyz = xyz.permute(0, 2, 1).reshape(b, f, p, 3)

    # Broadcast layout: (b, fs, ft, p, ...).
    xy_source = tracks.xy[:, :, None]
    relative = rigid_inverse(extrinsics)[:, None, :, None] @ extrinsics[:, :, None, None]
    xy_target = reproject_points(xyz[:, :, None], relative, intrinsics[:, None, :, None])
    visibility = tracks.visibility[:, :, None] & tracks.visibility[:, None]
    source_in = torch.all(xy_source >= 0, dim=-1) & torch.all(xy_source < 1, dim=-1)
    target_in = torch.all(xy_target >= 0, dim=-1) & torch.all(xy_target < 1, dim=-1)
    return xy_target, visibility & source_in & target_in


def sample_track_points_packed(
    surfaces: torch.Tensor,  # (1, f, h, w, 3)
    packed: TracksPacked,
) -> tuple[torch.Tensor, torch.Tensor]:  # (s, l, p, 3), (s, l)
    """Bilinear-sample the surfaces at every packed track location (border
    padding), in the JAX package's form: one whole-frame gather per window
    slot and separable one-hot weight contractions, whose backward needs no
    scatter. This is the plain version's sampling; the track-loss kernel
    gathers the four corners directly."""
    b, f, h, w, _ = surfaces.shape
    if b != 1:
        raise ValueError("packed track flow supports batch size 1")
    frame_idx = packed.frame_index()
    x = packed.xy[0, ..., 0] * w - 0.5  # (s, l, p)
    y = packed.xy[0, ..., 1] * h - 0.5
    wx = bilinear_onehot_weights(x, w, "border", surfaces.dtype)  # (s, l, p, w)
    wy = bilinear_onehot_weights(y, h, "border", surfaces.dtype)  # (s, l, p, h)
    seg_surfaces = surfaces[0][frame_idx]  # (s, l, h, w, 3)
    rows = torch.einsum("slpx,slyxc->slpyc", wx, seg_surfaces)
    xyz = torch.einsum("slpy,slpyc->slpc", wy, rows)
    return xyz, frame_idx


def compute_track_flow_packed(
    surfaces: torch.Tensor,  # (1, f, h, w, 3)
    extrinsics: torch.Tensor,  # (1, f, 4, 4)
    intrinsics: torch.Tensor,  # (1, f, 3, 3)
    packed: TracksPacked,
) -> tuple[torch.Tensor, torch.Tensor]:  # (1, s, fs, ft, p, 2), (1, s, fs, ft, p) bool
    """`compute_track_flow` over all packed segments at once."""
    xyz, frame_idx = sample_track_points_packed(surfaces, packed)
    seg_extrinsics = extrinsics[0][frame_idx]  # (s, l, 4, 4)
    seg_intrinsics = intrinsics[0][frame_idx]  # (s, l, 3, 3)
    relative = torch.einsum(
        "stij,sfjk->sftik", rigid_inverse(seg_extrinsics), seg_extrinsics
    )  # source-frame (f) camera space into target-frame (t) space
    xy_target = reproject_points(
        xyz[:, :, None], relative[..., None, :, :], seg_intrinsics[:, None, :, None]
    )  # (s, fs, ft, p, 2)

    visibility = packed.visibility[0]
    joint = visibility[:, :, None] & visibility[:, None]
    xy_source = packed.xy[0][:, :, None]
    source_in = torch.all(xy_source >= 0, dim=-1) & torch.all(xy_source < 1, dim=-1)
    target_in = torch.all(xy_target >= 0, dim=-1) & torch.all(xy_target < 1, dim=-1)
    return xy_target[None], (joint & source_in & target_in)[None]
