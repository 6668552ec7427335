"""Pose from depth: Procrustes alignment of flow-corresponded surfaces.

Counterpart of `flowmap_tpu/ops/surface.py:align_surfaces` (reference
`projection.py:213-252`), single-device: the JAX package's explicit
frame-sharded collectives branch has no counterpart here.
"""

from __future__ import annotations

import torch

from .geometry import earlier, get_extrinsics, later, sample_image_grid
from .grid_sample import grid_sample_points
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
