"""Differentiable projective geometry (counterpart of `flowmap_tpu/ops/geometry.py`).

Conventions follow the reference: normalized image coordinates in [0, 1]
with half-pixel centers, intrinsics normalized by image size, extrinsics
camera-to-world. Rigid and pinhole inverses are closed-form; projection is
written componentwise, assuming K's last row is (0, 0, 1).
"""

from __future__ import annotations

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> (x, y, z, 1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def rigid_inverse(transformation: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform: [[R^T, -R^T t], [0, 1]]."""
    r_inv = transformation[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", r_inv, transformation[..., :3, 3])
    top = torch.cat([r_inv, t_inv[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = 1e-5,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective divide, then apply intrinsics (reference `projection.py:49-58`)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    denom = z + epsilon

    def nan(q):
        return torch.nan_to_num(q, nan=0.0, posinf=infinity, neginf=-infinity)

    xn, yn, zn = nan(x / denom), nan(y / denom), nan(z / denom)
    u = (
        intrinsics[..., 0, 0] * xn
        + intrinsics[..., 0, 1] * yn
        + intrinsics[..., 0, 2] * zn
    )
    v = (
        intrinsics[..., 1, 0] * xn
        + intrinsics[..., 1, 1] * yn
        + intrinsics[..., 1, 2] * zn
    )
    return torch.stack([u, v], dim=-1)


def unproject(
    coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Lift normalized 2D coordinates with depth z to camera-space points."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    rx = (coordinates[..., 0] - cx) / fx
    ry = (coordinates[..., 1] - cy) / fy
    return torch.stack([rx * z, ry * z, z], dim=-1)


def sample_image_grid(
    shape: tuple[int, int],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-pixel-centred (x, y) coordinates (h, w, 2) and (i, j) indices."""
    h, w = shape
    iy = torch.arange(h, device=device)
    ix = torch.arange(w, device=device)
    indices = torch.stack(torch.meshgrid(iy, ix, indexing="ij"), dim=-1)
    ys = (iy.to(dtype) + 0.5) / h
    xs = (ix.to(dtype) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1), indices


def reproject_points(
    xyz: torch.Tensor, relative: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Apply a relative camera transform to camera-space points, then project."""
    t = relative
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.stack(
        [
            t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2] * z + t[..., 0, 3],
            t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2] * z + t[..., 1, 3],
            t[..., 2, 0] * x + t[..., 2, 1] * y + t[..., 2, 2] * z + t[..., 2, 3],
        ],
        dim=-1,
    )
    return project_camera_space(out, intrinsics)


def earlier(x: torch.Tensor) -> torch.Tensor:
    """Frames [0, f-1) along axis 1."""
    return x[:, :-1]


def later(x: torch.Tensor) -> torch.Tensor:
    """Frames [1, f) along axis 1."""
    return x[:, 1:]


def _expand_for_grid(x: torch.Tensor, grid_ndim: int) -> torch.Tensor:
    for _ in range(grid_ndim):
        x = x[:, :, None]
    return x


def compute_forward_flow(
    surfaces: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Earlier-frame surface points seen from the later frame (b, p, h, w, 2)."""
    transformation = rigid_inverse(later(extrinsics)) @ earlier(extrinsics)
    grid_ndim = surfaces.ndim - 3
    return reproject_points(
        earlier(surfaces),
        _expand_for_grid(transformation, grid_ndim),
        _expand_for_grid(later(intrinsics), grid_ndim),
    )


def compute_backward_flow(
    surfaces: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Later-frame surface points seen from the earlier frame (b, p, h, w, 2)."""
    transformation = rigid_inverse(earlier(extrinsics)) @ later(extrinsics)
    grid_ndim = surfaces.ndim - 3
    return reproject_points(
        later(surfaces),
        _expand_for_grid(transformation, grid_ndim),
        _expand_for_grid(earlier(intrinsics), grid_ndim),
    )


def get_extrinsics(inverse_relative_transformations: torch.Tensor) -> torch.Tensor:
    """Compose per-pair transforms into poses (P_0 = I) by a prefix product.

    T_i maps frame i+1's camera space into frame i's, so
    P_n = T_0 @ T_1 @ ... @ T_{n-1}. The JAX package uses an
    `associative_scan`; here it is the log-depth Hillis-Steele scan over the
    pair axis (axis -3): ceil(log2(p)) batched 4x4 products.
    """
    x = inverse_relative_transformations
    p = x.shape[-3]
    offset = 1
    while offset < p:
        x = torch.cat(
            [x[..., :offset, :, :], x[..., :-offset, :, :] @ x[..., offset:, :, :]],
            dim=-3,
        )
        offset *= 2
    eye = torch.eye(4, dtype=x.dtype, device=x.device)
    identity = eye.expand(*x.shape[:-3], 1, 4, 4)
    return torch.cat([identity, x], dim=-3)


def focal_lengths_to_intrinsics(
    focal_lengths: torch.Tensor, image_shape: tuple[int, int]
) -> torch.Tensor:
    """Normalized focal length(s) -> normalized K (reference `intrinsics/common.py`)."""
    h, w = image_shape
    focal_lengths = focal_lengths * (h * w) ** 0.5
    fx = focal_lengths / w
    fy = focal_lengths / h
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    half = torch.full_like(fx, 0.5)
    return torch.stack(
        [
            torch.stack([fx, zero, half], dim=-1),
            torch.stack([zero, fy, half], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
