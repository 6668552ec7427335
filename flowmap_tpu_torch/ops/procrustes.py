"""Weighted rigid (Kabsch, no scale) alignment with Horn's quaternion method.

Counterpart of `flowmap_tpu/ops/procrustes.py`. The rotation is the top
eigenvector of Horn's symmetric 4x4 matrix, found by normalized repeated
squaring, so the graph (and its gradient) is the JAX package's, not that of
an SVD.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _horn_k_matrix(m: torch.Tensor) -> torch.Tensor:
    """Symmetric 4x4 K with q^T K q = tr(R(q)^T M) for unit quaternions q."""
    sigma = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    z0 = m[..., 2, 1] - m[..., 1, 2]
    z1 = m[..., 0, 2] - m[..., 2, 0]
    z2 = m[..., 1, 0] - m[..., 0, 1]
    s = m + m.transpose(-1, -2)
    rows = [
        [sigma, z0, z1, z2],
        [z0, s[..., 0, 0] - sigma, s[..., 0, 1], s[..., 0, 2]],
        [z1, s[..., 1, 0], s[..., 1, 1] - sigma, s[..., 1, 2]],
        [z2, s[..., 2, 0], s[..., 2, 1], s[..., 2, 2] - sigma],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def top_eigenvector_4x4(k: torch.Tensor, num_squarings: int = 10) -> torch.Tensor:
    """Dominant eigenvector of a symmetric 4x4 by normalized repeated squaring."""
    fro = torch.sqrt(torch.sum(k * k, dim=(-2, -1), keepdim=True)) + _EPS
    a = k / fro + 2.0 * torch.eye(4, dtype=k.dtype, device=k.device)
    for _ in range(num_squarings):
        a = a @ a
        a = a / (torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True)) + _EPS)
    col_norms = torch.sum(a * a, dim=-2)
    best = torch.argmax(col_norms, dim=-1)
    v = torch.gather(a, -1, best[..., None, None].expand(*a.shape[:-1], 1))[..., 0]
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)


def align_rigid(
    p: torch.Tensor,  # (*b, n, 3)
    q: torch.Tensor,  # (*b, n, 3)
    weights: torch.Tensor,  # (*b, n)
) -> torch.Tensor:  # (*b, 4, 4)
    """Weighted rigid transform T with T(p) ~= q (least squares)."""
    weights_normalized = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-8)
    p_centroid = torch.sum(weights_normalized[..., None] * p, dim=-2)
    q_centroid = torch.sum(weights_normalized[..., None] * q, dim=-2)
    p_centered = p - p_centroid[..., None, :]
    q_centered = q - q_centroid[..., None, :]
    m = torch.einsum("...ni,...nj->...ij", q_centered * weights[..., None], p_centered)

    rotation = quaternion_to_matrix(top_eigenvector_4x4(_horn_k_matrix(m)))
    translation = q_centroid - torch.einsum("...ij,...j->...i", rotation, p_centroid)
    top = torch.cat([rotation, translation[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
