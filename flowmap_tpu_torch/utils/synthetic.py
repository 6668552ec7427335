"""Synthetic rigid scene for tests and chip runs (NumPy math, torch outputs).

Counterpart of `flowmap_tpu/utils/synthetic.py:make_scene`, with its own
copy of the NumPy helpers: a piecewise-planar world, a smooth camera arc and
ground-truth intrinsics; per-frame depth from closed-form ray/plane
intersection, and the exact pose/depth-induced flow as the observed flow.
The scene is built on the host and returned as tensors on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..types import Batch, Flows
from .device import resolve_device


@dataclass(frozen=True)
class SyntheticSceneCfg:
    num_frames: int = 20
    image_shape: tuple[int, int] = (96, 128)
    focal_length: float = 1.1  # normalized (sqrt(hw) convention)
    seed: int = 0


def _np_grid(h: int, w: int) -> np.ndarray:
    x = (np.arange(w) + 0.5) / w
    y = (np.arange(h) + 0.5) / h
    return np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1).astype(np.float32)


def _np_k(focal: float, h: int, w: int) -> np.ndarray:
    scale = (h * w) ** 0.5
    return np.array(
        [[focal * scale / w, 0, 0.5], [0, focal * scale / h, 0.5], [0, 0, 1.0]],
        np.float32,
    )


def _np_unproject(xy: np.ndarray, z: np.ndarray, k: np.ndarray) -> np.ndarray:
    ones = np.ones_like(xy[..., :1])
    rays = np.einsum("ij,...j->...i", np.linalg.inv(k), np.concatenate([xy, ones], -1))
    return rays * z[..., None]


def _np_rigid_inverse(t: np.ndarray) -> np.ndarray:
    out = np.broadcast_to(np.eye(4, dtype=t.dtype), t.shape).copy()
    r_t = np.swapaxes(t[..., :3, :3], -1, -2)
    out[..., :3, :3] = r_t
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", r_t, t[..., :3, 3])
    return out


def _np_project_cam(points: np.ndarray, k: np.ndarray) -> np.ndarray:
    points = points / (points[..., -1:] + 1e-5)
    return np.einsum("...ij,...j->...i", k, points)[..., :2]


def _np_reproject(xyz: np.ndarray, relative: np.ndarray, k: np.ndarray) -> np.ndarray:
    ones = np.ones_like(xyz[..., :1])
    cam = np.einsum("...ij,...j->...i", relative, np.concatenate([xyz, ones], -1))[..., :3]
    return _np_project_cam(cam, k)


def _camera_trajectory(num_frames: int) -> np.ndarray:
    """Smooth forward-and-sideways arc with mild rotation (c2w, OpenCV)."""
    poses = np.zeros((num_frames, 4, 4), np.float32)
    for i, t in enumerate(np.linspace(0.0, 1.0, num_frames)):
        yaw = 0.3 * np.sin(2 * np.pi * t * 0.5)
        pitch = 0.1 * np.sin(2 * np.pi * t * 0.3)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        poses[i, :3, :3] = ry @ rx
        poses[i, :3, 3] = [0.8 * np.sin(np.pi * t), 0.2 * t, 0.9 * t]
        poses[i, 3, 3] = 1.0
    return poses


_PLANES = [
    (np.array([0.0, 1.0, 0.0]), 2.0),  # floor (y down = +)
    (np.array([1.0, 0.0, 0.2]), 4.0),  # right wall
    (np.array([-1.0, 0.0, 0.2]), 4.0),  # left wall
    (np.array([0.0, 0.0, 1.0]), 8.0),  # back wall
]


def _plane_depths(xy: np.ndarray, k: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Per-pixel depth as the nearest positive ray/plane intersection (f, h, w)."""
    ones = np.ones_like(xy[..., :1])
    rays_cam = np.einsum("ij,hwj->hwi", np.linalg.inv(k), np.concatenate([xy, ones], -1))
    rays_world = np.einsum("fij,hwj->fhwi", poses[:, :3, :3], rays_cam)
    t = poses[:, :3, 3]
    best = np.full((poses.shape[0], *xy.shape[:2]), np.inf, np.float32)
    for normal, offset in _PLANES:
        denom = np.einsum("fhwi,i->fhw", rays_world, normal)
        numer = offset - t @ normal
        z = numer[:, None, None] / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
        z = np.where((z > 0.05) & (np.abs(denom) >= 1e-6), z, np.inf)
        best = np.minimum(best, z)
    return np.where(np.isfinite(best), best, 50.0).astype(np.float32)


def make_scene_arrays(cfg: SyntheticSceneCfg) -> dict[str, np.ndarray]:
    """The scene as NumPy arrays (videos, extrinsics, intrinsics, flows, masks, depths)."""
    f = cfg.num_frames
    h, w = cfg.image_shape
    poses = _camera_trajectory(f)
    k = _np_k(cfg.focal_length, h, w)
    xy = _np_grid(h, w)
    depths = _plane_depths(xy, k, poses)[None]  # (1, f, h, w)
    surfaces = _np_unproject(xy, depths, k)  # (1, f, h, w, 3)

    inv = _np_rigid_inverse(poses)
    fwd_rel = np.einsum("fij,fjk->fik", inv[1:], poses[:-1])
    bwd_rel = np.einsum("fij,fjk->fik", inv[:-1], poses[1:])
    flow_fwd = _np_reproject(surfaces[:, :-1], fwd_rel[None, :, None, None], k) - xy
    flow_bwd = _np_reproject(surfaces[:, 1:], bwd_rel[None, :, None, None], k) - xy

    def in_frame_mask(flowed):
        return (np.all(flowed >= 0.0, axis=-1) & np.all(flowed < 1.0, axis=-1)).astype(np.float32)

    u = np.linspace(0, 8 * np.pi, w)
    v = np.linspace(0, 8 * np.pi, h)
    tex = 0.5 + 0.25 * (np.sin(u)[None, :] + np.cos(v)[:, None])
    videos = np.broadcast_to(tex.astype(np.float32)[None, None, None], (1, f, 3, h, w))
    return {
        "videos": np.ascontiguousarray(videos),
        "indices": np.arange(f)[None],
        "extrinsics": poses[None],
        "intrinsics": np.ascontiguousarray(np.broadcast_to(k, (1, f, 3, 3))),
        "forward": flow_fwd.astype(np.float32),
        "backward": flow_bwd.astype(np.float32),
        "forward_mask": in_frame_mask(flow_fwd + xy),
        "backward_mask": in_frame_mask(flow_bwd + xy),
        "depths": depths,
    }


def make_scene(
    cfg: SyntheticSceneCfg, device: str | torch.device = "cuda"
) -> tuple[Batch, Flows, torch.Tensor]:
    """(batch with GT cameras, exact flows, GT depths (1, f, h, w)) on `device`."""
    device = resolve_device(device)
    a = {k: torch.as_tensor(v).to(device) for k, v in make_scene_arrays(cfg).items()}
    batch = Batch(
        videos=a["videos"], indices=a["indices"], extrinsics=a["extrinsics"],
        intrinsics=a["intrinsics"], scenes=("synthetic",), datasets=("synthetic",),
    )
    flows = Flows(
        forward=a["forward"], backward=a["backward"],
        forward_mask=a["forward_mask"], backward_mask=a["backward_mask"],
    )
    return batch, flows, a["depths"]
