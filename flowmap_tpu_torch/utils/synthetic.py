"""Synthetic rigid scene for tests and chip runs (NumPy math, torch outputs).

Counterpart of `flowmap_tpu/utils/synthetic.py` (`make_scene`,
`make_track_segments`, `make_tracks`), with its own copy of the NumPy
helpers: a piecewise-planar world, a smooth camera arc and
ground-truth intrinsics; per-frame depth from closed-form ray/plane
intersection, and the exact pose/depth-induced flow as the observed flow.
The scene is built on the host and returned as tensors on `device`. The
exact point tracks come from the same geometry, in the reference's segment
structure, on the device of the batch they are made from.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..types import Batch, Flows, Tracks
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


def make_video_arrays(cfg: SyntheticSceneCfg) -> dict[str, np.ndarray]:
    """The scene's video and ground-truth cameras alone (videos, indices,
    extrinsics, intrinsics): what a source video at a large shape needs,
    without the per-pixel geometry."""
    f = cfg.num_frames
    h, w = cfg.image_shape
    u = np.linspace(0, 8 * np.pi, w)
    v = np.linspace(0, 8 * np.pi, h)
    tex = 0.5 + 0.25 * (np.sin(u)[None, :] + np.cos(v)[:, None])
    videos = np.broadcast_to(tex.astype(np.float32)[None, None, None], (1, f, 3, h, w))
    k = _np_k(cfg.focal_length, h, w)
    return {
        "videos": np.ascontiguousarray(videos),
        "indices": np.arange(f)[None],
        "extrinsics": _camera_trajectory(f)[None],
        "intrinsics": np.ascontiguousarray(np.broadcast_to(k, (1, f, 3, 3))),
    }


def make_scene_arrays(cfg: SyntheticSceneCfg) -> dict[str, np.ndarray]:
    """The scene as NumPy arrays (videos, extrinsics, intrinsics, flows, masks, depths)."""
    h, w = cfg.image_shape
    video = make_video_arrays(cfg)
    poses = video["extrinsics"][0]
    k = video["intrinsics"][0, 0]
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

    return {
        **video,
        "forward": flow_fwd.astype(np.float32),
        "backward": flow_bwd.astype(np.float32),
        "forward_mask": in_frame_mask(flow_fwd + xy),
        "backward_mask": in_frame_mask(flow_bwd + xy),
        "depths": depths,
    }


def _as_batch(a: dict[str, torch.Tensor]) -> Batch:
    return Batch(
        videos=a["videos"], indices=a["indices"], extrinsics=a["extrinsics"],
        intrinsics=a["intrinsics"], scenes=("synthetic",), datasets=("synthetic",),
    )


def make_video(cfg: SyntheticSceneCfg, device: str | torch.device = "cuda") -> Batch:
    """The scene's video with its ground-truth cameras on `device`, at any
    shape: no flows and no depths are made."""
    device = resolve_device(device)
    return _as_batch({k: torch.as_tensor(v).to(device) for k, v in make_video_arrays(cfg).items()})


def make_scene(
    cfg: SyntheticSceneCfg, device: str | torch.device = "cuda"
) -> tuple[Batch, Flows, torch.Tensor]:
    """(batch with GT cameras, exact flows, GT depths (1, f, h, w)) on `device`."""
    device = resolve_device(device)
    a = {k: torch.as_tensor(v).to(device) for k, v in make_scene_arrays(cfg).items()}
    batch = _as_batch(a)
    flows = Flows(
        forward=a["forward"], backward=a["backward"],
        forward_mask=a["forward_mask"], backward_mask=a["backward_mask"],
    )
    return batch, flows, a["depths"]


def _np_grid_sample_points(
    images: np.ndarray,  # (n, c, h, w)
    xy: np.ndarray,  # (n, p, 2) normalized [0, 1]
) -> np.ndarray:
    """Border-padded bilinear sampling (NumPy mirror of grid_sample_points)."""
    n, c, h, w = images.shape
    x = xy[..., 0] * w - 0.5
    y = xy[..., 1] * h - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    flat = images.reshape(n, c, h * w)

    def gather(yi, xi):
        return np.take_along_axis(flat, (yi * w + xi)[:, None, :].repeat(c, 1), axis=2)

    top = gather(y0c, x0c) * (1 - tx) + gather(y0c, x1c) * tx
    bot = gather(y1c, x0c) * (1 - tx) + gather(y1c, x1c) * tx
    return top * (1 - ty) + bot * ty  # (n, c, p)


def _track_geometry(batch: Batch, depths) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    poses = batch.extrinsics[0].detach().cpu().numpy()
    k = batch.intrinsics[0, 0].detach().cpu().numpy()
    d = torch.as_tensor(depths)[0].detach().cpu().numpy()
    _, h, w = d.shape
    surfaces = _np_unproject(_np_grid(h, w), d, k)  # (f, h, w, 3)
    return poses, k, surfaces


def _exact_tracks(
    poses: np.ndarray,  # (f, 4, 4) segment poses
    k: np.ndarray,
    surfaces: np.ndarray,  # (f, h, w, 3) segment surfaces
    query: np.ndarray,  # (p, 2) on the query frame
    query_frame: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Project the query frame's 3D points into every segment frame."""
    xyz = _np_grid_sample_points(
        surfaces[query_frame].transpose(2, 0, 1)[None], query[None]
    )[0].T  # (p, 3)
    rel = np.einsum("fij,jk->fik", _np_rigid_inverse(poses), poses[query_frame])
    xy_t = _np_reproject(xyz[None], rel[:, None], k)  # (fs, p, 2)
    visibility = np.all(xy_t >= 0, -1) & np.all(xy_t < 1, -1)
    return xy_t.astype(np.float32), visibility


def _as_tracks(xy_t: np.ndarray, visibility: np.ndarray, start: int, device) -> Tracks:
    return Tracks(
        xy=torch.as_tensor(xy_t[None]).to(device),
        visibility=torch.as_tensor(visibility[None]).to(device),
        start_frame=start,
    )


def make_track_segments(
    batch: Batch,
    depths,
    interval: int = 5,
    radius: int = 20,
    grid_size: int = 35,
) -> list[Tracks]:
    """Exact tracks in the reference's segment structure: every `interval`
    frames, a (grid_size x grid_size) query grid tracked over a +-`radius`
    window (reference: `flowmap/tracking/__init__.py:49-70`)."""
    poses, k, surfaces = _track_geometry(batch, depths)
    f = poses.shape[0]
    g = (np.arange(grid_size) + 0.5) / grid_size
    query = np.stack(np.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2).astype(np.float32)

    segments = []
    for center in range(0, f, interval):
        start = max(center - radius, 0)
        stop = min(center + radius + 1, f)
        xy_t, visibility = _exact_tracks(
            poses[start:stop], k, surfaces[start:stop], query, center - start
        )
        segments.append(_as_tracks(xy_t, visibility, start, batch.videos.device))
    return segments


def make_tracks(batch: Batch, depths, num_points: int = 64, seed: int = 0) -> list[Tracks]:
    """Exact point tracks from the GT geometry (one whole-video segment)."""
    rng = np.random.default_rng(seed)
    poses, k, surfaces = _track_geometry(batch, depths)
    query = rng.uniform(0.1, 0.9, size=(num_points, 2)).astype(np.float32)
    xy_t, visibility = _exact_tracks(poses, k, surfaces, query, 0)
    return [_as_tracks(xy_t, visibility, 0, batch.videos.device)]
