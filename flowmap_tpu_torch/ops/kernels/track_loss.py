"""Packed tracking loss: the CUDA kernels (D) and their plain PyTorch version.

Replaces the Pallas TPU kernels of `flowmap_tpu/ops/pallas/track_loss.py:439`
(`track_loss_pallas`; its pallas_calls at `:293` sample forward, `:323`
sample backward, `:358` pair-loss forward, `:395` pair-loss backward).
Source: `csrc/track_loss.cu`.

Design: two kernels each way. The sampling gathers the four border-clamped
corners of the surfaces at every track point (the TPU kernel's one-hot
matmul, frame sorting and tile padding exist because the TPU has no gather);
its backward scatters with f32 `atomicAdd` into a zero-initialised
`d_surfaces`, so the last bits of that gradient depend on the order in which
the card retires the adds. The pair loss runs one block per (segment, source
frame, tile of points) with the window's projection matrices in shared
memory; its sums (loss, valid count, `d_xyz` over targets, `d_M` over points)
are taken in a fixed order and are deterministic. The per-pair fold
M[s, fs, ft] = K_ft (E_ft^-1 E_fs)[:3] stays in PyTorch as two batched
einsums, so pose and intrinsics gradients chain through `d_M`; the frame
index of the packed windows is built once per `TracksPacked`. Bound: bytes
for the sampling, operations for the pair loss (`chip_smoke.py` computes
both).

Dispatch is by device only: CPU tensors take `track_loss_plain` (the XLA
formulation of `flowmap_tpu/loss/loss.py:164-227` with
`ops/surface.py:sample_track_points_packed`), CUDA tensors take the kernels
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ...loss.mapping import MappingCfg, apply_mapping_components
from ...types import TracksPacked
from ..geometry import homogenize_points, rigid_inverse
from ..surface import sample_track_points_packed
from . import build

LAUNCHES = {"sample_fwd": 0, "sample_bwd": 0, "pair_fwd": 0, "pair_bwd": 0}

_EPS = 1e-5
_INF = 1e8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SAMPLE = [_P, _P, _P, _P] + [_I] * 6 + [_P]
_PAIR = [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F]
_SIGNATURES = {
    "track_loss_points_per_block": [],
    "track_loss_pair_smem_bytes": [_I, _I],
    "track_sample_fwd": _SAMPLE,
    "track_sample_bwd": _SAMPLE,
    "track_pair_fwd": _PAIR + [_P, _P],
    "track_pair_bwd": _PAIR + [_P, _P, _P, _P],
}
_MAX_SMEM = 48 * 1024  # static limit of dynamic shared memory without opt-in


def _lib():
    return build.load("track_loss", _SIGNATURES)


def fold_pair_projections(
    extrinsics: torch.Tensor,  # (f, 4, 4)
    intrinsics: torch.Tensor,  # (f, 3, 3)
    frame_idx: torch.Tensor,  # (s, l) video frame of every window slot
) -> torch.Tensor:  # (s, l, l, 3, 4), indexed [segment, source, target]
    """M[s, fs, ft] = K_ft (E_ft^-1 E_fs)[:3]: homogeneous source-camera
    points straight to (u', v', z') of the target, u = u' / (z' + eps)."""
    seg_e = extrinsics[frame_idx]
    seg_k = intrinsics[frame_idx]
    relative = torch.einsum("stij,sfjk->sftik", rigid_inverse(seg_e), seg_e)
    return torch.einsum("stij,sftjk->sftik", seg_k, relative[..., :3, :])


def pair_loss_plain(
    xyz: torch.Tensor,  # (s, l, p, 3) sampled source points
    m: torch.Tensor,  # (s, l, l, 3, 4)
    tracks: TracksPacked,
    image_shape: tuple[int, int],
    mapping: MappingCfg,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The all-pairs part of `track_loss_plain`: (loss_sum, valid_sum)."""
    h, w = image_shape
    uvz = torch.einsum("sftij,sfpj->sftip", m, homogenize_points(xyz))  # (s, f, t, 3, p)

    # Perspective divide, eps-guarded and inf-clamped, with the nan_to_num on
    # the quotient.
    denom = uvz[..., 2, :] + _EPS

    def nan(q):
        return torch.nan_to_num(q, nan=0.0, posinf=_INF, neginf=-_INF)

    u = nan(uvz[..., 0, :] / denom)  # (s, f, t, p)
    v = nan(uvz[..., 1, :] / denom)

    gt = tracks.xy[0]  # (s, l, p, 2); the GT of pair (fs, ft) is the track at ft
    scale = (h * w) ** 0.5
    mapped = apply_mapping_components(
        mapping, (u - gt[:, None, :, :, 0]) * (w / scale), (v - gt[:, None, :, :, 1]) * (h / scale)
    )

    visibility = tracks.visibility[0]  # (s, l, p)
    joint = visibility[:, :, None] & visibility[:, None]
    source_in = (torch.all(gt >= 0, dim=-1) & torch.all(gt < 1, dim=-1))[:, :, None]
    target_in = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    mask = (joint & source_in & target_in).to(mapped.dtype)
    return torch.sum(mapped * mask), torch.sum(mask)


def track_loss_plain(
    surfaces: torch.Tensor,  # (1, f, h, w, 3)
    extrinsics: torch.Tensor,  # (1, f, 4, 4)
    intrinsics: torch.Tensor,  # (1, f, 3, 3)
    tracks: TracksPacked,
    image_shape: tuple[int, int],
    mapping: MappingCfg,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, valid_sum) in the form of `flowmap_tpu/loss/loss.py:164-227`:
    every point of every source frame projected into every target frame of
    its segment by one batched 3x4 product."""
    xyz, frame_idx = sample_track_points_packed(surfaces, tracks)
    m = fold_pair_projections(extrinsics[0], intrinsics[0], frame_idx)
    return pair_loss_plain(xyz, m, tracks, image_shape, mapping)


def _pair_args(xyz, m, xy, vis, image_shape, delta):
    h, w = image_shape
    s, l, p, _ = xy.shape
    scale = (h * w) ** 0.5
    return [
        build.ptr(xyz), build.ptr(m), build.ptr(xy), build.ptr(vis), s, l, p,
        ctypes.c_float(w / scale), ctypes.c_float(h / scale), ctypes.c_float(delta),
    ]


def _num_tiles(p: int) -> int:
    return -(-p // _lib().track_loss_points_per_block())


def _sample_dims(surf_shape, xy):
    f, h, w, _ = surf_shape
    s, l, p, _ = xy.shape
    return [f, h, w, s, l, p]


def sample_forward(surf, xy, starts):
    """Launch the sampling kernel: (s, l, p, 3) points of `surf` (f, h, w, 3)."""
    xyz = torch.empty((*xy.shape[:3], 3), device=surf.device, dtype=torch.float32)
    build.check(
        _lib().track_sample_fwd(
            build.ptr(surf), build.ptr(xy), build.ptr(starts), build.ptr(xyz),
            *_sample_dims(surf.shape, xy), build.stream_ptr(surf.device),
        ),
        "track_sample_fwd",
    )
    LAUNCHES["sample_fwd"] += 1
    return xyz


def sample_backward(surf_shape, xy, starts, d_xyz):
    """Launch the scatter kernel into a zero-initialised (f, h, w, 3)."""
    d_surf = torch.zeros(surf_shape, device=xy.device, dtype=torch.float32)
    build.check(
        _lib().track_sample_bwd(
            build.ptr(xy), build.ptr(starts), build.ptr(d_xyz), build.ptr(d_surf),
            *_sample_dims(surf_shape, xy), build.stream_ptr(xy.device),
        ),
        "track_sample_bwd",
    )
    LAUNCHES["sample_bwd"] += 1
    return d_surf


def pair_forward(xyz, m, xy, vis, image_shape, delta):
    """Launch the pair-loss forward: the (2,) sums (loss, valid)."""
    s, l, p, _ = xy.shape
    partial = torch.empty((s, l, _num_tiles(p), 2), device=xy.device, dtype=torch.float32)
    build.check(
        _lib().track_pair_fwd(
            *_pair_args(xyz, m, xy, vis, image_shape, delta), build.ptr(partial),
            build.stream_ptr(xy.device),
        ),
        "track_pair_fwd",
    )
    LAUNCHES["pair_fwd"] += 1
    return partial.sum(dim=(0, 1, 2))


def pair_backward(xyz, m, xy, vis, image_shape, delta, g):
    """Launch the pair-loss backward: (d_xyz, d_m), scaled by `g` (1,)."""
    s, l, p, _ = xy.shape
    dm_partial = torch.empty((s, l, _num_tiles(p), l, 12), device=xy.device, dtype=torch.float32)
    d_xyz = torch.empty((s, l, p, 3), device=xy.device, dtype=torch.float32)
    build.check(
        _lib().track_pair_bwd(
            *_pair_args(xyz, m, xy, vis, image_shape, delta), build.ptr(g),
            build.ptr(dm_partial), build.ptr(d_xyz), build.stream_ptr(xy.device),
        ),
        "track_pair_bwd",
    )
    LAUNCHES["pair_bwd"] += 1
    return d_xyz, dm_partial.sum(dim=2)


class _TrackLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, surf, m, xy, vis, starts, image_shape, delta):
        xyz = sample_forward(surf, xy, starts)
        sums = pair_forward(xyz, m, xy, vis, image_shape, delta)
        ctx.save_for_backward(xyz, m, xy, vis, starts)
        ctx.meta = (tuple(surf.shape), image_shape, delta)
        loss_sum, valid_sum = sums[0], sums[1]
        ctx.mark_non_differentiable(valid_sum)
        return loss_sum, valid_sum

    @staticmethod
    def backward(ctx, g_loss, _g_valid):
        xyz, m, xy, vis, starts = ctx.saved_tensors
        surf_shape, image_shape, delta = ctx.meta
        g = g_loss.detach().float().contiguous().reshape(1)
        d_xyz, d_m = pair_backward(xyz, m, xy, vis, image_shape, delta, g)
        d_surf = sample_backward(surf_shape, xy, starts, d_xyz)
        return d_surf, d_m, None, None, None, None, None


def track_loss(
    surfaces: torch.Tensor,  # (1, f, h, w, 3) f32
    extrinsics: torch.Tensor,  # (1, f, 4, 4)
    intrinsics: torch.Tensor,  # (1, f, 3, 3)
    tracks: TracksPacked,
    image_shape: tuple[int, int],
    delta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed tracking loss with the huber mapping: (loss_sum, valid_sum).
    The tracks carry no gradient."""
    if not surfaces.is_cuda:
        return track_loss_plain(
            surfaces, extrinsics, intrinsics, tracks, image_shape, MappingCfg("huber", delta)
        )
    b, f, h, w, _ = surfaces.shape
    if b != 1 or tracks.xy.shape[0] != 1 or (h, w) != tuple(image_shape):
        raise ValueError("track_loss kernel: batch 1 at model resolution only")
    if surfaces.dtype != torch.float32 or tracks.xy.dtype != torch.float32:
        raise ValueError("track_loss kernel: float32 surfaces and tracks only")
    if tracks.visibility.dtype != torch.bool:
        raise ValueError("track_loss kernel: visibility must be bool")
    _, s, l, p, _ = tracks.xy.shape
    if tracks.visibility.shape != (1, s, l, p) or tracks.starts.shape != (s,):
        raise ValueError("track_loss kernel: xy, visibility and starts disagree in shape")
    if _lib().track_loss_pair_smem_bytes(l, 1) > _MAX_SMEM:
        raise ValueError(f"track_loss kernel: window of {l} frames exceeds its shared memory")
    surf = surfaces[0].contiguous()
    xy = tracks.xy[0].detach().contiguous()
    vis = tracks.visibility[0].contiguous()
    starts = tracks.starts.to(torch.int32).contiguous()
    m = fold_pair_projections(
        extrinsics[0].float(), intrinsics[0].float(), tracks.frame_index()
    ).reshape(s, l, l, 12).contiguous()
    build.require_cuda_tensors("track_loss", surf=surf, m=m, xy=xy, vis=vis, starts=starts)
    return _TrackLossFn.apply(surf, m, xy, vis, starts, tuple(image_shape), float(delta))
