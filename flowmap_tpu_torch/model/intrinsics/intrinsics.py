"""Intrinsics estimation: ground_truth / regressed / softmin with regression.

Counterpart of `flowmap_tpu/model/intrinsics/intrinsics.py` (reference
`flowmap/model/intrinsics/`). The softmin module's two stages: during stage
1 every step sweeps candidate focal lengths (one batched Procrustes solve
over the candidates) and records the softmin focal estimate in a ring
buffer of the trailing `window` steps; at `after_step` the regressed focal
(a parameter from step 0, zero gradient until then) is overwritten with the
window mean (`maybe_handoff_focal`) and stage 2 uses it.

The sweep's random pixel subset comes from the caller (`indices`) when
given -- the parity tests inject the JAX package's draw, whose threefry bits
PyTorch cannot reproduce -- and otherwise from a `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch
import torch.nn as nn

from ...ops.geometry import (
    focal_lengths_to_intrinsics,
    project_camera_space,
    sample_image_grid,
)
from ...ops.grid_sample import grid_sample_points
from ...ops.procrustes import align_rigid
from ...types import BackboneOutput, Batch, Flows


@dataclass(frozen=True)
class RegressionCfg:
    after_step: int = 1000
    window: int = 100


@dataclass(frozen=True)
class IntrinsicsGroundTruthCfg:
    name: Literal["ground_truth"] = "ground_truth"


@dataclass(frozen=True)
class IntrinsicsRegressedCfg:
    name: Literal["regressed"] = "regressed"
    initial_focal_length: float = 0.85


@dataclass(frozen=True)
class IntrinsicsSoftminCfg:
    name: Literal["softmin"] = "softmin"
    num_procrustes_points: int = 8192
    min_focal_length: float = 0.5
    max_focal_length: float = 2.0
    num_candidates: int = 60
    regression: Optional[RegressionCfg] = RegressionCfg()


IntrinsicsCfg = IntrinsicsGroundTruthCfg | IntrinsicsRegressedCfg | IntrinsicsSoftminCfg


@dataclass
class IntrinsicsState:
    """Trailing window of softmin focal estimates (ring buffer)."""

    focal_window: torch.Tensor  # (window,)


class IntrinsicsParams(nn.Module):
    """The intrinsics module's trainable parameters (the regressed focal)."""

    def __init__(self, cfg: IntrinsicsCfg):
        super().__init__()
        if isinstance(cfg, IntrinsicsRegressedCfg):
            self.focal_length = nn.Parameter(torch.tensor(cfg.initial_focal_length))
        elif isinstance(cfg, IntrinsicsSoftminCfg) and cfg.regression is not None:
            # Stage-2 focal; overwritten at the boundary step.
            self.focal_length = nn.Parameter(torch.tensor(0.0))
        else:
            self.focal_length = None


def init_intrinsics_state(cfg: IntrinsicsCfg, device) -> IntrinsicsState:
    window = 0
    if isinstance(cfg, IntrinsicsSoftminCfg) and cfg.regression is not None:
        window = cfg.regression.window
    return IntrinsicsState(focal_window=torch.zeros((max(window, 1),), device=device))


def maybe_handoff_focal(
    cfg: IntrinsicsCfg, params: IntrinsicsParams, state: IntrinsicsState, step: int
) -> None:
    """At the stage boundary, overwrite the regressed focal with the window
    mean (the reference's `.data =` assignment, `intrinsics_softmin.py:79-81`)."""
    if isinstance(cfg, IntrinsicsSoftminCfg) and cfg.regression is not None:
        if step == cfg.regression.after_step:
            with torch.no_grad():
                params.focal_length.copy_(state.focal_window.mean())


def _focal_to_k(focal_length: torch.Tensor, batch: Batch) -> torch.Tensor:
    b, f, _, h, w = batch.videos.shape
    return focal_lengths_to_intrinsics(focal_length, (h, w)).expand(b, f, 3, 3)


def softmin_sweep(
    cfg: IntrinsicsSoftminCfg,
    num_frames: int,
    backward0: torch.Tensor,  # (b, h, w, 2)
    depths01: torch.Tensor,  # (b, 2, h, w)
    weights0: torch.Tensor,  # (b, h, w)
    indices: torch.Tensor,  # (k,)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 softmin over candidate focals (`intrinsics_softmin.py:84-141`).

    Every candidate shares the principal point, so candidate surfaces are
    diag(1/fx_c, 1/fy_c, 1) scalings of one unit-focal base surface, and
    bilinear sampling commutes with that scaling: one unprojection and one
    grid sample serve all candidates. Returns (intrinsics (b, f, 3, 3),
    scalar focal estimate)."""
    b, h, w, _ = backward0.shape
    n = cfg.num_candidates
    dtype, device = depths01.dtype, depths01.device
    k_points = indices.shape[0]

    candidates = torch.linspace(
        cfg.min_focal_length, cfg.max_focal_length, n, dtype=dtype, device=device
    )
    candidate_k = focal_lengths_to_intrinsics(candidates, (h, w))  # (n, 3, 3)
    inv_scale = torch.stack(
        [1.0 / candidate_k[:, 0, 0], 1.0 / candidate_k[:, 1, 1], torch.ones_like(candidates)],
        dim=-1,
    )  # (n, 3)

    xy, _ = sample_image_grid((h, w), device, dtype)
    dirs = torch.cat([xy - 0.5, torch.ones_like(xy[..., :1])], dim=-1)
    base = dirs * depths01[..., None]  # (b, 2, h, w, 3)

    base_later = base[:, 1].reshape(b, h * w, 3)[:, indices]  # (b, k, 3)
    xy_sub = xy.reshape(h * w, 2)[indices]
    xy_earlier = (xy + backward0).reshape(b, h * w, 2)[:, indices]
    base_earlier = grid_sample_points(
        base[:, 0].permute(0, 3, 1, 2), xy_earlier, padding_mode="border"
    ).permute(0, 2, 1)  # (b, k, 3)

    p_later = base_later[:, None] * inv_scale[None, :, None]  # (b, n, k, 3)
    p_earlier = base_earlier[:, None] * inv_scale[None, :, None]

    point_weights = weights0.reshape(b, h * w)[:, indices]
    rel = align_rigid(p_later, p_earlier, point_weights[:, None].expand(b, n, k_points))

    cam = torch.einsum(
        "bnij,bnkj->bnki",
        rel,
        torch.cat([p_later, torch.ones_like(p_later[..., :1])], dim=-1),
    )[..., :3]
    xy_flowed = project_camera_space(cam, candidate_k[None, :, None])
    flow = xy_flowed - xy_sub
    flow_gt = backward0.reshape(b, 1, h * w, 2)[:, :, indices]
    error = torch.sum(torch.abs((flow - flow_gt) * point_weights[:, None, :, None]), dim=(-1, -2))

    softmin = torch.softmax(-(error - error.min(dim=1, keepdim=True).values) * 10.0, dim=1)
    mixed = torch.einsum("bn,nij->bij", softmin, candidate_k)
    focal_estimate = torch.einsum("bn,n->b", softmin, candidates).mean()
    return mixed[:, None].expand(b, num_frames, 3, 3), focal_estimate


def sweep_indices(
    cfg: IntrinsicsSoftminCfg, h: int, w: int, device, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """A random subset of min(num_procrustes_points, h*w) distinct pixels,
    drawn on the host and copied without blocking the stream."""
    perm = torch.randperm(h * w, generator=generator, device="cpu")[: cfg.num_procrustes_points]
    if torch.device(device).type == "cuda":
        perm = perm.pin_memory()
    return perm.to(device, non_blocking=True)


def apply_intrinsics(
    cfg: IntrinsicsCfg,
    params: IntrinsicsParams,
    state: IntrinsicsState,
    batch: Batch,
    flows: Flows,
    backbone_output: BackboneOutput,
    step: int,
    indices: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = True,
) -> tuple[torch.Tensor, IntrinsicsState]:
    """Per-frame intrinsics (b, f, 3, 3) and the updated window state."""
    if isinstance(cfg, IntrinsicsGroundTruthCfg):
        if batch.intrinsics is None:
            raise ValueError("ground_truth intrinsics need GT")
        return batch.intrinsics, state
    if isinstance(cfg, IntrinsicsRegressedCfg):
        return _focal_to_k(params.focal_length, batch), state

    f, h, w = batch.videos.shape[1], batch.videos.shape[3], batch.videos.shape[4]
    regression = cfg.regression
    if regression is not None and step >= regression.after_step:
        return _focal_to_k(params.focal_length, batch), state

    if indices is None:
        indices = sweep_indices(cfg, h, w, batch.videos.device, generator)
    sweep_k, focal = softmin_sweep(
        cfg, f, flows.backward[:, 0], backbone_output.depths[:, :2],
        backbone_output.weights[:, 0], indices,
    )
    if regression is None:
        return sweep_k, state
    # Ring-buffer update during the trailing `window` stage-1 steps.
    if train and step >= regression.after_step - regression.window:
        window = state.focal_window.clone()
        window[step % regression.window] = focal.detach()
        state = IntrinsicsState(focal_window=window)
    return sweep_k, state
