"""Flow-reprojection loss: the CUDA kernel (A) and its plain PyTorch version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/flow_loss.py:215`
(`flow_loss_pallas`; its pallas_calls at `:138` forward, `:162` backward).
Source: `csrc/flow_loss.cu`.

Design: the per-pair fold M = K_t (E_t^-1 E_s)[:3] stays in PyTorch, so
pose and intrinsics gradients chain through d_M. The kernel walks a pixel
tile of one source frame per block and evaluates both directions from one
read of the surface; loss and d_M sums go to per-block partials that
PyTorch sums (deterministic, no atomics), and d_surfaces is written once per
pixel. Bound: bytes (surface, flows and masks read once; d_surfaces written
once; `chip_smoke.py` computes it).

Dispatch is by device only: CPU tensors take `flow_loss_plain` (the XLA
formulation of `flowmap_tpu/loss/loss.py:79-95`), CUDA tensors take the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ...loss.mapping import MappingCfg, apply_mapping
from ...types import Flows
from ..geometry import (
    compute_backward_flow,
    compute_forward_flow,
    rigid_inverse,
    sample_image_grid,
)
from . import build

LAUNCHES = {"fwd": 0, "bwd": 0}
_PIX_PER_BLOCK = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_COMMON = [_P] * 7 + [_I, _I, _I, _F, _F, _F, _I]
_SIGNATURES = {
    "flow_loss_fwd": _COMMON + [_P, _P],
    "flow_loss_bwd": _COMMON + [_P, _P, _P, _P],
}


def _lib():
    return build.load("flow_loss", _SIGNATURES)


def flow_loss_plain(
    surfaces: torch.Tensor,  # (b, f, h, w, 3)
    extrinsics: torch.Tensor,  # (b, f, 4, 4)
    intrinsics: torch.Tensor,  # (b, f, 3, 3)
    flows: Flows,
    image_shape: tuple[int, int],
    mapping: MappingCfg,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, valid_sum) in the form of `flowmap_tpu/loss/loss.py:79-95`."""
    h, w = image_shape
    xy, _ = sample_image_grid((h, w), surfaces.device, surfaces.dtype)
    xy_fwd = compute_forward_flow(surfaces, extrinsics, intrinsics)
    fwd = apply_mapping(mapping, xy_fwd - xy, flows.forward, (h, w))
    xy_bwd = compute_backward_flow(surfaces, extrinsics, intrinsics)
    bwd = apply_mapping(mapping, xy_bwd - xy, flows.backward, (h, w))
    loss_sum = torch.sum(fwd * flows.forward_mask) + torch.sum(bwd * flows.backward_mask)
    valid_sum = torch.sum(flows.forward_mask) + torch.sum(flows.backward_mask)
    return loss_sum, valid_sum


def fold_projections(extrinsics: torch.Tensor, intrinsics: torch.Tensor):
    """Per-pair 3x4 M for both directions from (f, 4, 4) poses and (f, 3, 3) K.

    Rows 0-1 carry K; row 2 is the relative transform's z row alone (K's
    bottom row is never differentiated through in the reference)."""
    def fold(k_tgt, rel):
        return torch.cat([k_tgt[:, :2, :3] @ rel[:, :3, :], rel[:, 2:3, :]], dim=1)

    rel_fwd = rigid_inverse(extrinsics[1:]) @ extrinsics[:-1]
    rel_bwd = rigid_inverse(extrinsics[:-1]) @ extrinsics[1:]
    return fold(intrinsics[1:], rel_fwd), fold(intrinsics[:-1], rel_bwd)


def _launch_args(surf, m_fwd, m_bwd, flows: Flows, image_shape, delta):
    f, h, w, _ = surf.shape
    scale = (h * w) ** 0.5
    return [
        build.ptr(surf), build.ptr(m_fwd), build.ptr(m_bwd),
        build.ptr(flows.forward), build.ptr(flows.backward),
        build.ptr(flows.forward_mask), build.ptr(flows.backward_mask),
        ctypes.c_int(f), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_float(w / scale), ctypes.c_float(h / scale), ctypes.c_float(delta),
        ctypes.c_int(_PIX_PER_BLOCK),
    ]


def _num_tiles(h: int, w: int) -> int:
    return -(-(h * w) // _PIX_PER_BLOCK)


class _FlowLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, surf, m_fwd, m_bwd, flows, image_shape, delta):
        f, h, w, _ = surf.shape
        lib = _lib()
        partial = torch.empty((f, _num_tiles(h, w)), device=surf.device, dtype=torch.float32)
        args = _launch_args(surf, m_fwd, m_bwd, flows, image_shape, delta)
        build.check(
            lib.flow_loss_fwd(*args, build.ptr(partial), build.stream_ptr(surf.device)),
            "flow_loss_fwd",
        )
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(surf, m_fwd, m_bwd)
        ctx.flows = flows
        ctx.meta = (image_shape, delta)
        return partial.sum()

    @staticmethod
    def backward(ctx, g):
        surf, m_fwd, m_bwd = ctx.saved_tensors
        image_shape, delta = ctx.meta
        f, h, w, _ = surf.shape
        lib = _lib()
        g = g.detach().float().contiguous().reshape(1)
        partial = torch.empty((f, _num_tiles(h, w), 24), device=surf.device, dtype=torch.float32)
        d_surf = torch.empty_like(surf)
        args = _launch_args(surf, m_fwd, m_bwd, ctx.flows, image_shape, delta)
        build.check(
            lib.flow_loss_bwd(
                *args, build.ptr(g), build.ptr(partial), build.ptr(d_surf),
                build.stream_ptr(surf.device),
            ),
            "flow_loss_bwd",
        )
        LAUNCHES["bwd"] += 1
        sums = partial.sum(dim=1)  # (f, 24)
        d_m_fwd = (sums[:-1, :12] * g).reshape(f - 1, 3, 4)
        d_m_bwd = (sums[1:, 12:] * g).reshape(f - 1, 3, 4)
        return d_surf, d_m_fwd, d_m_bwd, None, None, None


def flow_loss(
    surfaces: torch.Tensor,  # (1, f, h, w, 3) f32
    extrinsics: torch.Tensor,  # (1, f, 4, 4)
    intrinsics: torch.Tensor,  # (1, f, 3, 3)
    flows: Flows,
    image_shape: tuple[int, int],
    delta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both flow-loss directions with the huber mapping: (loss_sum, valid_sum)."""
    if not surfaces.is_cuda:
        return flow_loss_plain(
            surfaces, extrinsics, intrinsics, flows, image_shape,
            MappingCfg("huber", delta),
        )
    b, f, h, w, _ = surfaces.shape
    if b != 1 or (h, w) != tuple(image_shape):
        raise ValueError("flow_loss kernel: batch 1 at model resolution only")
    if surfaces.dtype != torch.float32:
        raise ValueError("flow_loss kernel: float32 surfaces only")
    flows = Flows(*(
        t[0].float().contiguous()
        for t in (flows.forward, flows.backward, flows.forward_mask, flows.backward_mask)
    ))
    surf = surfaces[0].contiguous()
    m_fwd, m_bwd = fold_projections(extrinsics[0].float(), intrinsics[0].float())
    m_fwd, m_bwd = m_fwd.contiguous(), m_bwd.contiguous()
    build.require_cuda_tensors(
        "flow_loss", surf=surf, m_fwd=m_fwd, m_bwd=m_bwd, forward=flows.forward,
        backward=flows.backward, forward_mask=flows.forward_mask,
        backward_mask=flows.backward_mask,
    )
    loss_sum = _FlowLossFn.apply(surf, m_fwd, m_bwd, flows, tuple(image_shape), float(delta))
    valid_sum = flows.forward_mask.sum() + flows.backward_mask.sum()
    return loss_sum, valid_sum
