"""Bilinear displacement warps without gathers: the shift-window stencil and
the windowed one-hot matmul.

Counterpart of `flowmap_tpu/ops/warp.py` (`warp_bilinear_shifts`,
`warp_bilinear_matmul`, `radius_for_flows`). The stencil is the plain version
of the shift-warp kernel
(`ops/kernels/shift_warp.py`): `F.grid_sample(padding_mode="zeros",
align_corners=False)` semantics restricted to displacements within
(radius_y, radius_x) pixels. Each output pixel's four bilinear taps lie in a
(2*ry + 2) x (2*rx + 2) window of statically shifted slices weighted by
arithmetic one-hots; taps outside the window are dropped, taps outside the
image read the zero padding.

The backward to the features is the hand-written mirror stencil of the JAX
custom VJP; the sampling grid is frozen optical flow and gets no gradient.

`warp_bilinear_matmul` takes any column and a vertical window of
`2 * radius + 2` rows: exact column interpolation by a one-hot-pair matrix
per output row, and row interpolation over statically shifted copies. It is
exact while every vertical displacement stays within `radius`. Beyond it the
JAX package has two behaviours: its matmul form clamps the floor corner's
slot to the window's edge, and its Pallas kernel (`warp_kernel.py`) drops a
corner outside the window. `windowed_matmul_warp` has both; the second is
the plain version of the warp-features kernel
(`ops/kernels/warp_features.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def radius_for_flows(flow_y: np.ndarray, height: int, margin: int = 1) -> int:
    """Static radius covering a concrete flow field (host-side)."""
    max_dy = float(np.max(np.abs(np.asarray(flow_y)))) * height
    return int(np.ceil(max_dy)) + margin


def _hit(d: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - |d|): an exact one-hot for integer-valued f32 deltas."""
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def shift_sample_params(grid: torch.Tensor, h: int, w: int):
    """(oxf, tx, oyf, ty): floor-corner offsets from the output pixel (as
    integer-valued f32) and the bilinear fractions, all (n, h, w)."""
    x = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    oxf = x0 - torch.arange(w, dtype=x0.dtype, device=x0.device)[None, None, :]
    oyf = y0 - torch.arange(h, dtype=y0.dtype, device=y0.device)[None, :, None]
    return oxf, x - x0, oyf, y - y0


def _tap_weight(o: torch.Tensor, t: torch.Tensor, s: int) -> torch.Tensor:
    return (1.0 - t) * _hit(o - s) + t * _hit(o - s + 1.0)


def shifts_forward(input_nhwc, grid, ry: int, rx: int) -> torch.Tensor:
    n, h, w, c = input_nhwc.shape
    oxf, tx, oyf, ty = shift_sample_params(grid.float(), h, w)
    wy = [_tap_weight(oyf, ty, sy) for sy in range(-ry, ry + 2)]
    wx = [_tap_weight(oxf, tx, sx) for sx in range(-rx, rx + 2)]
    padded = F.pad(input_nhwc, (0, 0, rx, rx + 1, ry, ry + 1))
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=input_nhwc.device)
    for iy, sy in enumerate(range(-ry, ry + 2)):
        for ix, sx in enumerate(range(-rx, rx + 2)):
            wt = (wy[iy] * wx[ix]).to(input_nhwc.dtype)
            tap = padded[:, sy + ry : sy + ry + h, sx + rx : sx + rx + w]
            acc = acc + (wt[..., None] * tap).float()
    return acc.to(input_nhwc.dtype)


def shifts_backward(g, grid, ry: int, rx: int, dtype) -> torch.Tensor:
    """d_in[u, v] = sum_taps (wy_sy * wx_sx * g)[u - sy, v - sx]."""
    n, h, w, c = g.shape
    oxf, tx, oyf, ty = shift_sample_params(grid.float(), h, w)
    pad2 = (rx + 1, rx, ry + 1, ry)
    gp = F.pad(g.float(), (0, 0) + pad2)
    typ, oyp, txp, oxp = (F.pad(p, pad2) for p in (ty, oyf, tx, oxf))
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=g.device)
    for sy in range(-ry, ry + 2):
        for sx in range(-rx, rx + 2):
            y0, x0 = ry + 1 - sy, rx + 1 - sx

            def sl(a):
                return a[:, y0 : y0 + h, x0 : x0 + w]

            wt = _tap_weight(sl(oyp), sl(typ), sy) * _tap_weight(sl(oxp), sl(txp), sx)
            acc = acc + wt[..., None] * sl(gp)
    return acc.to(dtype)


class _WarpShifts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input_nhwc, grid, ry, rx):
        ctx.save_for_backward(grid)
        ctx.meta = (ry, rx, input_nhwc.dtype)
        return shifts_forward(input_nhwc, grid, ry, rx)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        ry, rx, dtype = ctx.meta
        return shifts_backward(g, grid, ry, rx, dtype), None, None, None


def warp_bilinear_shifts(
    input_nhwc: torch.Tensor,  # (n, h, w, c)
    grid: torch.Tensor,  # (n, h, w, 2) in [-1, 1], xy order
    radius_y: int,
    radius_x: int,
) -> torch.Tensor:  # (n, h, w, c)
    """Shift-stencil bilinear warp; no gradient to `grid`."""
    return _WarpShifts.apply(input_nhwc, grid.detach(), radius_y, radius_x)


class _RowWeight(torch.autograd.Function):
    """weight * contrib in f32. Backward: the row weight folded into the
    cotangent and rounded to the feature dtype before it meets the column
    weights, the rounding point of the warp-features kernels. In float32
    this is the plain product rule."""

    @staticmethod
    def forward(ctx, weight, contrib, dtype):
        ctx.save_for_backward(weight)
        ctx.dtype = dtype
        return weight * contrib

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        return None, (weight * g).to(ctx.dtype).float(), None


def windowed_matmul_warp(
    input: torch.Tensor,  # (n, c, h, w)
    grid: torch.Tensor,  # (n, h, wg, 2) in [-1, 1], xy order
    radius: int,
    beyond: str,
) -> torch.Tensor:  # (n, c, h, wg)
    """`F.grid_sample(zeros, align_corners=False)` restricted to a vertical
    window of `radius` rows around each output row; columns are unbounded.

    `beyond` says what happens to a corner whose row is outside the window:
    "clamp" moves the floor corner's slot to the window's edge
    (`flowmap_tpu/ops/warp.py:warp_bilinear_matmul`), "drop" gives it weight
    zero (`flowmap_tpu/ops/pallas/warp_kernel.py`). The column weights are
    rounded to the feature dtype; products, row weights and sums are f32; the
    result is rounded once. Gradients flow to `input` and, through the
    fractions, to `grid`."""
    if beyond not in ("clamp", "drop"):
        raise ValueError(f"unknown window rule: {beyond}")
    n, c, h, w = input.shape
    _, hg, wg, _ = grid.shape
    if hg != h:
        raise ValueError("the matmul warp needs row-aligned output (a displacement warp)")
    grid = grid.float()
    x = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5

    # Column one-hot pair, zero outside [0, w - 1] ("zeros" padding in x).
    x0 = torch.floor(x)
    tx = (x - x0)[..., None]
    x0i = x0.long()
    cols = torch.arange(w, device=input.device)
    onehot0 = (cols == x0i[..., None]).float()
    onehot1 = (cols == (x0i + 1)[..., None]).float()
    wx = (onehot0 * (1.0 - tx) + onehot1 * tx).to(input.dtype).float()  # (n, h, wg, w)

    y0 = torch.floor(y)
    ty = y - y0
    y0i = y0.long()
    rows = torch.arange(h, device=input.device)[None, :, None]
    slot0 = y0i - rows + radius  # window slot of the floor corner
    if beyond == "clamp":
        slot0 = slot0.clamp(0, 2 * radius)
    w0 = (1.0 - ty) * ((y0i >= 0) & (y0i <= h - 1)).float()
    w1 = ty * ((y0i + 1 >= 0) & (y0i + 1 <= h - 1)).float()

    padded = F.pad(input.permute(0, 2, 3, 1), (0, 0, 0, 0, radius, radius + 1)).float()
    out = torch.zeros((n, h, wg, c), dtype=torch.float32, device=input.device)
    zero = torch.zeros((), dtype=torch.float32, device=input.device)
    for d in range(2 * radius + 2):
        weight = torch.where(slot0 == d, w0, zero) + torch.where(slot0 + 1 == d, w1, zero)
        contrib = torch.einsum("nhjx,nhxc->nhjc", wx, padded[:, d : d + h])
        out = out + _RowWeight.apply(weight[..., None], contrib, input.dtype)
    return out.to(input.dtype).permute(0, 3, 1, 2)


def warp_bilinear_matmul(
    input: torch.Tensor,  # (n, c, h, w)
    grid: torch.Tensor,  # (n, h, wg, 2)
    radius: int = 16,
) -> torch.Tensor:  # (n, c, h, wg)
    """The gather-free warp of `flowmap_tpu/ops/warp.py:warp_bilinear_matmul`:
    vertical displacements beyond `radius` clamp to the window's edge."""
    return windowed_matmul_warp(input, grid, radius, "clamp")
