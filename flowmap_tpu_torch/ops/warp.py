"""Small-radius bilinear displacement warp as a shift-window stencil.

Counterpart of `flowmap_tpu/ops/warp.py:warp_bilinear_shifts` and
`radius_for_flows`. This is the plain version of the shift-warp kernel
(`ops/kernels/shift_warp.py`): `F.grid_sample(padding_mode="zeros",
align_corners=False)` semantics restricted to displacements within
(radius_y, radius_x) pixels. Each output pixel's four bilinear taps lie in a
(2*ry + 2) x (2*rx + 2) window of statically shifted slices weighted by
arithmetic one-hots; taps outside the window are dropped, taps outside the
image read the zero padding.

The backward to the features is the hand-written mirror stencil of the JAX
custom VJP; the sampling grid is frozen optical flow and gets no gradient.
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
