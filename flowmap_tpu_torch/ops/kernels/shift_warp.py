"""Shift-window bilinear warp: the CUDA kernel (B) and its plain version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/shift_warp.py:318`
(`warp_shifts_tpu`; its pallas_calls at `:243` forward, `:275` backward).
Source: `csrc/shift_warp.cu`. The plain version is the stencil of
`ops/warp.py:warp_bilinear_shifts`.

Design: the TPU kernel walks the whole (2ry+2) x (2rx+2) tap window with
one-hot weights because the TPU has no fast gather. On Hopper the forward is
a direct gather of the (at most) four bilinear corners that lie in the
window, and the backward is the transposed stencil written as a gather over
each input pixel's window of output pixels -- deterministic, no atomics.
Both match the plain stencil bit for bit (same f32 operations in the same
order). One thread per (pixel, 16-byte channel vector). Bound: bytes
(features and grid read once, result written once; `chip_smoke.py` computes
it).

Dispatch is by device only: CPU tensors take the plain stencil, CUDA tensors
take the kernel or raise. The grid is frozen optical flow: no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..warp import warp_bilinear_shifts
from . import build

LAUNCHES = {"fwd": 0, "bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P] + [_I] * 7 + [_P]
_SIGNATURES = {"shift_warp_fwd": _SIG, "shift_warp_bwd": _SIG}
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


def _lib():
    return build.load("shift_warp", _SIGNATURES)


def _launch(fn_name, src, grid, ry, rx):
    n, h, w, c = src.shape
    code, _ = _DTYPES[src.dtype]
    dst = torch.empty_like(src)
    status = getattr(_lib(), fn_name)(
        build.ptr(src), build.ptr(grid), build.ptr(dst),
        n, h, w, c, ry, rx, code, build.stream_ptr(src.device),
    )
    build.check(status, fn_name)
    return dst


class _ShiftWarpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input_nhwc, grid, ry, rx):
        out = _launch("shift_warp_fwd", input_nhwc, grid, ry, rx)
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(grid)
        ctx.radii = (ry, rx)
        return out

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        ry, rx = ctx.radii
        d_in = _launch("shift_warp_bwd", g.contiguous(), grid, ry, rx)
        LAUNCHES["bwd"] += 1
        return d_in, None, None, None


def warp_shifts(
    input_nhwc: torch.Tensor,  # (n, h, w, c) float32 or bfloat16
    grid: torch.Tensor,  # (n, h, w, 2) float32 in [-1, 1]
    radius_y: int,
    radius_x: int,
) -> torch.Tensor:
    """Shift-window bilinear warp; no gradient to `grid`."""
    if not input_nhwc.is_cuda:
        return warp_bilinear_shifts(input_nhwc, grid, radius_y, radius_x)
    if input_nhwc.dtype not in _DTYPES:
        raise ValueError(f"shift_warp kernel: unsupported dtype {input_nhwc.dtype}")
    n, h, w, c = input_nhwc.shape
    if c % _DTYPES[input_nhwc.dtype][1] != 0:
        raise ValueError(f"shift_warp kernel: channels {c} not a multiple of the vector width")
    if grid.shape != (n, h, w, 2) or grid.dtype != torch.float32:
        raise ValueError("shift_warp kernel: grid must be float32 (n, h, w, 2)")
    grid = grid.detach()
    build.require_cuda_tensors("shift_warp", input=input_nhwc, grid=grid)
    return _ShiftWarpFn.apply(input_nhwc, grid, int(radius_y), int(radius_x))
