"""Bounded-radius bilinear feature warp: the CUDA kernel (E) and its plain version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/warp_kernel.py:361`
(`warp_features`; its pallas_calls at `:290` forward, `:334` feature
gradient). Source: `csrc/warp_features.cu`.

`warp_features(input (n, c, h, w), grid (n, h, wg, 2), radius)` is
`F.grid_sample(zeros padding, align_corners=False)` with any column and a
vertical window: a bilinear corner whose row lies outside
[i - radius, i + radius + 1] of output row i is dropped, as the TPU kernel
drops it. The plain version is `ops/warp.py:windowed_matmul_warp(..., "drop")`,
differentiated by autograd with the grid detached; it equals the JAX
package's `warp_bilinear_matmul` wherever displacements stay within the
radius (beyond it that one clamps to the window's edge).

Design: the TPU kernel copies row windows into fast memory and multiplies
by one-hot column matrices because the TPU has no gather. On Hopper the
forward gathers the (at most) four corners, one thread per (output pixel,
16-byte channel vector), from NHWC features: the layout the gather wants, so
the wrapper makes one NHWC copy of its NCHW input and returns an NCHW view
of its NHWC result. The backward scatters with f32 `atomicAdd` into an f32
scratch that is cast to the feature type at the end: columns are unbounded,
so a gather over a small window, as the shift warp's backward is, does not
exist. The last bits of the f32 sums therefore depend on the order in which
the card retires the adds. Rounding points are the TPU kernel's (column
weight rounded to the feature type; row weight, products and sums in f32;
in the backward the row-weighted cotangent rounded to the feature type). The
grid is float32 here; the JAX package rounds it to the feature type, which
in bfloat16 costs half a pixel at this width. Bound: bytes (`chip_smoke.py`
computes it).

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
take the kernel or raise. The grid is frozen optical flow: no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..warp import windowed_matmul_warp
from . import build

LAUNCHES = {"fwd": 0, "bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P] + [_I] * 7 + [_P]
_SIGNATURES = {"warp_features_fwd": _SIG, "warp_features_bwd": _SIG}
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


def _lib():
    return build.load("warp_features", _SIGNATURES)


def warp_features_plain(input: torch.Tensor, grid: torch.Tensor, radius: int) -> torch.Tensor:
    """The windowed one-hot matmul warp with out-of-window corners dropped;
    no gradient to `grid`."""
    return windowed_matmul_warp(input, grid.detach(), radius, "drop")


def _launch(fn_name, src, grid, dst, in_width, radius):
    n, h, wg, _ = grid.shape
    status = getattr(_lib(), fn_name)(
        build.ptr(src), build.ptr(grid), build.ptr(dst),
        n, h, in_width, wg, src.shape[-1], radius, _DTYPES[src.dtype][0],
        build.stream_ptr(src.device),
    )
    build.check(status, fn_name)


class _WarpFeaturesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input_nhwc, grid, radius):
        n, h, w, c = input_nhwc.shape
        out = torch.empty((n, h, grid.shape[2], c), device=input_nhwc.device, dtype=input_nhwc.dtype)
        _launch("warp_features_fwd", input_nhwc, grid, out, w, radius)
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(grid)
        ctx.meta = (tuple(input_nhwc.shape), radius)
        return out

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        shape, radius = ctx.meta
        g = g.contiguous()
        scratch = torch.zeros(shape, device=g.device, dtype=torch.float32)
        _launch("warp_features_bwd", g, grid, scratch, shape[2], radius)
        LAUNCHES["bwd"] += 1
        return scratch.to(g.dtype), None, None


def warp_features(
    input: torch.Tensor,  # (n, c, h, w) float32 or bfloat16
    grid: torch.Tensor,  # (n, h, wg, 2) in [-1, 1], xy order
    radius: int,
) -> torch.Tensor:  # (n, c, h, wg)
    """Bilinear displacement warp inside a vertical window of `radius` rows;
    no gradient to `grid`."""
    if not input.is_cuda:
        return warp_features_plain(input, grid, radius)
    if input.dtype not in _DTYPES:
        raise ValueError(f"warp_features kernel: unsupported dtype {input.dtype}")
    n, c, h, w = input.shape
    if c % _DTYPES[input.dtype][1] != 0:
        raise ValueError(f"warp_features kernel: channels {c} not a multiple of the vector width")
    if grid.dim() != 4 or grid.shape[:2] != (n, h) or grid.shape[3] != 2:
        raise ValueError("warp_features kernel: grid must be (n, h, wg, 2)")
    grid = grid.detach().float().contiguous()
    input_nhwc = input.permute(0, 2, 3, 1).contiguous()
    build.require_cuda_tensors("warp_features", input=input_nhwc, grid=grid)
    return _WarpFeaturesFn.apply(input_nhwc, grid, int(radius)).permute(0, 3, 1, 2)
