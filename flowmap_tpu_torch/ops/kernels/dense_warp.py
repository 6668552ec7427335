"""Dense bilinear image warp at unbounded coordinates: the CUDA kernel (G)
and its plain version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/dense_warp.py:141`
(`dense_warp_bilinear_planar`, and the packed entry `dense_warp_bilinear` at
`:230`; its pallas_call at `:200`). Source: `csrc/dense_warp.cu`.

`dense_warp_bilinear_planar(images (n, c, h, w), px, py (n, hg, wg))` samples
each image bilinearly at absolute pixel coordinates (align_corners=False:
valid centres in [-0.5, size - 0.5]) given as planar x and y maps, with any
displacement: it is `grid_sample_2d(images, grid)` for
`grid = (2 * (px, py) + 1) / (w, h) - 1`. "zeros" drops a corner outside the image,
"border" clamps it. The consistency mask of the flow precompute samples the
target video through it at flow-displaced positions. The result is float32.

`compute_dtype` sets the rounding of the image and of the two x weights
(float32, or bfloat16 as the JAX package's bf16 flow net uses); the y
weights, the products and the sums stay float32. The plain version rounds at
the same places. Where "border" clamps both corners of an axis onto one
pixel, that pixel's weight is 1.

Design: the TPU kernel contracts one-hot weight matrices on the matrix unit
because the TPU has no gather. On Hopper the warp is a gather, one thread
per output pixel over the image's native (c, h, w) planes, a block covering
a 32 x 8 tile of the output so that neighbouring rows' reads meet in the
SM's cache. Bound: bytes (`chip_smoke.py` computes it).

Forward only, as on the TPU: callers warp by frozen flow and consume the
result without a gradient. Dispatch is by device only: CPU tensors take the
plain version, CUDA tensors take the kernel or raise. A backward pass
through it raises `NotImplementedError` on either.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"fwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"dense_warp_fwd": [_P, _P, _P, _P] + [_I] * 8 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = {"zeros": 0, "border": 1}


def _lib():
    return build.load("dense_warp", _SIGNATURES)


def _axis(coord: torch.Tensor, size: int, padding_mode: str, round_dtype: torch.dtype):
    """The two corner indices of one axis, clamped into the image for the
    gather, and their weights (0 for a corner that "zeros" drops)."""
    c0 = torch.floor(coord)
    t = coord - c0
    # Clamped as floats first: a far-off coordinate must not overflow the int.
    i0 = c0.clamp(-2.0, float(size)).long()
    i1 = i0 + 1
    w0 = (1.0 - t).to(round_dtype).float()
    w1 = t.to(round_dtype).float()
    i0c, i1c = i0.clamp(0, size - 1), i1.clamp(0, size - 1)
    if padding_mode == "border":
        same = i0c == i1c
        w0 = torch.where(same, torch.ones_like(w0), w0)
        w1 = torch.where(same, torch.zeros_like(w1), w1)
    else:
        w0 = w0 * ((i0 >= 0) & (i0 <= size - 1)).float()
        w1 = w1 * ((i1 >= 0) & (i1 <= size - 1)).float()
    return i0c, i1c, w0, w1


def dense_warp_bilinear_planar_plain(
    images: torch.Tensor,  # (n, c, h, w)
    px: torch.Tensor,  # (n, hg, wg) pixel x
    py: torch.Tensor,  # (n, hg, wg) pixel y
    padding_mode: str = "zeros",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # (n, c, hg, wg) float32
    """The flat-take form: four gathers from the flattened planes."""
    if padding_mode not in _PADDING:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    n, c, h, w = images.shape
    hg, wg = px.shape[-2:]
    x0, x1, wx0, wx1 = _axis(px.float().reshape(n, 1, -1), w, padding_mode, compute_dtype)
    y0, y1, wy0, wy1 = _axis(py.float().reshape(n, 1, -1), h, padding_mode, torch.float32)
    flat = images.to(compute_dtype).float().reshape(n, c, h * w)

    def take(yi, xi):
        return torch.gather(flat, 2, (yi * w + xi).expand(n, c, -1))

    top = take(y0, x0) * wx0 + take(y0, x1) * wx1
    bottom = take(y1, x0) * wx0 + take(y1, x1) * wx1
    return (top * wy0 + bottom * wy1).reshape(n, c, hg, wg)


def _launch(images, px, py, padding_mode, compute_dtype):
    if compute_dtype not in _DTYPES:
        raise ValueError(f"dense_warp kernel: unsupported compute dtype {compute_dtype}")
    if images.dim() != 4 or px.dim() != 3 or px.shape != py.shape or px.shape[0] != images.shape[0]:
        raise ValueError("dense_warp kernel: images must be (n, c, h, w) and px, py (n, hg, wg)")
    n, c, h, w = images.shape
    _, hg, wg = px.shape
    if n > 65535 or -(-hg // 8) > 65535:
        raise ValueError("dense_warp kernel: n and hg / 8 must fit a grid dimension (65535)")
    images = images.detach().to(compute_dtype).contiguous()
    px = px.detach().float().contiguous()
    py = py.detach().float().contiguous()
    build.require_cuda_tensors("dense_warp", images=images, px=px, py=py)
    out = torch.empty((n, c, hg, wg), device=images.device, dtype=torch.float32)
    status = _lib().dense_warp_fwd(
        build.ptr(images), build.ptr(px), build.ptr(py), build.ptr(out),
        n, c, h, w, hg, wg, _PADDING[padding_mode], _DTYPES[compute_dtype],
        build.stream_ptr(images.device),
    )
    build.check(status, "dense_warp_fwd")
    LAUNCHES["fwd"] += 1
    return out


class _DenseWarpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, px, py, padding_mode, compute_dtype):
        if images.is_cuda:
            return _launch(images, px, py, padding_mode, compute_dtype)
        return dense_warp_bilinear_planar_plain(images, px, py, padding_mode, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "dense_warp_bilinear is forward-only (consistency-mask path; warp "
            "coordinates and output carry no gradient by construction)"
        )


def dense_warp_bilinear_planar(
    images: torch.Tensor,  # (n, c, h, w)
    px: torch.Tensor,  # (n, hg, wg) pixel x
    py: torch.Tensor,  # (n, hg, wg) pixel y
    padding_mode: str = "zeros",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # (n, c, hg, wg) float32
    """Bilinear-sample `images` at absolute pixel coordinates given as planar
    x / y maps; any displacement. Taking a gradient through it raises."""
    if padding_mode not in _PADDING:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    return _DenseWarpFn.apply(images, px, py, padding_mode, compute_dtype)


def dense_warp_bilinear(
    images: torch.Tensor,  # (n, c, h, w)
    grid_xy: torch.Tensor,  # (n, hg, wg, 2) pixel coordinates, xy order
    padding_mode: str = "zeros",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # (n, c, hg, wg) float32
    """Packed-coordinate entry over the planar one: `grid_xy` holds (x, y)
    pixel coordinates on its last axis."""
    return dense_warp_bilinear_planar(
        images, grid_xy[..., 0], grid_xy[..., 1], padding_mode, compute_dtype
    )
