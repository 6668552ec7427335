"""Bilinear sampling with `F.grid_sample(align_corners=False)` semantics.

Counterpart of `flowmap_tpu/ops/grid_sample.py`. `grid_sample_points`
samples an (n, c, h, w) image at a flat list of normalized [0, 1] xy points:
the JAX package writes it as one-hot matmuls for the TPU; here it is the
direct four-corner gather, with "border" clamping corner indices into the
image and "zeros" dropping out-of-range corners. `grid_sample_2d` is the
dense form over a [-1, 1] grid, which the JAX package reimplements and
PyTorch has as `F.grid_sample`. `bilinear_onehot_weights` is the one-hot
weight matrix of the JAX formulation, kept for the plain version of the
track-loss kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(
    input: torch.Tensor,  # (n, c, h, w)
    grid: torch.Tensor,  # (n, hg, wg, 2) in [-1, 1], xy order
    padding_mode: str = "border",
) -> torch.Tensor:  # (n, c, hg, wg)
    """Bilinear sample `input` at `grid` locations. The arithmetic runs in the
    wider of the two dtypes, so a float32 grid is not rounded to bfloat16
    features; the result has `input`'s dtype."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    dtype = torch.promote_types(input.dtype, grid.dtype)
    out = F.grid_sample(
        input.to(dtype), grid.to(dtype), mode="bilinear", padding_mode=padding_mode,
        align_corners=False,
    )
    return out.to(input.dtype)


def bilinear_onehot_weights(
    coords: torch.Tensor,  # (..., p) pixel coordinates
    size: int,
    padding_mode: str,
    dtype: torch.dtype,
) -> torch.Tensor:  # (..., p, size)
    """One-hot-pair bilinear weight matrix along one axis.

    W[..., p, i] = (1 - t) * 1[i == floor(c_p)] + t * 1[i == floor(c_p) + 1],
    with "border" clamping both corners into range (coincident corners sum
    their weights, as the gather form does) and "zeros" dropping
    out-of-range corners (no index matches)."""
    c0 = torch.floor(coords)
    t = (coords - c0)[..., None]
    c0i = c0.long()
    c1i = c0i + 1
    if padding_mode == "border":
        c0i = c0i.clamp(0, size - 1)
        c1i = c1i.clamp(0, size - 1)
    idx = torch.arange(size, device=coords.device)
    w0 = (idx == c0i[..., None]).to(dtype)
    w1 = (idx == c1i[..., None]).to(dtype)
    return (w0 * (1.0 - t) + w1 * t).to(dtype)


def grid_sample_points(
    input: torch.Tensor,  # (n, c, h, w)
    xy: torch.Tensor,  # (n, p, 2) normalized [0, 1]
    padding_mode: str = "border",
) -> torch.Tensor:  # (n, c, p)
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    n, c, h, w = input.shape
    p = xy.shape[1]
    x = xy[..., 0] * w - 0.5
    y = xy[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0).to(input.dtype)[:, None]
    ty = (y - y0).to(input.dtype)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    flat = input.reshape(n, c, h * w)

    def corner(yi, xi):
        v = torch.gather(
            flat,
            2,
            (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))[:, None].expand(n, c, p),
        )
        if padding_mode == "zeros":
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            v = v * inside[:, None].to(v.dtype)
        return v

    top = corner(y0i, x0i) * (1.0 - tx) + corner(y0i, x0i + 1) * tx
    bottom = corner(y0i + 1, x0i) * (1.0 - tx) + corner(y0i + 1, x0i + 1) * tx
    return top * (1.0 - ty) + bottom * ty
