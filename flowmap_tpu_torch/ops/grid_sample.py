"""Bilinear point sampling with `F.grid_sample(align_corners=False)` semantics.

Counterpart of `flowmap_tpu/ops/grid_sample.py:grid_sample_points`: sample
an (n, c, h, w) image at a flat list of normalized [0, 1] xy points. The
JAX package writes the sample as one-hot matmuls for the TPU; here it is the
direct four-corner gather, with "border" clamping corner indices into the
image and "zeros" dropping out-of-range corners.
"""

from __future__ import annotations

import torch


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
