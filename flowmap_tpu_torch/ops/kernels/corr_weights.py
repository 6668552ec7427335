"""Full-resolution correspondence weights from native-resolution features:
the CUDA kernel (H) and its plain version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/corr_weights.py:1058`
(`corr_weights`; its pallas_calls at `:468` forward, `:944` backward).
Source: `csrc/corr_weights.cu`, with the MLP in `csrc/mlp_core.cuh` (shared
with kernel I, `weight_mlp.py`).

`corr_weights(features_nhwc (f, hn, wn, 64), grid (f - 1, 2 hn, 2 wn, 2),
w0, b0, w1, b1, w2, b2, radius)` upsamples the features x2 (bilinear,
align_corners=False, edge clamp), warps the earlier frame of each pair by
the frozen grid (bilinear, zeros padding), takes the later frame at the
output pixel, and runs the weight MLP of `weight_mlp.py` on the two, then a
sigmoid and a clip at 1e-4. `w0` is the first layer already divided by 20
and rounded to the feature type (`prepare_params`), which is where the TPU
kernel folds the reference's `/ 20`. The warp keeps a bilinear corner only
while its row lies within [y - radius, y + radius + 1] of output row y, as
the warp-features kernel (E) does; the JAX oracle `corr_weights_ref` warps
through `warp_bilinear_matmul`, which clamps such a corner to the window's
edge, so the two agree wherever displacements stay within the radius.

The plain version ports `corr_weights_ref` and `mlp_weights_ref`:
`resize_bilinear` in f32, `windowed_matmul_warp(..., "drop")`, the rounding
of both branches to the feature type, and `weight_mlp_plain`; its gradient
is autograd's. On the card the upsample composed with the warp is at most
3 native taps per axis, gathered in the kernel; the backward scatters the
input cotangents with f32 atomics (last bits vary between runs) and sums the
MLP's parameter gradients as block partials in a fixed order. The wrapper
raises for `radius > 6` on the card, the TPU kernel's limit (the backbone
takes the unfused composition there). Bound: operations.

Dispatch is by device only: CPU tensors take the plain version, CUDA
tensors take the kernel or raise. The grid gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..resize import resize_bilinear
from ..warp import windowed_matmul_warp
from . import build
from .weight_mlp import C, _blocks, check_params, reduce_grads, weight_mlp_plain

LAUNCHES = {"fwd": 0, "bwd": 0}
MAX_RADIUS = 6

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "corr_weights_fwd": [_P] * 9 + [_I] * 6 + [_P],
    "corr_weights_bwd": [_P] * 11 + [_I] * 6 + [_P],
    "corr_weights_reduce": [_P, _P, _I, _P],
    "corr_weights_tile": [_I],
    "corr_weights_partial_len": [],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return build.load("corr_weights", _SIGNATURES)


def prepare_params(layers, dtype) -> tuple:
    """(w0 / 20, b0, w1, b1, w2, b2) of three `nn.Linear` layers: weights in
    `dtype` (the first divided by 20 in f32 before the rounding), biases f32."""
    l0, l1, l2 = layers
    return ((l0.weight.float() / 20.0).to(dtype), l0.bias.float(), l1.weight.to(dtype),
            l1.bias.float(), l2.weight.to(dtype), l2.bias.float())


def mlp_weights_plain(warped, later, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The MLP tail on sampled features (n, c, h, w), rounded to `w0`'s type:
    (n, h, w) weights, sigmoid then clip at 1e-4."""
    n, c, h, w = warped.shape
    dtype = w0.dtype

    def rows(x):
        return x.to(dtype).permute(0, 2, 3, 1).reshape(-1, c)

    logits = weight_mlp_plain(rows(warped), rows(later), w0, b0, w1, b1, w2, b2)
    return torch.clamp(torch.sigmoid(logits), min=1e-4).reshape(n, h, w)


def corr_weights_plain(features_nhwc, grid, w0, b0, w1, b1, w2, b2, radius: int):
    """Upsample x2, warp the earlier frames (corners beyond the radius
    dropped), MLP: (f - 1, h, w) f32; no gradient to `grid`."""
    f, hn, wn, c = features_nhwc.shape
    feats = resize_bilinear(features_nhwc.float().permute(0, 3, 1, 2), (2 * hn, 2 * wn))
    warped = windowed_matmul_warp(feats[:-1], grid.detach(), radius, "drop")
    return mlp_weights_plain(warped, feats[1:], w0, b0, w1, b1, w2, b2)


class _CorrWeightsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, grid, w0, b0, w1, b1, w2, b2, radius):
        lib = _lib()
        f, hn, wn, _ = features.shape
        n = f - 1
        code = _DTYPES[features.dtype]
        out = torch.empty((n, 2 * hn, 2 * wn), device=features.device, dtype=torch.float32)
        tiles = -(-out.numel() // lib.corr_weights_tile(code))
        status = lib.corr_weights_fwd(
            *(build.ptr(t) for t in (features, grid, w0, b0, w1, b1, w2, b2, out)),
            n, hn, wn, radius, _blocks(features.device, tiles, 2), code,
            build.stream_ptr(features.device),
        )
        build.check(status, "corr_weights_fwd")
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(features, grid, w0, b0, w1, b1, w2, b2)
        ctx.radius = radius
        return out

    @staticmethod
    def backward(ctx, g):
        features, grid, w0, b0, w1, b1, w2, b2 = ctx.saved_tensors
        lib = _lib()
        f, hn, wn, _ = features.shape
        code = _DTYPES[features.dtype]
        g = g.float().contiguous()
        d_feat = torch.zeros(features.shape, device=g.device, dtype=torch.float32)
        nblocks = _blocks(g.device, -(-g.numel() // lib.corr_weights_tile(code)), 1)
        partial = torch.empty((nblocks, lib.corr_weights_partial_len()), device=g.device,
                              dtype=torch.float32)
        stream = build.stream_ptr(g.device)
        status = lib.corr_weights_bwd(
            *(build.ptr(t) for t in (features, grid, w0, b0, w1, b1, w2, b2, g, d_feat,
                                     partial)),
            f - 1, hn, wn, ctx.radius, nblocks, code, stream,
        )
        build.check(status, "corr_weights_bwd")
        LAUNCHES["bwd"] += 1
        grads = reduce_grads(lib.corr_weights_reduce, partial, nblocks, features.dtype,
                             g.device, stream)
        return (d_feat.to(features.dtype), None) + grads + (None,)


def corr_weights(
    features_nhwc: torch.Tensor,  # (f, hn, wn, 64) float32 or bfloat16
    grid: torch.Tensor,  # (f - 1, 2 hn, 2 wn, 2) in [-1, 1], xy order
    w0: torch.Tensor,  # (128, 128) first layer / 20, in the feature type
    b0: torch.Tensor,  # (128,) float32
    w1: torch.Tensor,  # (64, 128)
    b1: torch.Tensor,  # (64,) float32
    w2: torch.Tensor,  # (1, 64)
    b2: torch.Tensor,  # (1,) float32
    radius: int,
) -> torch.Tensor:  # (f - 1, 2 hn, 2 wn) float32
    """Correspondence weights at full resolution; differentiable in the
    features and the MLP parameters, not in the grid."""
    if not features_nhwc.is_cuda:
        return corr_weights_plain(features_nhwc, grid, w0, b0, w1, b1, w2, b2, radius)
    if radius > MAX_RADIUS:
        raise ValueError(f"corr_weights kernel: radius {radius} > {MAX_RADIUS}")
    dtype = features_nhwc.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"corr_weights kernel: unsupported dtype {dtype}")
    f, hn, wn, c = features_nhwc.shape
    if c != C or f < 2 or tuple(grid.shape) != (f - 1, 2 * hn, 2 * wn, 2):
        raise ValueError("corr_weights kernel: features (f, hn, wn, 64), grid (f - 1, 2 hn, 2 wn, 2)")
    check_params("corr_weights kernel", dtype, w0, b0, w1, b1, w2, b2)
    features_nhwc = features_nhwc.contiguous()
    grid = grid.detach().float().contiguous()
    params = [t.contiguous() for t in (w0, b0, w1, b1, w2, b2)]
    build.require_cuda_tensors("corr_weights", features=features_nhwc, grid=grid, **dict(zip(
        ("w0", "b0", "w1", "b1", "w2", "b2"), params)))
    return _CorrWeightsFn.apply(features_nhwc, grid, *params, int(radius))
