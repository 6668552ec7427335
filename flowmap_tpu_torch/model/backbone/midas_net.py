"""MiDaS v2.1 small (EfficientNet-Lite3 encoder + RefineNet decoder) in PyTorch.

Counterpart of `flowmap_tpu/model/backbone/midas_net.py`, started from the
test oracle `tests/torch_midas_replica.py`. Module and parameter names
mirror the JAX parameter dict (`encoder.blocks.3.dw_conv`, `refinenet1.rcu2`,
`head.conv1`, ...) so `utils/params.py:from_jax_params` is a mechanical key
and layout mapping. Layout is NCHW. Details kept from the JAX package:

- stride-2 convolutions use XLA/TF "SAME" padding, asymmetric with more on
  the bottom and right (PyTorch's symmetric `padding=` would be wrong);
- batch-statistics BatchNorm in f32 with the two-pass variance and eps 1e-3,
  or BN folded into the preceding conv's bias (`bn="folded"`);
- ReLU6 is a clip whose gradient splits at ties like `jnp.clip`'s;
- each FeatureFusion block applies its 1x1 conv before the
  align_corners=True x2 upsample (exact: the conv commutes with the convex
  interpolation weights);
- the head is the parity composition of (x2 upsample, align_corners=False)
  and conv2: an interior computed by the head kernel
  (`ops/kernels/head_kernel.py`), exact border strips, and a splice.
  With the "exp" depth mapping there is no final ReLU.

Parameters stay float32; the forward casts them to the input's dtype
(`compute_dtype`), as the JAX package casts its parameter tree. Activations
are channels_last: cuDNN then takes the depthwise convolutions and the
upsample runs PyTorch's NHWC kernel (the NCHW bf16 depthwise and upsample
kernels are several times slower).
"""

from __future__ import annotations

import functools
from typing import Literal, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.kernels.head_kernel import head_interior

# (expand_ratio, channels, repeats, stride, kernel) per stage (lite3).
_LITE3_STAGES = [
    (1, 24, 1, 1, 3),
    (6, 32, 3, 2, 3),
    (6, 48, 3, 2, 5),
    (6, 96, 5, 2, 3),
    (6, 136, 5, 1, 5),
    (6, 232, 6, 2, 5),
    (6, 384, 1, 1, 3),
]
_STEM_CHANNELS = 32
_TAP_CHANNELS = (32, 48, 136, 384)
_RN_CHANNELS = (64, 128, 256, 512)


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class Conv(nn.Module):
    """Convolution parameters (OIHW weight, optional bias); He-normal init."""

    def __init__(self, cin, cout, k, groups=1, bias=True, generator=None):
        super().__init__()
        fan_in = cin // groups * k * k
        self.weight = nn.Parameter(
            _normal((cout, cin // groups, k, k), (2.0 / fan_in) ** 0.5, generator)
        )
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.groups = groups

    def forward(self, x, stride: int = 1, padding: str = "same"):
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        k = w.shape[-1]
        if padding == "same":
            if stride == 1:
                return F.conv2d(x, w, b, padding=k // 2, groups=self.groups)
            x = F.pad(x, _same_pad(x.shape[-1], k, stride) + _same_pad(x.shape[-2], k, stride))
        return F.conv2d(x, w, b, stride=stride, groups=self.groups)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA SAME padding along one axis: lo = total // 2, the rest on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """Batch-statistics normalization (training mode), f32 statistics."""

    def __init__(self, c, eps=1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))  # the JAX package's "scale"
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(0, 2, 3), keepdim=True)
        gamma = self.weight.to(x.dtype)[None, :, None, None]
        beta = self.bias.to(x.dtype)[None, :, None, None]
        scale = (torch.rsqrt(var + self.eps) * gamma).to(x.dtype)
        bias = (beta - mean * scale).to(x.dtype)
        return x * scale + bias


def _bn(bn: Optional[BatchNorm], x):
    return x if bn is None else bn(x)


class _ReLU6(torch.autograd.Function):
    """clip(x, 0, 6) with `jnp.clip`'s gradient: 1 inside, 0 outside, and 1/2
    at x == 0 or x == 6 (where PyTorch's clamp gives 1), written as
    (sign(x) - sign(x - 6)) / 2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 6.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = torch.sign(x)
        d.sub_(torch.sign(x - 6.0)).mul_(0.5)
        return g * d


def relu6(x):
    return _ReLU6.apply(x)


class MBConv(nn.Module):
    def __init__(self, cin, cout, expand, kernel, stride, fold_bn, generator):
        super().__init__()
        mid = cin * expand
        self.expand_conv = (
            Conv(cin, mid, 1, bias=fold_bn, generator=generator) if expand != 1 else None
        )
        self.expand_bn = BatchNorm(mid) if expand != 1 and not fold_bn else None
        self.dw_conv = Conv(mid, mid, kernel, groups=mid, bias=fold_bn, generator=generator)
        self.dw_bn = None if fold_bn else BatchNorm(mid)
        self.project_conv = Conv(mid, cout, 1, bias=fold_bn, generator=generator)
        self.project_bn = None if fold_bn else BatchNorm(cout)
        self.stride = stride
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        shortcut = x
        if self.expand_conv is not None:
            x = relu6(_bn(self.expand_bn, self.expand_conv(x)))
        x = relu6(_bn(self.dw_bn, self.dw_conv(x, stride=self.stride)))
        x = _bn(self.project_bn, self.project_conv(x))
        if self.residual:
            x = x + shortcut
        return x


class Encoder(nn.Module):
    def __init__(self, fold_bn, generator):
        super().__init__()
        self.stem_conv = Conv(3, _STEM_CHANNELS, 3, bias=fold_bn, generator=generator)
        self.stem_bn = None if fold_bn else BatchNorm(_STEM_CHANNELS)
        blocks = []
        cin = _STEM_CHANNELS
        for expand, cout, repeats, stride, kernel in _LITE3_STAGES:
            for r in range(repeats):
                blocks.append(
                    MBConv(cin, cout, expand, kernel, stride if r == 0 else 1,
                           fold_bn, generator)
                )
                cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        """The four tapped feature maps (after stages 1, 2, 4 and 6)."""
        x = relu6(_bn(self.stem_bn, self.stem_conv(x, stride=2)))
        taps = []
        idx = 0
        for s, (_, _, repeats, _, _) in enumerate(_LITE3_STAGES):
            for _ in range(repeats):
                x = self.blocks[idx](x)
                idx += 1
            if s in (1, 2, 4, 6):
                taps.append(x)
        return taps


class ResidualConvUnit(nn.Module):
    def __init__(self, c, generator):
        super().__init__()
        self.conv1 = Conv(c, c, 3, generator=generator)
        self.conv2 = Conv(c, c, 3, generator=generator)

    def forward(self, x):
        y = self.conv1(torch.relu(x))
        y = self.conv2(torch.relu(y))
        return x + y


class FeatureFusion(nn.Module):
    def __init__(self, c, c_out, generator):
        super().__init__()
        self.rcu1 = ResidualConvUnit(c, generator)
        self.rcu2 = ResidualConvUnit(c, generator)
        self.out_conv = Conv(c, c_out, 1, generator=generator)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = self.out_conv(x)  # 1x1 before the upsample (exact, 4x cheaper)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


# Parity composition of (x2 bilinear upsample, align_corners=False) and a
# 3x3 conv: B[p, dm, dy] mixes the upsample taps (0.25 / 0.75) with the conv
# taps for output row parity p and input row offset dm in (-1, 0, 1).
_UP2_B = np.asarray(
    [
        [[0.75, 0.25, 0.0], [0.25, 0.75, 0.75], [0.0, 0.0, 0.25]],
        [[0.25, 0.0, 0.0], [0.75, 0.75, 0.25], [0.0, 0.25, 0.75]],
    ],
    np.float32,
)


@functools.lru_cache(maxsize=8)
def _up2_b(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_UP2_B, device=device)


def head_parity_kernel(w2: torch.Tensor) -> torch.Tensor:
    """(cout, cin, 3, 3) conv2 -> (4*cout, cin, 3, 3) f32 phase kernel,
    output channel (2p + q) * cout + o."""
    b = _up2_b(w2.device)
    k = torch.einsum("pad,qbe,oide->pqoiab", b, b, w2.float())
    cout, cin = w2.shape[:2]
    return k.reshape(4 * cout, cin, 3, 3)


@functools.lru_cache(maxsize=64)
def _interp_matrix(size_out, size_in, align_corners, dtype, device):
    """Dense (out, in) bilinear interpolation matrix (2 nonzeros per row),
    built once per shape, dtype and device (a host-to-device copy per call
    would stall the stream)."""
    if align_corners:
        src = np.arange(size_out) * ((size_in - 1) / max(size_out - 1, 1))
    else:
        src = np.clip((np.arange(size_out) + 0.5) * (size_in / size_out) - 0.5, 0, size_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, size_in - 1)
    t = src - i0
    m = np.zeros((size_out, size_in), np.float32)
    m[np.arange(size_out), i0] += 1 - t
    m[np.arange(size_out), i1] += t
    return torch.as_tensor(m, device=device).to(dtype)


def _head_tail(y, b2, w3, b3):
    """(n, cout, ...) pre-bias conv2 output -> projected scalar (n, ...)."""
    y = torch.relu(y + b2.to(y.dtype).reshape(1, -1, *([1] * (y.ndim - 2))))
    return torch.einsum("nc...,c->n...", y.to(w3.dtype), w3) + b3


def _head_strips(zt, zb, zl, zr, w2, b2, w3, b3, h, w):
    """The exact two border rows/columns of the head output on each side.

    zt/zb: (n, c, 2, w) top/bottom z rows; zl/zr: (n, c, h, 2) left/right z
    columns. The upsample's border clamp is reproduced by the interpolation
    matrix and the 0.75/0.25 tap pair, and conv2's zero padding applies at
    the frame edge."""
    dtype = zt.dtype

    def strip(band, pad_w, pad_h):
        y = F.conv2d(F.pad(band, pad_w + pad_h), w2)
        return _head_tail(y, b2, w3, b3)

    ax = _interp_matrix(2 * w, w, False, dtype, zt.device)
    ay = _interp_matrix(2 * h, h, False, dtype, zt.device)
    q1, q3 = 0.25, 0.75  # exact in bf16

    def mix_lo(z, dim):  # rows/cols 0..2 of the upsample near the low edge
        a, b = z.narrow(dim, 0, 1), z.narrow(dim, 1, 1)
        return torch.cat([a, q3 * a + q1 * b, q1 * a + q3 * b], dim=dim)

    def mix_hi(z, dim):  # the last three rows/cols near the high edge
        a, b = z.narrow(dim, 0, 1), z.narrow(dim, 1, 1)
        return torch.cat([q3 * a + q1 * b, q1 * a + q3 * b, b], dim=dim)

    up_w = lambda band: torch.einsum("Ow,ncrw->ncrO", ax, band)  # noqa: E731
    up_h = lambda band: torch.einsum("Oh,nchr->ncOr", ay, band)  # noqa: E731
    y_top = strip(up_w(mix_lo(zt, 2)), (1, 1), (1, 0))  # (n, 2, 2w)
    y_bot = strip(up_w(mix_hi(zb, 2)), (1, 1), (0, 1))
    y_left = strip(up_h(mix_lo(zl, 3)), (1, 0), (1, 1))  # (n, 2h, 2)
    y_right = strip(up_h(mix_hi(zr, 3)), (0, 1), (1, 1))
    return y_top, y_bot, y_left, y_right


def _head_splice(y_main, strips):
    y_top, y_bot, y_left, y_right = (s.to(y_main.dtype) for s in strips)
    y = torch.cat([y_top, y_main[:, 2:-2], y_bot], dim=1)
    return torch.cat([y_left, y[:, :, 2:-2], y_right], dim=2)


def head_forward(path1: torch.Tensor, head: nn.ModuleDict) -> torch.Tensor:
    """MiDaS head on (n, 64, h, w) decoder features -> (n, 2h, 2w) float32.

    Kernel interior (`head_interior`) plus exact XLA-style border strips
    computed from thin conv1 bands, spliced over the interior's invalid
    border (`flowmap_tpu/model/backbone/midas_net.py:442-477`)."""
    n, _, h, w = path1.shape
    dtype = path1.dtype
    k1 = head["conv1"].weight.to(dtype)
    b1 = head["conv1"].bias.to(dtype)
    w2 = head["conv2"].weight.to(dtype)
    b2 = head["conv2"].bias.to(dtype)
    w3 = head["conv3"].weight[0, :, 0, 0].to(dtype)
    b3 = head["conv3"].bias[0].to(dtype)

    y4 = head_interior(path1.contiguous(), k1, b1, head_parity_kernel(w2), b2, w3, b3)
    y_main = y4.reshape(n, 2, 2, h, w).permute(0, 3, 1, 4, 2).reshape(n, 2 * h, 2 * w)

    def band(x, pad_w, pad_h):
        return F.conv2d(F.pad(x, pad_w + pad_h), k1) + b1[None, :, None, None]

    zt = band(path1[:, :, 0:3], (1, 1), (1, 0))
    zb = band(path1[:, :, -3:], (1, 1), (0, 1))
    zl = band(path1[:, :, :, 0:3], (1, 0), (1, 1))
    zr = band(path1[:, :, :, -3:], (0, 1), (1, 1))
    return _head_splice(y_main, _head_strips(zt, zb, zl, zr, w2, b2, w3, b3, h, w))


class MidasSmall(nn.Module):
    def __init__(self, fold_bn: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(fold_bn, generator)
        self.scratch = nn.ModuleDict({
            f"layer{i + 1}_rn": Conv(
                _TAP_CHANNELS[i], _RN_CHANNELS[i], 3, bias=False, generator=generator
            )
            for i in range(4)
        })
        self.refinenet4 = FeatureFusion(512, 256, generator)
        self.refinenet3 = FeatureFusion(256, 128, generator)
        self.refinenet2 = FeatureFusion(128, 64, generator)
        self.refinenet1 = FeatureFusion(64, 64, generator)
        self.head = nn.ModuleDict({
            "conv1": Conv(64, 32, 3, generator=generator),
            "conv2": Conv(32, 32, 3, generator=generator),
            "conv3": Conv(32, 1, 1, generator=generator),
        })

    def forward(
        self, images: torch.Tensor, mapping: Literal["original", "exp"] = "original"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(head output (n, h, w) f32, penultimate features (n, 64, h/2, w/2)).

        The features feed the correspondence MLP; the head output feeds the
        depth mapping (reference `backbone_midas.py:57-58`)."""
        l1, l2, l3, l4 = self.encoder(images.contiguous(memory_format=torch.channels_last))
        s = self.scratch
        path4 = self.refinenet4(s["layer4_rn"](l4))
        path3 = self.refinenet3(path4, s["layer3_rn"](l3))
        path2 = self.refinenet2(path3, s["layer2_rn"](l2))
        path1 = self.refinenet1(path2, s["layer1_rn"](l1))  # (n, 64, h/2, w/2)
        y = head_forward(path1, self.head)
        if mapping == "original":
            y = torch.relu(y)
        return y, path1
