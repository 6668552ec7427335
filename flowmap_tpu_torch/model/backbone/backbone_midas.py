"""MiDaS depth backbone + correspondence-weight MLP (native-resolution weights).

Counterpart of `flowmap_tpu/model/backbone/backbone_midas.py` (reference
`flowmap/model/backbone/backbone_midas.py:16-127`). Depth mapping
("original": 1e3 / (x + 0.1), "exp": exp(x / 1000) + 0.01) and the
native-resolution weight path (`:188-289`): the 2x2-pooled backward flow
warps the half-resolution decoder features (NHWC, divided by 20) with the
shift-window warp kernel (`ops/kernels/shift_warp.py`), a 3-layer MLP with a
split first layer scores each pixel, sigmoid then clip at 1e-4, and the
scalar weight map is upsampled to full resolution.

Not ported yet (they raise NotImplementedError): the bounded-radius NCHW
warp taken when the shift tap window exceeds 256 (`warp_features`, Pallas
kernel E), the full-resolution weight path (`weights_resolution="full"`,
kernel H), the fused weight-MLP option (kernel I), and DPT_Large.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch
import torch.nn as nn

from ...ops.geometry import earlier, later, sample_image_grid
from ...ops.kernels.shift_warp import warp_shifts
from ...ops.resize import resize_bilinear
from ...types import BackboneOutput, Batch, Flows
from .midas_net import MidasSmall


@dataclass(frozen=True)
class BackboneMidasCfg:
    name: Literal["midas"] = "midas"
    weight_sensitivity: Optional[float] = None
    mapping: Literal["original", "exp"] = "original"
    model: Literal["DPT_Large", "MiDaS_small"] = "MiDaS_small"
    compute_dtype: Literal["float32", "bfloat16"] = "bfloat16"
    bn: Literal["batch", "folded"] = "batch"
    warp_impl: Literal["fused", "pallas", "matmul", "gather"] = "fused"
    warp_radius: int = 16
    warp_radius_x: int = 16
    warp_radius_half: Optional[int] = None
    warp_radius_half_x: Optional[int] = None
    fused_weight_mlp: bool = False
    weights_resolution: Literal["full", "native"] = "native"


_WEIGHT_CHANNELS = {"MiDaS_small": 64, "DPT_Large": 256}


def _linear(din, dout, generator):
    """Kaiming-normal (fan_in, relu) weights and zero bias, like `make_net`."""
    layer = nn.Linear(din, dout)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((dout, din), generator=generator) * (2.0 / din) ** 0.5)
        layer.bias.zero_()
    return layer


class BackboneMidas(nn.Module):
    def __init__(
        self,
        cfg: BackboneMidasCfg,
        num_frames: Optional[int] = None,
        image_shape: Optional[tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.model != "MiDaS_small":
            raise NotImplementedError("DPT_Large is not ported yet; use MiDaS_small")
        self.cfg = cfg
        self.midas = MidasSmall(fold_bn=cfg.bn == "folded", generator=generator)
        if cfg.weight_sensitivity is None:
            c = _WEIGHT_CHANNELS[cfg.model]
            dims = [c * 2, 128, 64, 1]
            self.corr_weighter = nn.ModuleList(
                _linear(dims[i], dims[i + 1], generator) for i in range(len(dims) - 1)
            )
        else:
            if num_frames is None or image_shape is None:
                raise ValueError("weight_sensitivity needs num_frames and image_shape")
            self.weights = nn.Parameter(torch.zeros((num_frames - 1, *image_shape)))

    def _radii(self) -> tuple[int, int]:
        cfg = self.cfg
        if cfg.warp_radius_half is not None:
            return max(1, cfg.warp_radius_half), max(1, cfg.warp_radius_half_x or cfg.warp_radius_half)
        return (
            max(2, (cfg.warp_radius + 1) // 2 + 1),
            max(2, (cfg.warp_radius_x + 1) // 2 + 1),
        )

    def forward(self, batch: Batch, flows: Flows) -> BackboneOutput:
        cfg = self.cfg
        b, f, _, h, w = batch.videos.shape
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        videos = batch.videos.reshape(b * f, 3, h, w).to(dtype)
        head_out, features = self.midas(videos, mapping=cfg.mapping)
        head_out = head_out.float()
        if cfg.mapping == "original":
            depths = 1e3 / (head_out + 0.1)
        else:
            depths = torch.exp(head_out / 1000.0) + 0.01
        depths = depths.reshape(b, f, h, w)

        cn, hn, wn = features.shape[1:]
        if cfg.weight_sensitivity is not None:
            weights = torch.sigmoid(cfg.weight_sensitivity * self.weights)[None]
            return BackboneOutput(depths=depths, weights=weights)
        if cfg.weights_resolution != "native" or (2 * hn, 2 * wn) != (h, w):
            raise NotImplementedError(
                "the full-resolution weight path (corr_weights / warp_features "
                "kernels) is not ported yet"
            )
        if cfg.fused_weight_mlp:
            raise NotImplementedError("the fused weight-MLP kernel is not ported yet")

        radius, radius_x = self._radii()
        use_shifts = (
            cfg.warp_impl in ("fused", "matmul")
            and (2 * radius + 2) * (2 * radius_x + 2) <= 256
        )
        if not use_shifts:
            raise NotImplementedError(
                "shift tap window above 256 (or warp_impl without the shift "
                "warp): the warp_features kernel is not ported yet"
            )

        # 2x2-mean-pooled backward flow and the half-resolution sampling grid.
        fb = flows.backward.float()
        fb_half = fb.reshape(b, f - 1, hn, 2, wn, 2, 2).mean(dim=(3, 5))
        xy, _ = sample_image_grid((hn, wn), fb.device, torch.float32)
        grid = ((xy + fb_half) * 2.0 - 1.0).reshape(b * (f - 1), hn, wn, 2)

        feats_nhwc = (features.permute(0, 2, 3, 1).reshape(b, f, hn, wn, cn) / 20.0)
        earlier_f = earlier(feats_nhwc).reshape(b * (f - 1), hn, wn, cn).contiguous()
        warped = warp_shifts(earlier_f, grid.detach().contiguous(), radius, radius_x)
        later_f = later(feats_nhwc).reshape(b * (f - 1), hn, wn, cn)

        # Split first layer: W @ [warped; later] = W_a warped + W_b later.
        layer0 = self.corr_weighter[0]
        w0 = layer0.weight.to(dtype)
        x = (
            torch.einsum("nhwc,kc->nhwk", warped, w0[:, :cn])
            + torch.einsum("nhwc,kc->nhwk", later_f, w0[:, cn:])
            + layer0.bias.to(dtype)
        )
        for layer in self.corr_weighter[1:]:
            x = torch.relu(x)
            x = x @ layer.weight.to(dtype).t() + layer.bias.to(dtype)
        logits = x.float()[..., 0]
        weights_half = torch.clamp(torch.sigmoid(logits), min=1e-4)
        weights = resize_bilinear(weights_half[:, None], (h, w))[:, 0]
        return BackboneOutput(depths=depths, weights=weights.reshape(b, f - 1, h, w))
