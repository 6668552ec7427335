"""MiDaS depth backbone + correspondence-weight MLP.

Counterpart of `flowmap_tpu/model/backbone/backbone_midas.py` (reference
`flowmap/model/backbone/backbone_midas.py:16-127`). Depth mapping
("original": 1e3 / (x + 0.1), "exp": exp(x / 1000) + 0.01) and the three
weight paths, taken on the JAX package's conditions:

- Native resolution (`weights_resolution="native"`, `:188-289`): the
  2x2-pooled backward flow warps the half-resolution decoder features
  (divided by 20), a 3-layer MLP with a split first layer scores each pixel,
  sigmoid then clip at 1e-4, and the scalar weight map is upsampled to full
  resolution. The warp is the shift-window kernel (`ops/kernels/shift_warp.py`)
  while the tap window is at most 256 and `warp_impl` is "fused" or "matmul";
  otherwise the bounded-radius kernel (`ops/kernels/warp_features.py`) for
  "fused" and "pallas", the windowed one-hot matmul (`ops/warp.py`) for
  "matmul", and `grid_sample_2d` for "gather". `fused_weight_mlp=True` runs
  the MLP as one kernel (`ops/kernels/weight_mlp.py`) in place of the einsum
  chain.
- Full resolution, fused (`weights_resolution="full"`, `:296-316`): with
  `warp_impl="fused"`, batch 1, 64 channels, h % 16 == 0, wn <= 128 and a
  radius of at most 6, one kernel computes the x2 upsample, the warp and
  the MLP from the native features (`ops/kernels/corr_weights.py`).
- Full resolution, unfused (`:318-364`): the features are upsampled x2 and
  divided by 20, warped at full resolution (the bounded-radius kernel for
  "fused" and "pallas", the matmul warp, or `grid_sample_2d`), and the MLP
  runs on every full-resolution pixel.

DPT_Large is not ported yet (it raises NotImplementedError).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch
import torch.nn as nn

from ...ops.geometry import earlier, later, sample_image_grid
from ...ops.grid_sample import grid_sample_2d
from ...ops.kernels.corr_weights import corr_weights, prepare_params
from ...ops.kernels.shift_warp import warp_shifts
from ...ops.kernels.warp_features import warp_features
from ...ops.kernels.weight_mlp import weight_mlp
from ...ops.resize import resize_bilinear
from ...ops.warp import warp_bilinear_matmul
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
        if cfg.weights_resolution == "native" and (2 * hn, 2 * wn) == (h, w):
            weights = self._native_weights(features, flows, b, f, h, w, dtype)
            return BackboneOutput(depths=depths, weights=weights)

        xy, _ = sample_image_grid((h, w), features.device, torch.float32)
        grid = ((xy + flows.backward.float()) * 2.0 - 1.0).detach()  # (b, f-1, h, w, 2)
        if (
            cfg.warp_impl == "fused"
            and b == 1
            and cn == 64
            and (2 * hn, 2 * wn) == (h, w)
            and h % 16 == 0
            and wn <= 128
            and cfg.warp_radius <= 6
        ):
            # Upsample, warp and MLP in one pass from the native features.
            weights = corr_weights(
                features.permute(0, 2, 3, 1),
                grid[0],
                *prepare_params(self.corr_weighter, dtype),
                cfg.warp_radius,
            )[None]
            return BackboneOutput(depths=depths, weights=weights)

        features = (resize_bilinear(features, (h, w)) / 20.0).reshape(b, f, cn, h, w)
        flat_feats = earlier(features).reshape(b * (f - 1), cn, h, w)
        flat_grid = grid.reshape(b * (f - 1), h, w, 2)
        if cfg.warp_impl in ("fused", "pallas"):
            warped = warp_features(flat_feats, flat_grid, cfg.warp_radius)
        elif cfg.warp_impl == "matmul":
            warped = warp_bilinear_matmul(flat_feats, flat_grid, radius=cfg.warp_radius)
        else:
            warped = grid_sample_2d(flat_feats, flat_grid, padding_mode="zeros")
        later_f = later(features).reshape(b * (f - 1), cn, h, w)
        logits = self._einsum_logits(warped.permute(0, 2, 3, 1), later_f.permute(0, 2, 3, 1), dtype)
        weights = torch.clamp(torch.sigmoid(logits), min=1e-4)
        return BackboneOutput(depths=depths, weights=weights.reshape(b, f - 1, h, w))

    def _einsum_logits(self, warped, later_f, dtype) -> torch.Tensor:
        """The MLP on NHWC halves as an einsum chain: f32 logits (n, h, w).
        The first layer splits: W @ [warped; later] = W_a warped + W_b later."""
        cn = warped.shape[-1]
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
        return x.float()[..., 0]

    def _native_weights(self, features, flows, b, f, h, w, dtype) -> torch.Tensor:
        """Weights from the native-resolution warp and MLP, upsampled."""
        cfg = self.cfg
        cn, hn, wn = features.shape[1:]
        # 2x2-mean-pooled backward flow and the half-resolution sampling grid.
        fb = flows.backward.float()
        fb_half = fb.reshape(b, f - 1, hn, 2, wn, 2, 2).mean(dim=(3, 5))
        xy, _ = sample_image_grid((hn, wn), fb.device, torch.float32)
        grid = ((xy + fb_half) * 2.0 - 1.0).reshape(b * (f - 1), hn, wn, 2).detach()

        radius, radius_x = self._radii()
        use_shifts = (
            cfg.warp_impl in ("fused", "matmul")
            and (2 * radius + 2) * (2 * radius_x + 2) <= 256
        )
        if use_shifts:
            feats_nhwc = features.permute(0, 2, 3, 1).reshape(b, f, hn, wn, cn) / 20.0
            earlier_f = earlier(feats_nhwc).reshape(b * (f - 1), hn, wn, cn).contiguous()
            warped = warp_shifts(earlier_f, grid.contiguous(), radius, radius_x)
            later_f = later(feats_nhwc).reshape(b * (f - 1), hn, wn, cn)
        else:
            feats = (features / 20.0).reshape(b, f, cn, hn, wn)
            flat_feats = earlier(feats).reshape(b * (f - 1), cn, hn, wn)
            if cfg.warp_impl in ("fused", "pallas"):
                warped = warp_features(flat_feats, grid, radius)
            elif cfg.warp_impl == "matmul":
                warped = warp_bilinear_matmul(flat_feats, grid, radius=radius)
            else:
                warped = grid_sample_2d(flat_feats, grid, padding_mode="zeros")
            warped = warped.permute(0, 2, 3, 1)
            later_f = later(feats).reshape(b * (f - 1), cn, hn, wn).permute(0, 2, 3, 1)

        if cfg.fused_weight_mlp and len(self.corr_weighter) == 3:
            # The fused per-pixel MLP: no 128- or 64-wide intermediate
            # reaches device memory.
            l0, l1, l2 = self.corr_weighter
            n_pix = b * (f - 1) * hn * wn

            def bias(layer):
                return layer.bias.to(dtype).float()

            logits = weight_mlp(
                warped.reshape(n_pix, cn), later_f.reshape(n_pix, cn),
                l0.weight.to(dtype), bias(l0), l1.weight.to(dtype), bias(l1),
                l2.weight.to(dtype), bias(l2),
            ).reshape(b * (f - 1), hn, wn)
        else:
            logits = self._einsum_logits(warped, later_f, dtype)
        weights_half = torch.clamp(torch.sigmoid(logits), min=1e-4)
        weights = resize_bilinear(weights_half[:, None], (h, w))[:, 0]
        return weights.reshape(b, f - 1, h, w)
