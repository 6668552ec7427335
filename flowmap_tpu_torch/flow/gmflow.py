"""GMFlow (scale 1, swin attention, global matching) as `nn.Module`s.

Counterpart of `flowmap_tpu/flow/gmflow.py`, the frozen flow net of the
precompute (reference: the vendored GMFlow with feature_channels=128,
num_scales=1, attn_splits=2, global correlation and propagation):

- CNN encoder: 7x7/2 conv + InstanceNorm/ReLU, residual stages (64 at /2,
  96 at /4, 128 at /8), 1x1 to 128 channels;
- feature transformer: 6 blocks of (windowed self-attention without FFN) +
  (windowed cross-attention + FFN), 2x2 swin windows, shifted on odd layers
  with the additive mask, sine position encoding added per window;
- global correlation softmax: the expected correspondence over all
  positions;
- flow propagation: global self-attention with the flow as values;
- convex x8 upsampling over 9 neighbours.

All five softmax-attention forms go through one kernel,
`ops/kernels/correlation.py:softmax_expectation`, which never writes the
(L, L) scores to device memory; the shifted-window mask rides in as its
grouped bias, (windows per image, L, L), not tiled to the batch.

Parameter names are those of the public checkpoint's `state_dict` and the
arrays are in PyTorch's own layout (OIHW convolutions, (out, in) linears),
so a public `.pth` loads with `load_state_dict`; `load_params` also reads
the JAX package's `.npz` (HWIO, (in, out)). Activations are NCHW in the
encoder and the upsampler and (batch, tokens, channels) in between; the
public shapes keep the JAX package's conventions: `(b, 3, h, w)` images in
[0, 255] in, `(b, h, w, 2)` flow in pixels out, float32 always.
`compute_dtype=torch.bfloat16` rounds the activations (parameters cast to
match); the attention kernel accumulates in float32 either way.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.correlation import global_correlation_expectation, softmax_expectation
from ..utils.device import resolve_device
from ..utils.params import gmflow_state_dict_from_jax

FEATURE_CHANNELS = 128
NUM_LAYERS = 6
ATTN_SPLITS = 2
UPSAMPLE_FACTOR = 8

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters on NCHW, with the JAX
    package's single-pass moments: E[x^2] - E[x]^2 in float32, clamped at 0."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    meansq = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = (meansq - mean * mean).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv(x)` with the weights cast to x's dtype: under bfloat16 a float32
    value (the flow) re-enters a convolution."""
    if conv.weight.dtype == x.dtype:
        return conv(x)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_instance_norm(self.conv1(x)))
        y = F.relu(_instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = _instance_norm(self.downsample(x))
        return F.relu(x + y)


class Encoder(nn.Module):
    """(n, 3, h, w) -> (n, 128, h / 8, w / 8)."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1), ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2), ResidualBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, FEATURE_CHANNELS, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_instance_norm(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def _split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(b, h, w, c) -> (b * k * k, h / k, w / k, c), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * k * k, h // k, w // k, c)


def _merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    bkk, hk, wk, c = x.shape
    b = bkk // (k * k)
    x = x.reshape(b, k, k, hk, wk, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, k * hk, k * wk, c)


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64) -> np.ndarray:
    """Sine position encoding (h, w, 2 * num_pos_feats), y then x."""
    temperature = 10000.0
    scale = 2 * math.pi
    eps = 1e-6
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    y_embed = y_embed / (h + eps) * scale
    x_embed = x_embed / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


def shift_window_attn_mask(h: int, w: int, k: int) -> np.ndarray:
    """(k * k, L, L) additive mask of shifted-window attention: 0 where two
    positions of a window come from the same region of the rolled image,
    -100 elsewhere. Window order is `_split_windows`'s."""
    wh, ww = h // k, w // k
    sh, sw = wh // 2, ww // 2
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, h - wh), slice(h - wh, h - sh), slice(h - sh, h)):
        for ws in (slice(0, w - ww), slice(w - ww, w - sw), slice(w - sw, w)):
            img_mask[hs, ws] = cnt
            cnt += 1
    windows = img_mask.reshape(k, wh, k, ww).transpose(0, 2, 1, 3).reshape(k * k, wh * ww)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# The two constants of a resolution, built on the host once and kept on the
# device: every chunk of a scene has the same shape (the mask is 80 MB at
# 640x896).
@functools.lru_cache(maxsize=8)
def _position_on(h: int, w: int, c: int, device: torch.device, dtype: torch.dtype):
    return torch.as_tensor(position_embedding_sine(h, w, c // 2)).to(device, dtype)


@functools.lru_cache(maxsize=2)
def _shift_mask_on(h: int, w: int, k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(shift_window_attn_mask(h, w, k)).to(device)


def _feature_add_position(f0: torch.Tensor, f1: torch.Tensor, k: int):
    """Add the per-window position encoding to (b, h, w, c) features."""
    _, h, w, c = f0.shape
    pos = _position_on(h // k, w // k, c, f0.device, f0.dtype)
    return (
        _merge_windows(_split_windows(f0, k) + pos, k),
        _merge_windows(_split_windows(f1, k) + pos, k),
    )


def _window_attention(q, k_, v, num_splits: int, h: int, w: int, attn_mask):
    """Single-head swin attention over (b, L, c) tokens; shifted by half a
    window when `attn_mask` (k * k, l, l) is given."""
    b, _, c = q.shape
    q, k_, v = (t.reshape(b, h, w, c) for t in (q, k_, v))
    sh, sw = (h // num_splits) // 2, (w // num_splits) // 2
    if attn_mask is not None:
        q, k_, v = (torch.roll(t, (-sh, -sw), dims=(1, 2)) for t in (q, k_, v))
    qs, ks, vs = (_split_windows(t, num_splits) for t in (q, k_, v))
    bkk, hk, wk, _ = qs.shape
    out = softmax_expectation(
        qs.reshape(bkk, hk * wk, c), ks.reshape(bkk, hk * wk, c),
        vs.reshape(bkk, hk * wk, c), bias=attn_mask,
    ).to(q.dtype)
    out = _merge_windows(out.reshape(bkk, hk, wk, c), num_splits)
    if attn_mask is not None:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(b, h * w, c)


class TransformerLayer(nn.Module):
    """Single-head attention with an optional FFN."""

    def __init__(self, c: int, ffn: bool) -> None:
        super().__init__()
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = nn.LayerNorm(c)
        self.mlp = None
        if ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * c, 8 * c, bias=False), nn.GELU(), nn.Linear(8 * c, c, bias=False)
            )
            self.norm2 = nn.LayerNorm(c)

    def forward(self, source, target, h: int, w: int, num_splits: int, attn_mask):
        query, key, value = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if num_splits > 1:
            message = _window_attention(query, key, value, num_splits, h, w, attn_mask)
        else:
            message = softmax_expectation(query, key, value).to(query.dtype)
        message = self.norm1(self.merge(message))
        if self.mlp is not None:
            message = self.norm2(self.mlp(torch.cat([source, message], dim=-1)))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.self_attn = TransformerLayer(c, ffn=False)
        self.cross_attn_ffn = TransformerLayer(c, ffn=True)

    def forward(self, source, target, h, w, num_splits, attn_mask):
        source = self.self_attn(source, source, h, w, num_splits, attn_mask)
        return self.cross_attn_ffn(source, target, h, w, num_splits, attn_mask)


class FeatureTransformer(nn.Module):
    """Six self + cross blocks over the two images' concatenated batches."""

    def __init__(self, c: int = FEATURE_CHANNELS, num_layers: int = NUM_LAYERS) -> None:
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(c) for _ in range(num_layers))

    def forward(self, f0: torch.Tensor, f1: torch.Tensor, num_splits: int):
        b, h, w, c = f0.shape
        mask = None
        if num_splits > 1:
            mask = _shift_mask_on(h, w, num_splits, f0.device)
        concat0 = torch.cat([f0, f1], dim=0).reshape(2 * b, h * w, c)
        concat1 = torch.cat([f1, f0], dim=0).reshape(2 * b, h * w, c)
        for i, layer in enumerate(self.layers):
            concat0 = layer(concat0, concat1, h, w, num_splits, mask if i % 2 == 1 else None)
            concat1 = torch.cat([concat0[b:], concat0[:b]], dim=0)
        return concat0[:b].reshape(b, h, w, c), concat0[b:].reshape(b, h, w, c)


def coords_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) xy pixel-index grid, float32."""
    y, x = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    return torch.stack([x, y], dim=-1).float()


def global_correlation_softmax(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Flow (b, h, w, 2) as the expected correspondence under the global
    correlation softmax, minus the pixel grid."""
    b, h, w, c = f0.shape
    grid = coords_grid(h, w, f0.device)
    correspondence = global_correlation_expectation(
        f0.reshape(b, h * w, c), f1.reshape(b, h * w, c), grid.reshape(h * w, 2)
    )
    return correspondence.reshape(b, h, w, 2) - grid


class FeatureFlowAttention(nn.Module):
    """Global self-attention with the flow as values. The key is
    `k_proj(q_proj(x))`, the reference's own composition, kept as it is."""

    def __init__(self, c: int = FEATURE_CHANNELS) -> None:
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feature0.shape
        query = self.q_proj(feature0.reshape(b, h * w, c))
        key = self.k_proj(query)
        out = softmax_expectation(query, key, flow.reshape(b, h * w, 2).float())
        return out.reshape(b, h, w, 2)


def upsample_flow_convex(upsampler: nn.Sequential, flow: torch.Tensor, feature: torch.Tensor):
    """Convex x8 upsampling: (b, h, w, 2) flow and (b, h, w, c) features to
    (b, 8h, 8w, 2). The 576 mask channels are n-major (n * 64 + u * 8 + v):
    a softmax over the 9 neighbours n of every subpixel (u, v), then a pixel
    shuffle of (u, v)."""
    b, h, w, _ = flow.shape
    k = UPSAMPLE_FACTOR
    concat = torch.cat([flow, feature], dim=-1).permute(0, 3, 1, 2)
    mask = F.relu(_conv(upsampler[0], concat))
    mask = _conv(upsampler[2], mask).reshape(b, 9, k * k, h, w)
    # The peak is subtracted in the compute dtype, the rest is float32.
    exps = torch.exp((mask - mask.amax(dim=1, keepdim=True)).float())
    inv = 1.0 / exps.sum(dim=1)
    fk = (flow * k).float().permute(0, 3, 1, 2)
    shifted = F.unfold(fk, 3, padding=1).reshape(b, 2, 9, 1, h, w)
    up = (exps[:, None] * shifted).sum(dim=2) * inv[:, None]  # (b, 2, k * k, h, w)
    up = up.reshape(b, 2, k, k, h, w).permute(0, 4, 2, 5, 3, 1)
    return up.reshape(b, h * k, w * k, 2)


class GMFlow(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.backbone = Encoder()
        self.transformer = FeatureTransformer()
        self.feature_flow_attn = FeatureFlowAttention()
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + FEATURE_CHANNELS, 256, 3, 1, 1),
            nn.ReLU(),
            nn.Conv2d(256, UPSAMPLE_FACTOR**2 * 9, 1),
        )

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.backbone.conv1.weight.dtype

    def features(self, img0: torch.Tensor, img1: torch.Tensor):
        """Encoder features of both images, (b, h / 8, w / 8, c) each."""
        mean = torch.tensor(_IMAGENET_MEAN, device=img0.device).reshape(1, 3, 1, 1) * 255.0
        std = torch.tensor(_IMAGENET_STD, device=img0.device).reshape(1, 3, 1, 1) * 255.0
        both = torch.cat([(img0 - mean) / std, (img1 - mean) / std], dim=0)
        features = self.backbone(both.to(self.compute_dtype)).permute(0, 2, 3, 1)
        b = img0.shape[0]
        return features[:b], features[b:]

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Forward flow in pixels at full resolution, (b, h, w, 2) float32,
        from (b, 3, h, w) images in [0, 255]; h and w divisible by 16."""
        f0, f1 = self.features(img0, img1)
        f0, f1 = _feature_add_position(f0, f1, ATTN_SPLITS)
        f0, f1 = self.transformer(f0, f1, ATTN_SPLITS)
        flow = global_correlation_softmax(f0, f1)
        flow = self.feature_flow_attn(f0, flow.detach())
        return upsample_flow_convex(self.upsampler, flow, f0).float()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params_(model: GMFlow, generator: torch.Generator) -> GMFlow:
    """Random initial weights in place, drawn from `generator` on the CPU:
    uniform matrices and convolutions with the JAX package's bound
    sqrt(6 / (k * k * in + out)), zero biases, unit norm scales."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if "norm" in name and name.endswith("weight") else 0.0)
                continue
            receptive = int(np.prod(p.shape[2:]))
            bound = (6.0 / (receptive * p.shape[1] + p.shape[0])) ** 0.5
            p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)
    return model


def load_params(path) -> dict[str, torch.Tensor]:
    """State dict of a converted `.npz` (the JAX package's layout) or of a
    torch `.pth` checkpoint (the public one keeps its weights under "model")."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return gmflow_state_dict_from_jax({k: data[k] for k in data.files})
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    weights = checkpoint.get("model", checkpoint)
    wanted = GMFlow().state_dict().keys()
    return {name: weights[name].float() for name in wanted}


class GMFlowPredictor:
    """Flow-predictor interface: (b, f, 3, h, w) videos in [0, 1] ->
    (b, f - 1, h, w, 2) normalised flow between consecutive frames.

    Frame pairs go through the net in chunks of `max_batch_size`: at flow
    resolution the activations of all pairs at once would not fit. The last
    chunk is simply smaller (every operation of the net is per sample, so
    the flows are those of the JAX package's padded chunk). The net is
    frozen: evaluation mode, no gradients. Without a checkpoint the weights
    are random, drawn from `seed`."""

    def __init__(self, cfg, device: str | torch.device = "cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        model = GMFlow()
        checkpoint = getattr(cfg, "checkpoint", None)
        if checkpoint is not None:
            model.load_state_dict(load_params(checkpoint))
        else:
            init_params_(model, torch.Generator().manual_seed(seed))
        self.compute_dtype = getattr(torch, getattr(cfg, "compute_dtype", "float32"))
        self.max_batch_size = getattr(cfg, "max_batch_size", 8)
        self.model = model.to(self.device, self.compute_dtype).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, videos: torch.Tensor) -> torch.Tensor:
        b, f, c, h, w = videos.shape
        videos = videos.to(self.device)
        source = videos[:, :-1].reshape(b * (f - 1), c, h, w)
        target = videos[:, 1:].reshape(b * (f - 1), c, h, w)
        size = self.max_batch_size
        flow = torch.cat([
            self.model(source[i : i + size] * 255.0, target[i : i + size] * 255.0)
            for i in range(0, source.shape[0], size)
        ], dim=0)
        wh = torch.tensor([w, h], dtype=flow.dtype, device=flow.device)
        return (flow / wh).reshape(b, f - 1, h, w, 2)
