"""Point-track precomputation: segment scheduling, caching, packing, predictors.

Counterpart of `flowmap_tpu/tracking/tracking.py` (reference
`flowmap/tracking/__init__.py:31-110`): every `interval` frames a
(grid_size x grid_size) query grid is tracked over a +-`radius` window, and
the segments are cached on disk under a content hash. Tracks are made once
per scene, on the host or under `torch.no_grad()`, and returned on the
device of the batch. The CoTracker predictor is not ported yet; the flow
chain (`tracker_flow_chain.py`) and precomputed tracks are.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Optional, Union

import numpy as np
import torch

from ..types import Batch, Flows, Tracks, TracksPacked
from .tracker_flow_chain import (
    TrackPredictorFlowChainCfg,
    generate_video_tracks_flow_chain,
)


@dataclass(frozen=True)
class TrackPredictorCoTrackerCfg:
    name: Literal["cotracker"] = "cotracker"
    grid_size: int = 35
    similarity_threshold: float = 0.2
    checkpoint: Optional[Path] = None


@dataclass(frozen=True)
class TrackPredictorPrecomputedCfg:
    """Load tracks precomputed offline (npz per segment)."""

    name: Literal["precomputed"] = "precomputed"
    path: Path = Path("tracks.npz")


TrackPredictorCfg = Union[
    TrackPredictorCoTrackerCfg,
    TrackPredictorFlowChainCfg,
    TrackPredictorPrecomputedCfg,
]


@dataclass(frozen=True)
class TrackPrecomputationCfg:
    interval: int = 5
    radius: int = 20
    cache_path: Optional[Path] = None


def get_cache_key(cfg: TrackPredictorCfg, pre_cfg: TrackPrecomputationCfg, batch: Batch) -> str:
    """Content-hash cache key (reference: `tracking/__init__.py:80-99`)."""
    payload = {
        "predictor": {k: str(v) for k, v in vars(cfg).items()},
        "precomputation": {"interval": pre_cfg.interval, "radius": pre_cfg.radius},
        "scenes": list(batch.scenes),
        "shape": list(batch.videos.shape),
        "indices": batch.indices.cpu().numpy().tolist(),
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def save_tracks(path: Path, tracks: list[Tracks]) -> None:
    arrays = {}
    for i, t in enumerate(tracks):
        arrays[f"xy_{i}"] = t.xy.cpu().numpy()
        arrays[f"visibility_{i}"] = t.visibility.cpu().numpy()
        arrays[f"start_{i}"] = np.asarray(t.start_frame)
    arrays["count"] = np.asarray(len(tracks))
    np.savez_compressed(path, **arrays)


def load_tracks(path: Path, device: str | torch.device = "cpu") -> list[Tracks]:
    """The segments of an npz written by `save_tracks`, on `device`."""
    with np.load(path) as data:
        return [
            Tracks(
                xy=torch.as_tensor(data[f"xy_{i}"]).to(device),
                visibility=torch.as_tensor(data[f"visibility_{i}"]).to(device),
                start_frame=int(data[f"start_{i}"]),
            )
            for i in range(int(data["count"]))
        ]


def segment_windows(num_frames: int, interval: int, radius: int) -> list[tuple[int, int]]:
    """Segment (start, stop) windows (reference: `tracking/__init__.py:49-58`)."""
    return [
        (max(center - radius, 0), min(center + radius + 1, num_frames))
        for center in range(0, num_frames, interval)
    ]


def compute_tracks(
    batch: Batch,
    cfg: TrackPredictorCfg,
    pre_cfg: TrackPrecomputationCfg,
    flows: Optional[Flows] = None,
) -> list[Tracks]:
    """Precompute per-segment tracks, with optional disk caching."""
    device = batch.videos.device
    if isinstance(cfg, TrackPredictorPrecomputedCfg):
        return load_tracks(cfg.path, device)

    cache_file = None
    if pre_cfg.cache_path is not None:
        key = get_cache_key(cfg, pre_cfg, batch)
        cache_file = Path(pre_cfg.cache_path) / f"{key}.npz"
        if cache_file.exists():
            return load_tracks(cache_file, device)

    if isinstance(cfg, TrackPredictorFlowChainCfg):
        if flows is None:
            raise ValueError("the flow_chain tracker needs precomputed flows")
        tracks = generate_video_tracks_flow_chain(
            batch, flows, cfg, pre_cfg.interval, pre_cfg.radius
        )
    elif isinstance(cfg, TrackPredictorCoTrackerCfg):
        raise NotImplementedError(
            "the CoTracker predictor is not ported yet; use the flow_chain "
            "tracker or precomputed tracks"
        )
    else:
        raise ValueError(f"unknown track predictor cfg: {cfg}")

    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        save_tracks(cache_file, tracks)
    return tracks


def pack_tracks(segments: list[Tracks], num_frames: int) -> TracksPacked:
    """Pack ragged segments into a uniform-window `TracksPacked`.

    The common window length is the longest segment's; each segment's start
    is clamped so start + length <= num_frames, its frames are placed at the
    matching offsets, and padding frames get xy 0.5 and visibility False, so
    the loss is that of the ragged form.
    """
    if not segments:
        raise ValueError("cannot pack an empty segment list")
    b, _, p, _ = segments[0].xy.shape
    device = segments[0].xy.device
    length = min(max(t.xy.shape[1] for t in segments), num_frames)

    xys, vis, starts = [], [], []
    for t in segments:
        fs = t.xy.shape[1]
        start = min(t.start_frame, num_frames - length)
        offset = t.start_frame - start
        xy = np.full((b, length, p, 2), 0.5, np.float32)
        v = np.zeros((b, length, p), bool)
        xy[:, offset : offset + fs] = t.xy.cpu().numpy()
        v[:, offset : offset + fs] = t.visibility.cpu().numpy()
        xys.append(xy)
        vis.append(v)
        starts.append(start)

    return TracksPacked(
        xy=torch.as_tensor(np.stack(xys, axis=1)).to(device),
        visibility=torch.as_tensor(np.stack(vis, axis=1)).to(device),
        starts=torch.as_tensor(starts, dtype=torch.int32).to(device),
    )
