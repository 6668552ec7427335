"""Core data types: plain dataclasses of tensors.

Layouts are those of `flowmap_tpu/types.py` (and of the reference):

- videos:      (batch, frame, 3, height, width), float32 in [0, 1]
- depths:      (batch, frame, height, width)
- flows:       (batch, frame-1, height, width, 2), normalized [0,1] coords delta
- intrinsics:  (..., 3, 3), normalized (focal/principal divided by image size)
- extrinsics:  (..., 4, 4), camera-to-world (OpenCV convention)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Batch:
    """One video clip (or a batch of clips) plus optional ground truth."""

    videos: torch.Tensor  # (b, f, 3, h, w)
    indices: torch.Tensor  # (b, f)
    extrinsics: Optional[torch.Tensor] = None  # (b, f, 4, 4)
    intrinsics: Optional[torch.Tensor] = None  # (b, f, 3, 3)
    scenes: tuple[str, ...] = field(default=())
    datasets: tuple[str, ...] = field(default=())


@dataclass
class Flows:
    """Bidirectional optical flow in normalized [0,1] coordinates.

    forward[b, i] maps frame i -> i+1; backward[b, i] maps frame i+1 -> i.
    Masks are soft validity weights.
    """

    forward: torch.Tensor  # (b, p, h, w, 2)
    backward: torch.Tensor  # (b, p, h, w, 2)
    forward_mask: torch.Tensor  # (b, p, h, w)
    backward_mask: torch.Tensor  # (b, p, h, w)


@dataclass
class BackboneOutput:
    depths: torch.Tensor  # (b, f, h, w)
    weights: torch.Tensor  # (b, p, h, w) backward correspondence weights


@dataclass
class ModelOutput:
    depths: torch.Tensor  # (b, f, h, w)
    surfaces: torch.Tensor  # (b, f, h, w, 3) camera-space point clouds
    intrinsics: torch.Tensor  # (b, f, 3, 3)
    extrinsics: torch.Tensor  # (b, f, 4, 4)
    backward_correspondence_weights: torch.Tensor  # (b, p, h, w)

