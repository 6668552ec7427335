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
class Tracks:
    """Point tracks for one temporal segment: every `interval` frames a
    (grid x grid) query grid tracked over a +-radius window."""

    xy: torch.Tensor  # (b, f, p, 2) normalized [0, 1] coordinates
    visibility: torch.Tensor  # (b, f, p) bool
    start_frame: int = 0


@dataclass
class TracksPacked:
    """All track segments stacked with a uniform window length.

    The segments' frame windows are ragged (boundary windows are shorter);
    packing pads each to a common length `l` with visibility False, which
    leaves the loss unchanged, and records each segment's start frame.
    """

    xy: torch.Tensor  # (b, s, l, p, 2)
    visibility: torch.Tensor  # (b, s, l, p) bool
    starts: torch.Tensor  # (s,) int; starts[i] + l <= num_frames
    _frame_index: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)

    def frame_index(self) -> torch.Tensor:
        """(s, l) video frame of every window slot. The tracks are constant
        over a scene, so the index is built once and kept."""
        if self._frame_index is None:
            length = self.xy.shape[2]
            offsets = torch.arange(length, device=self.starts.device)
            self._frame_index = self.starts.long()[:, None] + offsets
        return self._frame_index


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

