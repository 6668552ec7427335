"""Flow predictor configurations and dispatch.

Counterpart of `flowmap_tpu/flow/predictors.py` (reference
`flowmap/flow/__init__.py:9-33`). Predictors are frozen; `compute_flows` is
the precompute entry point, called once per scene before the optimisation,
and works on the device of the batch it is given.
`FlowPredictorPrecomputedCfg` loads flow fields computed offline. The RAFT
predictor is not ported yet: its configuration raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Optional, Union

import numpy as np
import torch

from ..types import Batch, Flows
from .common import compute_bidirectional_flow, rescale_flow, rescale_mask


@dataclass(frozen=True)
class FlowPredictorRaftCfg:
    name: Literal["raft"] = "raft"
    num_flow_updates: int = 32
    max_batch_size: int = 8
    show_progress_bar: bool = True
    checkpoint: Optional[Path] = None


@dataclass(frozen=True)
class FlowPredictorGMFlowCfg:
    name: Literal["gmflow"] = "gmflow"
    cache_path: Path = Path(".cache/gmflow_checkpoints")
    checkpoint: Optional[Path] = None  # gmflow_sintel weights: .pth, or .npz in the JAX layout
    max_batch_size: int = 8
    # bfloat16 rounds the frozen net's activations; the attention kernel
    # accumulates in float32 and the flow is float32 either way.
    compute_dtype: Literal["float32", "bfloat16"] = "float32"


@dataclass(frozen=True)
class FlowPredictorPrecomputedCfg:
    """Load flows precomputed offline (npz with forward/backward/masks)."""

    name: Literal["precomputed"] = "precomputed"
    path: Path = Path("flows.npz")


FlowPredictorCfg = Union[
    FlowPredictorRaftCfg, FlowPredictorGMFlowCfg, FlowPredictorPrecomputedCfg
]

_FIELDS = ("forward", "backward", "forward_mask", "backward_mask")


def load_precomputed_flows(
    path: Path,
    flow_shape: tuple[int, int],
    device: str | torch.device = "cpu",
) -> Flows:
    """Read an .npz of {forward, backward, forward_mask, backward_mask} in
    normalised coordinates onto `device`, rescaled to `flow_shape`."""
    with np.load(path) as data:
        flows = Flows(**{k: torch.as_tensor(data[k]).to(device) for k in _FIELDS})
    if tuple(flows.forward.shape[2:4]) != tuple(flow_shape):
        flows = Flows(
            forward=rescale_flow(flows.forward, flow_shape),
            backward=rescale_flow(flows.backward, flow_shape),
            forward_mask=rescale_mask(flows.forward_mask, flow_shape),
            backward_mask=rescale_mask(flows.backward_mask, flow_shape),
        )
    return flows


def save_flows(path: Path, flows: Flows) -> None:
    np.savez_compressed(path, **{k: getattr(flows, k).cpu().numpy() for k in _FIELDS})


def compute_flows(
    batch: Batch,
    flow_shape: tuple[int, int],
    cfg: FlowPredictorCfg,
) -> Flows:
    """Bidirectional flow for one scene at `flow_shape`, on the device of
    `batch` (reference: `flow/__init__.py:23-33`)."""
    device = batch.videos.device
    if isinstance(cfg, FlowPredictorPrecomputedCfg):
        return load_precomputed_flows(cfg.path, flow_shape, device)
    if isinstance(cfg, FlowPredictorGMFlowCfg):
        from .gmflow import GMFlowPredictor

        return compute_bidirectional_flow(GMFlowPredictor(cfg, device), batch, flow_shape)
    if isinstance(cfg, FlowPredictorRaftCfg):
        raise NotImplementedError(
            "the RAFT predictor is not ported yet; use the GMFlow predictor or "
            "precomputed flows"
        )
    raise ValueError(f"unknown flow predictor: {cfg}")
