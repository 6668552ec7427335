"""The bench's flagship configuration as the port runs it (`bench.py:93-104`).

A 150-frame 160x224 synthetic scene; MiDaS-small with folded BN, the exp
depth mapping and a bf16 compute dtype; softmin intrinsics that regress
after step 1000 over a 100-step window; Procrustes extrinsics over 1000
points; the warp radii autosized from the scene's flows. `chip_smoke.py`
and `scripts/torch_step_profile.py` both drive it.
"""

from __future__ import annotations

import torch

from ..model import (
    BackboneMidasCfg,
    ExtrinsicsProcrustesCfg,
    IntrinsicsSoftminCfg,
    ModelCfg,
    RegressionCfg,
)
from ..types import Batch, Flows
from ..utils.synthetic import SyntheticSceneCfg, make_scene
from .overfit import _autosize_warp_radius

NUM_FRAMES = 150
IMAGE_SHAPE = (160, 224)


def scene(
    device: str | torch.device = "cuda",
    num_frames: int = NUM_FRAMES,
    image_shape: tuple[int, int] = IMAGE_SHAPE,
) -> tuple[Batch, Flows, torch.Tensor]:
    """(batch, flows, GT depths) of the synthetic scene, on `device`."""
    return make_scene(SyntheticSceneCfg(num_frames=num_frames, image_shape=image_shape), device)


def model_cfg(flows: Flows, compute_dtype: str = "bfloat16") -> ModelCfg:
    """The flagship model with its warp radii sized from `flows`."""
    cfg = ModelCfg(
        backbone=BackboneMidasCfg(mapping="exp", bn="folded", compute_dtype=compute_dtype),
        intrinsics=IntrinsicsSoftminCfg(regression=RegressionCfg(after_step=1000, window=100)),
        extrinsics=ExtrinsicsProcrustesCfg(num_points=1000),
    )
    return _autosize_warp_radius(cfg, flows, flows.backward.shape[-3])
