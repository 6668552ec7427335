from .backbone import BackboneCfg, BackboneExplicitDepthCfg, BackboneMidasCfg
from .extrinsics import ExtrinsicsCfg, ExtrinsicsProcrustesCfg, ExtrinsicsRegressedCfg
from .intrinsics import (
    IntrinsicsCfg,
    IntrinsicsGroundTruthCfg,
    IntrinsicsRegressedCfg,
    IntrinsicsSoftminCfg,
    RegressionCfg,
)
from .model import FlowMapModel, ModelCfg, ModelState, forward, init_model

__all__ = [
    "BackboneCfg",
    "BackboneExplicitDepthCfg",
    "BackboneMidasCfg",
    "ExtrinsicsCfg",
    "ExtrinsicsProcrustesCfg",
    "ExtrinsicsRegressedCfg",
    "FlowMapModel",
    "IntrinsicsCfg",
    "IntrinsicsGroundTruthCfg",
    "IntrinsicsRegressedCfg",
    "IntrinsicsSoftminCfg",
    "ModelCfg",
    "ModelState",
    "RegressionCfg",
    "forward",
    "init_model",
]
