from .intrinsics import (
    IntrinsicsCfg,
    IntrinsicsGroundTruthCfg,
    IntrinsicsParams,
    IntrinsicsRegressedCfg,
    IntrinsicsSoftminCfg,
    IntrinsicsState,
    RegressionCfg,
    apply_intrinsics,
    init_intrinsics_state,
    maybe_handoff_focal,
)

__all__ = [
    "IntrinsicsCfg",
    "IntrinsicsGroundTruthCfg",
    "IntrinsicsParams",
    "IntrinsicsRegressedCfg",
    "IntrinsicsSoftminCfg",
    "IntrinsicsState",
    "RegressionCfg",
    "apply_intrinsics",
    "init_intrinsics_state",
    "maybe_handoff_focal",
]
