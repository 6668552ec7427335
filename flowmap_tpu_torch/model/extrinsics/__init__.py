from .extrinsics import (
    ExtrinsicsCfg,
    ExtrinsicsParams,
    ExtrinsicsProcrustesCfg,
    ExtrinsicsRegressedCfg,
    apply_extrinsics,
)

__all__ = [
    "ExtrinsicsCfg",
    "ExtrinsicsParams",
    "ExtrinsicsProcrustesCfg",
    "ExtrinsicsRegressedCfg",
    "apply_extrinsics",
]
