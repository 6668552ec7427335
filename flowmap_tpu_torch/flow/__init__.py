from .common import (
    compute_bidirectional_flow,
    compute_consistency_mask,
    rescale_flow,
    rescale_mask,
)
from .predictors import (
    FlowPredictorCfg,
    FlowPredictorGMFlowCfg,
    FlowPredictorPrecomputedCfg,
    FlowPredictorRaftCfg,
    compute_flows,
    load_precomputed_flows,
    save_flows,
)

__all__ = [
    "FlowPredictorCfg",
    "FlowPredictorGMFlowCfg",
    "FlowPredictorPrecomputedCfg",
    "FlowPredictorRaftCfg",
    "compute_bidirectional_flow",
    "compute_consistency_mask",
    "compute_flows",
    "load_precomputed_flows",
    "rescale_flow",
    "rescale_mask",
    "save_flows",
]
