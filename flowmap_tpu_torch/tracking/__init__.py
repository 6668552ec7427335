from .tracker_flow_chain import TrackPredictorFlowChainCfg
from .tracking import (
    TrackPrecomputationCfg,
    TrackPredictorCfg,
    TrackPredictorCoTrackerCfg,
    TrackPredictorPrecomputedCfg,
    compute_tracks,
    load_tracks,
    pack_tracks,
    save_tracks,
    segment_windows,
)

__all__ = [
    "TrackPrecomputationCfg",
    "TrackPredictorCfg",
    "TrackPredictorCoTrackerCfg",
    "TrackPredictorFlowChainCfg",
    "TrackPredictorPrecomputedCfg",
    "compute_tracks",
    "load_tracks",
    "pack_tracks",
    "save_tracks",
    "segment_windows",
]
