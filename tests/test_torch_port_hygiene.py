"""The port stands alone: importing every module of `flowmap_tpu_torch` loads
no JAX, Flax, Optax or `flowmap_tpu` module, and neither Triton nor PIL (the
machine with the card has no PIL; kernels are built at first use), and its
entry points refuse a missing card unless the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import flowmap_tpu_torch
for mod in pkgutil.walk_packages(flowmap_tpu_torch.__path__, "flowmap_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "flowmap_tpu", "triton", "PIL")
)
print("LOADED", len([m for m in sys.modules if m.startswith("flowmap_tpu_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    assert "BAD []" in out, out
    loaded = int(out.split("LOADED ")[1].split()[0])
    assert loaded >= 47, out
    for name in ("flow.gmflow", "flow.common", "flow.predictors", "utils.cropping",
                 "ops.kernels.correlation", "ops.kernels.dense_warp"):
        assert (REPO / "flowmap_tpu_torch" / (name.replace(".", "/") + ".py")).is_file(), name


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from flowmap_tpu_torch.flow.gmflow import GMFlowPredictor
    from flowmap_tpu_torch.flow.predictors import FlowPredictorGMFlowCfg
    from flowmap_tpu_torch.training import flagship
    from flowmap_tpu_torch.utils.device import resolve_device
    from flowmap_tpu_torch.utils.synthetic import SyntheticSceneCfg, make_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scene(SyntheticSceneCfg(num_frames=2, image_shape=(8, 8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.scene(num_frames=2, image_shape=(8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.source_video(num_frames=2, image_shape=(8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GMFlowPredictor(FlowPredictorGMFlowCfg())
    assert resolve_device("cpu") == torch.device("cpu")


def test_tracks_follow_the_device_of_their_inputs():
    """The track makers, the packer and the flow-chain tracker take no device
    of their own: what they return lies where the batch and the flows lie."""
    from flowmap_tpu_torch.tracking import (
        TrackPrecomputationCfg,
        TrackPredictorFlowChainCfg,
        compute_tracks,
    )
    from flowmap_tpu_torch.training import flagship

    batch, flows, depths = flagship.scene("cpu", num_frames=4, image_shape=(16, 24))
    packed = flagship.tracks(batch, depths, interval=2, radius=1, grid_size=3)
    assert packed.xy.device == packed.visibility.device == packed.starts.device == batch.videos.device
    assert packed.frame_index() is packed.frame_index()
    chained = compute_tracks(batch, TrackPredictorFlowChainCfg(grid_size=3),
                             TrackPrecomputationCfg(interval=2, radius=1), flows)
    assert all(t.xy.device == flows.forward.device for t in chained)
    losses = flagship.loss_cfgs()
    assert [c.name for c in losses] == ["flow", "tracking"] and losses[1].enable_after == 50


def test_kernel_wrappers_refuse_a_cuda_call_they_cannot_serve():
    """Every kernel module is registered with its launch counts, and the new
    wrappers dispatch by device alone: no environment switch, no fallback."""
    import inspect

    from flowmap_tpu_torch.ops import kernels
    from flowmap_tpu_torch.ops.kernels import build, correlation, dense_warp

    assert {"softmax_expectation", "dense_warp"} <= set(kernels.KERNEL_MODULES)
    counts = kernels.launch_counts()
    assert {"softmax_expectation_fwd_d128", "softmax_expectation_fwd_d2", "dense_warp_fwd"} <= set(counts)
    assert {"correlation", "dense_warp"} <= set(build.SOURCES)
    for module in (correlation, dense_warp):
        source = inspect.getsource(module)
        assert "os.environ" not in source and "except" not in source
        assert (build.CSRC / f"{module.__name__.rsplit('.', 1)[1]}.cu").is_file()
    # On the CPU the wrappers launch nothing.
    q = torch.randn(1, 8, 16)
    correlation.softmax_expectation(q, q, torch.randn(1, 8, 2))
    dense_warp.dense_warp_bilinear(torch.rand(1, 3, 4, 4), torch.rand(1, 4, 4, 2) * 4)
    assert kernels.launch_counts() == counts
