"""`run_overfit` of the port vs flowmap_tpu's, on the two weight paths of
this slice (CPU, f32).

The first three frames of a 20-frame 64x64 synthetic scene from the JAX
package's `make_scene`, carried across as arrays; the bench's model (MiDaS-
small with folded BN, softmin intrinsics with regression, Procrustes over
1000 points) with `weights_resolution="full"` (the full-resolution radius
autosizes within 6, so "fused" takes the corr-weights path; off the TPU the
JAX package runs its XLA composition) and with `fused_weight_mlp=True` (the
flow and tracking losses on a ragged list of track segments). The softmin
sweep takes every pixel (4096), so the two packages' different random draws
of its subset only reorder a sum. Both loops start from the JAX package's
initial parameters (`init_params`), at a learning rate of 1e-6: at the
product's 3e-5 the second step of a random initialisation jumps, and with
the tracking loss the two packages then part by 2e-4 of the loss, about what
the step's own conditioning (a 1e-6 nudge moves its gradient ~1.5%) allows.
The port's loss history must agree with the reference's to 1e-4 of the
largest loss: the floor of the rule of `tests/test_torch_port_slice.py`
without its allowance of three times the reference's own
1e-6-perturbation spread, so a tighter bound (the perturbed reference run
would cost another ~35 s of JAX compilation a variant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.loss.loss import LossFlowCfg as JLossFlowCfg
from flowmap_tpu.loss.loss import LossTrackingCfg as JLossTrackingCfg
from flowmap_tpu.model import BackboneMidasCfg as JBackboneCfg
from flowmap_tpu.model import ExtrinsicsProcrustesCfg as JExtrinsicsCfg
from flowmap_tpu.model import IntrinsicsSoftminCfg as JIntrinsicsCfg
from flowmap_tpu.model import ModelCfg as JModelCfg
from flowmap_tpu.model import RegressionCfg as JRegressionCfg
from flowmap_tpu.training.overfit import OverfitTrainerCfg as JTrainerCfg
from flowmap_tpu.training.overfit import init_train_state as j_init_train_state
from flowmap_tpu.training.overfit import run_overfit as j_run_overfit
from flowmap_tpu.utils.synthetic import SyntheticSceneCfg as JSceneCfg
from flowmap_tpu.utils.synthetic import make_scene as j_make_scene
from flowmap_tpu.utils.synthetic import make_track_segments as j_make_track_segments
from flowmap_tpu_torch.loss.loss import LossFlowCfg, LossTrackingCfg
from flowmap_tpu_torch.model import (
    BackboneMidasCfg,
    ExtrinsicsProcrustesCfg,
    IntrinsicsSoftminCfg,
    ModelCfg,
    RegressionCfg,
)
from flowmap_tpu_torch.training.overfit import OverfitTrainerCfg, run_overfit
from flowmap_tpu_torch.types import Batch, Flows
from flowmap_tpu_torch.utils.params import from_jax_params, tracks_from_numpy

torch.set_num_threads(1)

F, H, W = 3, 64, 64
STEPS = 3
LR = 1e-6
VARIANTS = {
    "full": dict(weights_resolution="full"),
    "fused_weight_mlp": dict(fused_weight_mlp=True),
}


def _scene():
    batch, flows, depths = j_make_scene(JSceneCfg(num_frames=20, image_shape=(H, W)))
    batch = batch.replace(videos=batch.videos[:, :F], indices=batch.indices[:, :F],
                          extrinsics=batch.extrinsics[:, :F], intrinsics=batch.intrinsics[:, :F])
    flows = jax.tree_util.tree_map(lambda a: a[:, : F - 1], flows)
    return batch, flows, depths[:, :F]


def _model_cfgs(options):
    common = dict(pretrained=False, mapping="exp", bn="folded", compute_dtype="float32")
    j_cfg = JModelCfg(
        backbone=JBackboneCfg(**common, **options),
        intrinsics=JIntrinsicsCfg(num_procrustes_points=H * W,
                                  regression=JRegressionCfg(after_step=1000, window=100)),
        extrinsics=JExtrinsicsCfg(num_points=1000),
    )
    common.pop("pretrained")
    t_cfg = ModelCfg(
        backbone=BackboneMidasCfg(**common, **options),
        intrinsics=IntrinsicsSoftminCfg(num_procrustes_points=H * W,
                                        regression=RegressionCfg(after_step=1000, window=100)),
        extrinsics=ExtrinsicsProcrustesCfg(num_points=1000),
    )
    return j_cfg, t_cfg


def _histories(variant):
    j_batch, j_flows, j_depths = _scene()
    j_cfg, t_cfg = _model_cfgs(VARIANTS[variant])
    j_losses, t_losses, j_tracks, t_tracks = [JLossFlowCfg()], [LossFlowCfg()], None, None
    if variant == "fused_weight_mlp":
        j_losses.append(JLossTrackingCfg(enable_after=0))
        t_losses.append(LossTrackingCfg(enable_after=0))
        j_tracks = j_make_track_segments(j_batch, j_depths, interval=1, radius=1, grid_size=4)
        t_tracks = [tracks_from_numpy(*(np.asarray(a) for a in (t.xy, t.visibility)),
                                      start_frame=int(t.start_frame)) for t in j_tracks]
    j_trainer = JTrainerCfg(lr=LR, max_steps=STEPS, val_check_interval=1)
    j_state, _ = j_init_train_state(j_cfg, j_trainer, F, (H, W))
    # The JAX loop donates its state, so it gets its own copy of the params.
    params = jax.tree_util.tree_map(np.array, j_state.params)
    want = j_run_overfit(j_cfg, j_losses, j_trainer, j_batch, j_flows, j_tracks,
                         init_params=jax.tree_util.tree_map(jnp.asarray, params))[1]

    batch = Batch(videos=torch.tensor(np.asarray(j_batch.videos)),
                  indices=torch.tensor(np.asarray(j_batch.indices)))
    flows = Flows(*(torch.tensor(np.asarray(a)) for a in (
        j_flows.forward, j_flows.backward, j_flows.forward_mask, j_flows.backward_mask)))
    seen = []
    _, info = run_overfit(t_cfg, t_losses, OverfitTrainerCfg(lr=LR, max_steps=STEPS, val_check_interval=1),
                          batch, flows, t_tracks,
                          on_validation=lambda state, step, metrics: seen.append(step),
                          init_params=from_jax_params(params))
    assert seen == list(range(1, STEPS + 1))
    return np.asarray(info["history"]["loss/total"]), np.asarray(want["history"]["loss/total"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_history_matches_jax(variant):
    t, j = _histories(variant)
    assert t.shape == j.shape == (STEPS,) and np.all(np.isfinite(t))
    assert np.max(np.abs(t - j)) <= 1e-4 * np.max(np.abs(j))


def _small_port_scene():
    from flowmap_tpu_torch.utils.synthetic import SyntheticSceneCfg, make_scene

    batch, flows, _ = make_scene(SyntheticSceneCfg(num_frames=3, image_shape=(32, 32)), "cpu")
    _, t_cfg = _model_cfgs(dict(weights_resolution="full"))
    return batch, flows, t_cfg


def test_steps_per_program_gives_the_same_history():
    """Two steps between fetches give the history of one step a program,
    with a fetch (and `on_validation`) only every `val_check_interval`."""
    batch, flows, cfg = _small_port_scene()
    histories, seen = [], []
    for spp in (1, 2):
        _, info = run_overfit(
            cfg, [LossFlowCfg()],
            OverfitTrainerCfg(lr=LR, max_steps=4, val_check_interval=2, steps_per_program=spp),
            batch, flows, on_validation=lambda state, step, metrics: seen.append(step))
        histories.append(info["history"])
        assert info["optimization_runtime"] > 0
    assert seen == [2, 4, 2, 4]
    assert histories[0] == histories[1] and len(histories[0]["loss/total"]) == 2


def test_explicit_collectives_raise():
    """Frame sharding over several cards is not ported: its explicit
    collectives raise before any work."""
    batch, flows, cfg = _small_port_scene()
    with pytest.raises(NotImplementedError):
        run_overfit(cfg, [LossFlowCfg()], OverfitTrainerCfg(collectives="explicit"), batch, flows)
