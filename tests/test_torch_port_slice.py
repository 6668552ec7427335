"""The slice end to end: one overfit step of the port vs flowmap_tpu.

An 8-frame 64x96 synthetic scene from both packages' `make_scene`, the
bench's model (MiDaS-small with folded BN, softmin intrinsics with
regression, Procrustes extrinsics over 1000 points, flow loss) at
`compute_dtype="float32"` (the softmin subset cut to 4096 pixels, as the
JAX sweep needs at most h*w). The JAX `init_train_state` parameters are carried
into the port, and the JAX draw of the softmin pixel subset,
`permutation(split(fold_in(PRNGKey(0), step))[0], h*w)[:k]`, is injected
into the port's step. Compared: the loss, every gradient leaf, the
parameters after Adam, and a 5-step loss trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.loss.loss import LossFlowCfg as JLossFlowCfg
from flowmap_tpu.loss.loss import compute_losses as j_compute_losses
from flowmap_tpu.model import BackboneMidasCfg as JBackboneCfg
from flowmap_tpu.model import ExtrinsicsProcrustesCfg as JExtrinsicsCfg
from flowmap_tpu.model import IntrinsicsSoftminCfg as JIntrinsicsCfg
from flowmap_tpu.model import ModelCfg as JModelCfg
from flowmap_tpu.model import RegressionCfg as JRegressionCfg
from flowmap_tpu.model.intrinsics.intrinsics import _softmin_sweep as j_sweep
from flowmap_tpu.model.model import forward as j_forward
from flowmap_tpu.training.overfit import OverfitTrainerCfg as JTrainerCfg
from flowmap_tpu.training.overfit import _autosize_warp_radius as j_autosize
from flowmap_tpu.training.overfit import init_train_state as j_init_train_state
from flowmap_tpu.training.overfit import make_train_step as j_make_train_step
from flowmap_tpu.utils.synthetic import SyntheticSceneCfg as JSceneCfg
from flowmap_tpu.utils.synthetic import make_scene as j_make_scene
from flowmap_tpu_torch.loss.loss import LossFlowCfg, LossTrackingCfg, compute_losses
from flowmap_tpu_torch.model import (
    BackboneMidasCfg,
    ExtrinsicsProcrustesCfg,
    IntrinsicsSoftminCfg,
    ModelCfg,
    RegressionCfg,
)
from flowmap_tpu_torch.model.intrinsics.intrinsics import softmin_sweep
from flowmap_tpu_torch.training.overfit import (
    OverfitTrainerCfg,
    _autosize_warp_radius,
    init_train_state,
    make_train_step,
)
from flowmap_tpu_torch.utils.params import from_jax_params
from flowmap_tpu_torch.utils.synthetic import SyntheticSceneCfg, make_scene

torch.set_num_threads(1)

F, H, W = 8, 64, 96
POINTS = 4096  # softmin sweep subset; the JAX sweep needs it <= H * W
LR = 3e-5
STEPS = 5


def _intrinsics_indices(step: int, k: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return np.asarray(jax.random.permutation(jax.random.split(key)[0], H * W)[:k])


def _rel_l2(got: dict, want: dict) -> tuple[float, dict]:
    """Relative L2 error over all leaves, and per leaf over
    max(|leaf|, 1e-2 * the largest leaf norm)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    floor = 1e-2 * max(norms.values())
    per_leaf = {k: float((got[k] - want[k]).norm()) / max(norms[k], floor) for k in want}
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(n * n for n in norms.values())) ** 0.5, per_leaf


@pytest.fixture(scope="module")
def runs():
    """Run both packages for STEPS steps from the same parameters."""
    j_batch, j_flows, _ = j_make_scene(JSceneCfg(num_frames=F, image_shape=(H, W)))
    j_cfg = j_autosize(
        JModelCfg(
            backbone=JBackboneCfg(pretrained=False, mapping="exp", bn="folded",
                                  compute_dtype="float32"),
            intrinsics=JIntrinsicsCfg(num_procrustes_points=POINTS,
                                      regression=JRegressionCfg(after_step=1000, window=100)),
            extrinsics=JExtrinsicsCfg(num_points=1000),
        ),
        j_flows, H,
    )
    j_state, optimizer = j_init_train_state(j_cfg, JTrainerCfg(lr=LR), F, (H, W))
    base_key = jax.random.PRNGKey(0)
    j_step = jax.jit(j_make_train_step(j_cfg, [JLossFlowCfg()], optimizer, base_key))

    def j_loss(params, state):
        output, _ = j_forward(j_cfg, params, state.model_state, j_batch, j_flows,
                              state.step, jax.random.fold_in(base_key, state.step))
        return j_compute_losses([JLossFlowCfg()], j_flows, None, output, state.step, (H, W))[0]

    j_grad_fn = jax.jit(jax.grad(j_loss))
    j_grads = j_grad_fn(j_state.params, j_state)
    # The reference's own sensitivity: its gradient and trajectory after a
    # 1e-6 relative perturbation of every parameter.
    leaves, tree = jax.tree_util.tree_flatten(j_state.params)
    rng = np.random.default_rng(0)
    j_state_pert = j_state.replace(params=jax.tree_util.tree_unflatten(tree, [
        leaf * (1 + 1e-6 * rng.standard_normal(leaf.shape).astype(np.float32))
        for leaf in leaves
    ]))
    j_grads_pert = j_grad_fn(j_state_pert.params, j_state_pert)

    batch, flows, _ = make_scene(SyntheticSceneCfg(num_frames=F, image_shape=(H, W)), "cpu")
    cfg = _autosize_warp_radius(
        ModelCfg(
            backbone=BackboneMidasCfg(mapping="exp", bn="folded",
                                      compute_dtype="float32"),
            intrinsics=IntrinsicsSoftminCfg(num_procrustes_points=POINTS,
                                            regression=RegressionCfg(after_step=1000, window=100)),
            extrinsics=ExtrinsicsProcrustesCfg(num_points=1000),
        ),
        flows, H,
    )
    state = init_train_state(cfg, OverfitTrainerCfg(lr=LR), F, (H, W), device="cpu")
    state.model.load_state_dict(from_jax_params(j_state.params), strict=True)
    step = make_train_step(cfg, [LossFlowCfg()])
    k = cfg.intrinsics.num_procrustes_points

    out = {"j_cfg": j_cfg, "cfg": cfg, "scenes": ((j_batch, j_flows), (batch, flows)),
           "j_loss": [], "t_loss": [], "j_loss_pert": [],
           "j_grads": from_jax_params(j_grads), "j_grads_pert": from_jax_params(j_grads_pert)}
    for i in range(STEPS):
        idx = torch.as_tensor(_intrinsics_indices(i, k), dtype=torch.long)
        metrics = step(state, batch, flows, intrinsics_indices=idx)
        j_state, j_metrics = j_step(j_state, j_batch, j_flows, None)
        j_state_pert, j_metrics_pert = j_step(j_state_pert, j_batch, j_flows, None)
        out["t_loss"].append(float(metrics["loss/total"]))
        out["j_loss"].append(float(j_metrics["loss/total"]))
        out["j_loss_pert"].append(float(j_metrics_pert["loss/total"]))
        if i == 0:
            out["t_grads"] = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
            out["t_params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            out["j_params"] = from_jax_params(j_state.params)
    return out


def test_scenes_match(runs):
    (j_batch, j_flows), (batch, flows) = runs["scenes"]
    for a, b in ((batch.videos, j_batch.videos), (batch.extrinsics, j_batch.extrinsics),
                 (batch.intrinsics, j_batch.intrinsics), (flows.forward, j_flows.forward),
                 (flows.backward, j_flows.backward), (flows.forward_mask, j_flows.forward_mask),
                 (flows.backward_mask, j_flows.backward_mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j_bb, bb = runs["j_cfg"].backbone, runs["cfg"].backbone
    assert (bb.warp_radius, bb.warp_radius_x, bb.warp_radius_half, bb.warp_radius_half_x) == (
        j_bb.warp_radius, j_bb.warp_radius_x, j_bb.warp_radius_half, j_bb.warp_radius_half_x)


def test_one_step_loss_and_gradients(runs):
    """Loss rtol 1e-4. Gradients: at random initialisation the step is
    ill-conditioned (near-constant depth makes Horn's eigenproblem nearly
    degenerate), and the JAX package's own gradient moves by ~1.5% in L2
    when every parameter is perturbed by 1e-6 relative. The port's gradient
    must be at most twice as far from the reference as that, globally and
    per leaf (relative L2, per-leaf floor 1e-2 of the largest leaf norm)."""
    np.testing.assert_allclose(runs["t_loss"][0], runs["j_loss"][0], rtol=1e-4)
    assert runs["t_grads"].keys() == runs["j_grads"].keys()
    port, port_leaf = _rel_l2(runs["t_grads"], runs["j_grads"])
    ref, ref_leaf = _rel_l2(runs["j_grads_pert"], runs["j_grads"])
    assert port <= 2 * ref + 1e-4, (port, ref)
    for k in port_leaf:
        assert port_leaf[k] <= 2 * max(ref_leaf[k], ref) + 1e-4, (k, port_leaf[k], ref_leaf[k])


def test_one_step_params_after_adam(runs):
    """Adam's first update is lr * g / (|g| + eps), about lr * sign(g): where
    the gradients disagree in sign (within the conditioning above) an
    element may differ by up to 2 lr, never more; at most 1% of all
    elements differ by more than 1e-6."""
    differing = total = 0
    for name, want in runs["j_params"].items():
        diff = (runs["t_params"][name] - want).abs()
        assert float(diff.max()) <= 2.0 * LR * 1.01, name
        differing += int((diff > 1e-6).sum())
        total += diff.numel()
    assert differing / total < 1e-2, differing / total


def test_loss_trajectory(runs):
    """Five steps: the port's losses stay as close to the reference's as
    the reference's own run from 1e-6-perturbed parameters (within 3x, plus
    1e-4 relative)."""
    t, j, jp = (np.asarray(runs[k]) for k in ("t_loss", "j_loss", "j_loss_pert"))
    assert np.all(np.isfinite(t))
    assert np.max(np.abs(t - j)) <= 3 * np.max(np.abs(jp - j)) + 1e-4 * np.max(np.abs(j))
    assert t[-1] < t[0]


def test_softmin_sweep_values_and_gradients():
    """The candidate sweep with an injected pixel subset: intrinsics and
    focal estimate rtol 1e-5, gradients to depths and weights 1e-3."""
    rng = np.random.default_rng(0)
    h, w = 16, 24
    backward0 = (rng.normal(size=(1, h, w, 2)) * 0.02).astype(np.float32)
    depths = rng.uniform(1.0, 3.0, size=(1, 2, h, w)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(1, h, w)).astype(np.float32)
    cfg_j = JIntrinsicsCfg(num_procrustes_points=200)
    key = jax.random.PRNGKey(7)
    idx = np.asarray(jax.random.permutation(key, h * w)[:200])

    def j_fn(d, wt):
        k, focal = j_sweep(cfg_j, 3, backward0, d, wt, key)
        return jnp.sum(k[0, 0] * jnp.arange(9.0).reshape(3, 3)) + focal, (k, focal)

    (_, (k_j, focal_j)), g_j = jax.value_and_grad(j_fn, (0, 1), has_aux=True)(depths, weights)
    d_t = torch.tensor(depths, requires_grad=True)
    w_t = torch.tensor(weights, requires_grad=True)
    k_t, focal_t = softmin_sweep(IntrinsicsSoftminCfg(num_procrustes_points=200), 3,
                                 torch.tensor(backward0), d_t, w_t, torch.tensor(idx))
    np.testing.assert_allclose(k_t.detach().numpy(), np.asarray(k_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(focal_t.detach()), float(focal_j), rtol=1e-5)
    val = torch.sum(k_t[0, 0] * torch.arange(9.0).reshape(3, 3)) + focal_t
    for got, want in zip(torch.autograd.grad(val, (d_t, w_t)), g_j):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-3 * float(np.abs(want).max())


def test_tracking_loss_raises_until_next_slice():
    with pytest.raises(NotImplementedError, match="next slice"):
        compute_losses([LossTrackingCfg()], None, None, dataclasses.make_dataclass(
            "Out", ["surfaces"])(torch.zeros(1)), 0, (4, 4))


@pytest.mark.parametrize(
    "variant",
    [
        ("explicit_depth", "regressed", "regressed", "l1"),
        ("explicit_depth", "ground_truth", "procrustes", "huber"),
        ("explicit_depth", "regressed", "procrustes", "l2"),
    ],
)
def test_model_forward_variants(variant):
    """The other backbone, intrinsics and extrinsics modules of the slice
    (explicit depth, regressed and ground-truth intrinsics, regressed poses)
    and the flow loss's other mappings: model outputs and loss within 1e-4."""
    from flowmap_tpu.loss.mapping import MappingCfg as JMappingCfg
    from flowmap_tpu.model import BackboneExplicitDepthCfg as JExplicitCfg
    from flowmap_tpu.model import ExtrinsicsRegressedCfg as JExtrRegressedCfg
    from flowmap_tpu.model import IntrinsicsGroundTruthCfg as JGroundTruthCfg
    from flowmap_tpu.model import IntrinsicsRegressedCfg as JIntrRegressedCfg
    from flowmap_tpu.model.model import init_model as j_init_model
    from flowmap_tpu_torch.loss.mapping import MappingCfg
    from flowmap_tpu_torch.model import (
        BackboneExplicitDepthCfg,
        ExtrinsicsRegressedCfg,
        IntrinsicsGroundTruthCfg,
        IntrinsicsRegressedCfg,
    )
    from flowmap_tpu_torch.model.model import forward, init_model

    _, intr, extr, mapping = variant
    f, h, w = 4, 16, 24
    j_cfg = JModelCfg(
        backbone=JExplicitCfg(),
        intrinsics=JIntrRegressedCfg() if intr == "regressed" else JGroundTruthCfg(),
        extrinsics=(JExtrRegressedCfg() if extr == "regressed"
                    else JExtrinsicsCfg(num_points=100)),
    )
    cfg = ModelCfg(
        backbone=BackboneExplicitDepthCfg(),
        intrinsics=IntrinsicsRegressedCfg() if intr == "regressed" else IntrinsicsGroundTruthCfg(),
        extrinsics=(ExtrinsicsRegressedCfg() if extr == "regressed"
                    else ExtrinsicsProcrustesCfg(num_points=100)),
    )
    params, j_state = j_init_model(j_cfg, jax.random.PRNGKey(0), num_frames=f, image_shape=(h, w))
    rng = np.random.default_rng(1)
    noisy = lambda a, s: np.asarray(a) + s * rng.standard_normal(np.shape(a)).astype(np.float32)  # noqa: E731
    params["backbone"] = {"depth": noisy(params["backbone"]["depth"], 0.01) + 1.0,
                          "weights": noisy(params["backbone"]["weights"], 0.01)}
    if extr == "regressed":
        params["extrinsics"] = {k: noisy(v, 0.02) for k, v in params["extrinsics"].items()}
    j_batch, j_flows, _ = j_make_scene(JSceneCfg(num_frames=f, image_shape=(h, w)))
    out_j, _ = j_forward(j_cfg, params, j_state, j_batch, j_flows, 0, jax.random.PRNGKey(1))
    loss_j, _ = j_compute_losses(
        [JLossFlowCfg(mapping=JMappingCfg(name=mapping))], j_flows, None, out_j, 0, (h, w))

    model, state = init_model(cfg, num_frames=f, image_shape=(h, w), device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    batch, flows, _ = make_scene(SyntheticSceneCfg(num_frames=f, image_shape=(h, w)), "cpu")
    with torch.no_grad():
        out_t, _ = forward(model, state, batch, flows, 0)
        loss_t, _ = compute_losses(
            [LossFlowCfg(mapping=MappingCfg(name=mapping))], flows, None, out_t, 0, (h, w))
    for got, want in ((out_t.surfaces, out_j.surfaces), (out_t.intrinsics, out_j.intrinsics),
                      (out_t.extrinsics, out_j.extrinsics),
                      (out_t.backward_correspondence_weights,
                       out_j.backward_correspondence_weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
