"""Per-scene overfitting: the train step and the loop the product runs.

Counterpart of `flowmap_tpu/training/overfit.py` (`init_train_state`,
`make_train_step`, `_autosize_warp_radius`, `run_overfit`; reference
`model_wrapper_overfit.py`). One step is the model forward, the losses,
one backward and one Adam update, run eagerly. `torch.optim.Adam` with its
defaults (betas 0.9/0.999, eps 1e-8, no weight decay) computes optax.adam's
update; like optax, every parameter is updated every step, with a zero
gradient where the loss does not reach it (the regressed focal during the
softmin stage), so the Adam step counts match.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..loss.loss import LossCfg, compute_losses
from ..model.intrinsics import maybe_handoff_focal
from ..model.model import FlowMapModel, ModelCfg, ModelState, forward, init_model
from ..ops.warp import radius_for_flows
from ..tracking.tracking import pack_tracks
from ..types import Batch, Flows


@dataclass(frozen=True)
class OverfitTrainerCfg:
    """The JAX package's trainer settings. `steps_per_program` steps run
    between two metric fetches (the JAX package scans them inside one
    compiled program; here they are plain eager steps, so the history is the
    same). `staged_vjp` is accepted and changes nothing: the JAX package's
    explicitly chained VJPs are the same chain rule that autograd applies.
    `sharding` "auto" is the single-device step on one card; frame sharding
    over several cards is not ported yet, and `collectives="explicit"`
    raises."""

    lr: float = 3e-5
    max_steps: int = 2000
    val_check_interval: int = 50
    seed: int = 0
    staged_vjp: bool = False
    steps_per_program: int = 1
    sharding: str = "auto"
    collectives: str = "gspmd"


@dataclass
class TrainState:
    model: FlowMapModel
    optimizer: torch.optim.Optimizer
    model_state: ModelState
    step: int = 0


def init_train_state(
    model_cfg: ModelCfg,
    trainer_cfg: OverfitTrainerCfg,
    num_frames: int,
    image_shape: tuple[int, int],
    device: str | torch.device = "cuda",
) -> TrainState:
    model, model_state = init_model(
        model_cfg, trainer_cfg.seed, num_frames, image_shape, device
    )
    optimizer = torch.optim.Adam(model.parameters(), lr=trainer_cfg.lr)
    return TrainState(model=model, optimizer=optimizer, model_state=model_state)


def make_train_step(
    model_cfg: ModelCfg,
    loss_cfgs: Sequence[LossCfg],
    seed: int = 0,
) -> Callable:
    """Build the single-step update.

    Returns `step(state, batch, flows, tracks=None, intrinsics_indices=None)
    -> metrics`, which updates `state` in place. `intrinsics_indices`
    overrides the softmin sweep's random pixel subset for this step;
    otherwise it is drawn from a generator seeded with `seed`."""
    generator = torch.Generator().manual_seed(seed)

    def train_step(
        state: TrainState,
        batch: Batch,
        flows: Flows,
        tracks=None,
        intrinsics_indices: Optional[torch.Tensor] = None,
    ) -> dict[str, torch.Tensor]:
        h, w = batch.videos.shape[-2:]
        model = state.model
        maybe_handoff_focal(
            model_cfg.intrinsics, model.intrinsics, state.model_state.intrinsics, state.step
        )
        state.optimizer.zero_grad(set_to_none=True)
        output, new_model_state = forward(
            model, state.model_state, batch, flows, state.step,
            intrinsics_indices=intrinsics_indices, generator=generator, train=True,
        )
        total, individual = compute_losses(
            loss_cfgs, flows, tracks, output, state.step, (h, w)
        )
        total.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()

        metrics = {"loss/total": total.detach()}
        metrics.update({f"loss/{k}": v.detach() for k, v in individual.items()})
        if batch.intrinsics is not None:
            k_out = output.intrinsics.detach()
            metrics["intrinsics/fx_error"] = torch.abs(
                batch.intrinsics[..., 0, 0].mean() - k_out[..., 0, 0].mean()
            )
            metrics["intrinsics/fy_error"] = torch.abs(
                batch.intrinsics[..., 1, 1].mean() - k_out[..., 1, 1].mean()
            )
        state.model_state = new_model_state
        state.step += 1
        return metrics

    return train_step


def _autosize_warp_radius(model_cfg: ModelCfg, flows: Flows, height: int) -> ModelCfg:
    """Size the warp radii from the actual flow field (host-side).

    The half-resolution bounds are measured on the 2x2-pooled flow the
    native-weights path warps with; the shift warp's tap count is quadratic
    in them."""
    backbone = model_cfg.backbone
    if getattr(backbone, "warp_impl", None) not in ("fused", "matmul", "pallas"):
        return model_cfg
    fb = flows.backward.detach().float().cpu().numpy()
    height_, width = fb.shape[-3], fb.shape[-2]
    radius = radius_for_flows(fb[..., 1], height_)
    radius_x = radius_for_flows(fb[..., 0], width)
    half = {}
    if height_ % 2 == 0 and width % 2 == 0:
        b, p = fb.shape[:2]
        fb_half = fb.reshape(b, p, height_ // 2, 2, width // 2, 2, 2).mean(axis=(3, 5))
        half = dict(
            warp_radius_half=radius_for_flows(fb_half[..., 1], height_ // 2, margin=0),
            warp_radius_half_x=radius_for_flows(fb_half[..., 0], width // 2, margin=0),
        )
    return dataclasses.replace(
        model_cfg,
        backbone=dataclasses.replace(
            backbone, warp_radius=radius, warp_radius_x=radius_x, **half
        ),
    )



def _merge_init_params(model: torch.nn.Module, init_params: dict) -> None:
    """Non-strict, weights-only load (reference overfit.py:89-92): entries
    that the model lacks or whose shape differs keep their initialization;
    the optimizer state starts afresh."""
    own = model.state_dict()
    loadable = {
        k: v for k, v in init_params.items()
        if k in own and tuple(own[k].shape) == tuple(v.shape)
    }
    model.load_state_dict(loadable, strict=False)


def run_overfit(
    model_cfg: ModelCfg,
    loss_cfgs: Sequence[LossCfg],
    trainer_cfg: OverfitTrainerCfg,
    batch: Batch,
    flows: Flows,
    tracks=None,
    on_validation: Optional[Callable] = None,
    init_params: Optional[dict] = None,
) -> tuple[TrainState, dict]:
    """Run the overfitting schedule on the device of `batch`.

    `init_params` is a state dict (for example `utils/params.py:
    from_jax_params` of the JAX package's parameters), merged non-strictly
    into the fresh model. A ragged list of track segments is packed first.
    The warp radii are sized from `flows`. Every `val_check_interval` steps
    (and after the last) the last step's metrics are fetched to the host,
    appended to the history and passed to `on_validation(state, step,
    metrics)`. Returns the final state and `{"history": {name: [values]},
    "optimization_runtime": seconds}`."""
    if trainer_cfg.collectives == "explicit":
        raise NotImplementedError(
            "explicit collectives belong to frame sharding over several cards, "
            "which is not ported yet"
        )
    _, f, _, h, w = batch.videos.shape
    state = init_train_state(model_cfg, trainer_cfg, f, (h, w), batch.videos.device)
    if init_params is not None:
        _merge_init_params(state.model, init_params)
    if isinstance(tracks, (list, tuple)) and len(tracks) > 0:
        tracks = pack_tracks(list(tracks), f)

    model_cfg = _autosize_warp_radius(model_cfg, flows, h)
    train_step = make_train_step(model_cfg, loss_cfgs, seed=trainer_cfg.seed + 1)
    interval = min(trainer_cfg.val_check_interval, trainer_cfg.max_steps)
    per_call = min(trainer_cfg.steps_per_program, interval) if trainer_cfg.steps_per_program > 1 else 1

    t_start = time.time()
    history: dict[str, list] = {}
    steps_done = 0
    while steps_done < trainer_cfg.max_steps:
        for _ in range(per_call):
            metrics = train_step(state, batch, flows, tracks)
        steps_done += per_call
        if steps_done % interval != 0 and steps_done < trainer_cfg.max_steps:
            continue
        fetched = {k: float(v) for k, v in metrics.items()}
        for k, v in fetched.items():
            history.setdefault(k, []).append(v)
        if on_validation is not None:
            on_validation(state, steps_done, fetched)
    return state, {"history": history, "optimization_runtime": time.time() - t_start}
