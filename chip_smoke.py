#!/usr/bin/env python
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of `flowmap_tpu`, and in order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from `flowmap_tpu_torch/ops/kernels/csrc/` (one
   nvcc per source, in parallel) and prints the build time;
3. for each kernel of the overfit step -- the flow loss (A), the shift warp
   (B), the MiDaS head interior (C), the tracking loss (D: sampling and
   pair loss) and the bounded-radius feature warp (E) -- calls the wrapper
   at the shapes the main path gives it and holds forward and backward
   against the plain PyTorch version: in float32 with TF32 off (tight) and,
   for B, C and E, in bfloat16 (C's bf16 kernels are also held tightly
   against a plain f32 emulation of their own roundings; E also with a
   radius below the displacements, where its window cuts); any mismatch
   raises. Prints each error and time, A's and D's C entry points timed
   alone, and how far two runs of the two backwards that use atomics (D's
   sampling, E) differ. The two kernels of the flow precompute follow: the
   softmax expectation (F) at GMFlow's window-attention shape with the
   shifted-window mask as grouped bias, at its global-correlation shape with
   the pixel grid as values, and at a length that fills no tile, with
   float32 and bfloat16 inputs; the dense warp (G) at the consistency mask's
   shape, both padding modes, coordinates several widths outside the image,
   float32 and bfloat16. The two kernels of the weight paths follow, forward
   and backward, float32 and bfloat16, each parameter gradient the same bits
   on a second run: the fused weight MLP (I) on 149 x 80 x 112 pixels, and
   the full-resolution corr weights (H) on (150, 80, 112, 64) features with
   the scene's full-resolution grid, at the autosized radius (which must be
   6 or below) and at radius 0, where the window drops corners;
4. checks the whole train step (flow and tracking losses) on a small scene:
   one step through the kernels on the card against the same step on the
   CPU through the plain versions;
5. drives the main path: a 150-frame 160x224 synthetic scene, the
   autosized warp radii (the shift branch must be taken), `init_train_state`
   for MiDaS-small (folded BN, bf16, random weights from a seed), softmin
   intrinsics and Procrustes extrinsics, the flow loss and the tracking loss
   (exact packed tracks: 30 segments of 41 frames and 1225 points, enabled
   from step 0 so that its backward is live), 2 warm-up and 5 timed Adam
   steps. The launch counters of A, B, C and D must rise on every step; the
   losses must be finite and the tracking loss not zero. Prints steps/s and
   peak memory. Then the same step with `warp_impl="pallas"`, 1 warm-up
   and 2 timed steps: E must be launched on each, B on none. Then the
   fourth and fifth paths, the same scene through `run_overfit` (a fetch and
   `on_validation` after each of 4 steps): with `weights_resolution="full"`
   H must be launched forward and backward on every step (and B, E, I
   never), with `fused_weight_mlp=True` I on every step (and H, E never).
   Prints steps/s and peak memory of each;
6. drives the third path, the product's precompute at full width: a
   150-frame 640x896 source video, the two crops, `compute_flows` with
   GMFlow (float32, chunks of 8 pairs, random weights from a seed, both
   directions) and the consistency masks, flow-chained tracks, and then 1
   warm-up and 2 timed steps of the full step on those flows. F must be
   launched 14 times per chunk and G once per direction; flows and masks
   must be finite, masks in [0, 1]. Prints the precompute's wall time,
   pairs/s and peak memory;
7. prints one JSON line with every kernel's launches, error and times, and
   as the last line `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, when there is no card or when the port
is not beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

WARMUP_STEPS = 2
TIMED_STEPS = 5
# The second path (the bounded-radius warp in place of the shift warp).
PALLAS_WARMUP_STEPS = 1
PALLAS_TIMED_STEPS = 2
# The third path (the flow precompute, then the step on its flows).
PRECOMPUTE_WARMUP_STEPS = 1
PRECOMPUTE_TIMED_STEPS = 2
# The fourth and fifth paths (run_overfit on the full-resolution weights and
# on the fused weight MLP): steps, each followed by a fetch.
OVERFIT_STEPS = 4

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense; f32 without tensor cores

# Tolerances (max |kernel - plain|, relative to max |plain| where marked).
TOL = {
    # Flow loss, f32: different summation order and the folded projection
    # against the XLA-form composition.
    "flow_loss_value_rel": 1e-4,
    "flow_loss_grad_rel": 1e-3,
    # Shift warp: the kernel repeats the stencil's f32 operations in order.
    "shift_warp_f32_abs": 0.0,
    "shift_warp_bf16_abs": 0.0,
    # Head: f32 FMA accumulation vs cuDNN f32 (TF32 off); bf16 rounds z and
    # the phases at other places than cuDNN's bf16 convolutions. Gradients
    # are compared in relative L2 norm: where a phase pre-activation is
    # within rounding of 0 the two versions may take different sides of the
    # relu, which moves single pixels of dx by O(1) (the same happens
    # between either f32 version and a float64 run). The weight and bias
    # gradients sum 1.3M terms of random sign, so f32 rounding is ~1e-4..1e-3
    # of the cancelled sum in either version.
    "head_f32_rel": 1e-4,
    "head_f32_grad_rel": 2e-3,
    # In bf16 the plain version rounds z, the phases, d_phases and dz to
    # bf16 (eps 2^-8) and relu signs flip where phases round across 0; the
    # kernel keeps the phases in f32. Both are also held against the f32
    # plain version, where the kernel must be no less accurate.
    "head_bf16_rel": 3e-2,
    "head_bf16_grad_rel": 1e-1,
    # The bf16 kernels against `head_interior_mma_emulated`, which rounds at
    # the kernels' own points (rel L2). Stage by stage, each started from
    # the kernels' own z, d_phases and dz, only the f32 summation order and
    # the rare bf16 rounding it tips differ. End to end, a one-ulp
    # difference in z also tips relu sides downstream, which moves the
    # gradients by ~2e-3..4e-3 (H100, 150 x 80 x 112).
    "head_bf16_emulated_stage_rel": 1e-3,
    "head_bf16_emulated_rel": 1e-2,
    # Tracking loss, f32. The sampling gathers four corners where the plain
    # version contracts one-hot weights; the pair loss sums 61.8M terms in
    # another order than the plain version's reduction; d_surface is summed by
    # atomics. The in-frame mask of a reprojected point is a step: of 61.8M
    # pair-points a few tens land within an f32 rounding of the frame's edge
    # and fall on either side of it in the two versions (and in a float64
    # run, which the check prints). Each such pair adds or drops one whole
    # term: ~1 in one point's d_xyz (of a largest value of ~40), ~1e-3 of the
    # largest d_M entry, single pixels of d_surfaces by ~1e-2 of the largest;
    # the valid count, an f32 sum of 4.9e7 ones, cannot show them. So
    # gradients that hold such terms are compared in relative L2 norm, d_xyz
    # also by the share of its values that are off by more than 1e-4 of the
    # largest, and the sums over all points (loss, gradients to poses and
    # intrinsics) relative to their size.
    "track_loss_value_rel": 1e-4,
    "track_loss_valid_rel": 1e-6,
    "track_loss_grad_rel_l2": 1e-3,
    "track_kernel_rel": 1e-4,  # sampling fwd and bwd, pair-loss sums: max abs / largest
    "track_pair_bwd_rel_l2": 3e-3,  # d_xyz and d_M
    "track_pair_bwd_off_share": 1e-4,  # share of d_xyz values off by > 1e-4 of the largest
    "track_pair_bwd_dm_rel": 1e-2,  # d_M: max abs / largest
    # Feature warp. f32: the plain version's column product is a matmul
    # (fused multiply-adds), the kernel rounds each product; the backward sums
    # in another order. bf16: the plain version rounds where the kernel does
    # and the products are exact in f32, so the forward should be equal; the
    # backward's f32 sums differ in order, which the final rounding shows as
    # at most one bf16 ulp (2^-8 relative, so 2^-7 of the largest value).
    "warp_features_f32_rel": 1e-5,
    "warp_features_bf16_rel": 2.0 ** -7,
    # Softmax expectation. Kernel and plain version both take their inputs
    # (f32 or bf16) exactly and work in f32, so one tolerance serves both
    # types; they differ in the order of a 128-term dot product and of the
    # sums over the keys, and in the online rescaling. Attention values
    # (d = 128): of the largest value. Expected coordinates (d = 2): in
    # pixels, on coordinates up to 112, where an f32 sum over 8960 keys is
    # good to a few 1e-4 px: the kernel is held to 1e-3 px against the plain
    # version run in float64, and to 5e-3 px against the f32 plain version,
    # whose own distance from float64 is the larger of the two (H100, the
    # shapes of the check: plain up to 2.5e-3 px, kernel 2.0e-4).
    "softmax_expectation_rel": 1e-4,
    "softmax_expectation_px": 5e-3,
    "softmax_expectation_px_f64": 1e-3,
    # Dense warp: the plain version rounds where the kernel does and both do
    # the same f32 operations in the same order (no contraction), in both
    # compute types; the limit is the JAX package's own for this function.
    "dense_warp_abs": 2e-5,
    # Weight MLP (I) and corr weights (H). f32: three-pass TF32 on the
    # tensor cores against f32 matmuls (each ~1e-6 relative), another
    # summation order; the gradients are compared in relative L2 because a
    # pre-activation within rounding of 0 may take either side of a relu
    # in the two versions, which moves that pixel's gradients by a whole
    # term. Of 85 M hidden values ~1e-6 lie that close to 0, and each flip
    # adds one term to sums of ~1e6 random-sign terms: I's bias gradient db1,
    # which takes no product in the backward, only the masks, differed by
    # 1.0e-3 in relative L2 (H100, 1.3 M pixels), as did every other
    # gradient but dw2 and db2 (2e-6), which no mask touches. bf16: both
    # round at the same points, but a last-bit
    # difference in an f32 sum can tip one rounding by an ulp (2^-8), which
    # the next layers carry. H's values are sigmoids, held to the JAX
    # package's limits for its kernel against `corr_weights_ref`: 2e-5 in
    # f32 (a first limit of 1e-5 failed at 1.06e-5 on the H100) and 0.03 in
    # bf16.
    "weight_mlp_f32_rel": 1e-5,
    "weight_mlp_bf16_rel": 1e-2,
    "corr_weights_f32_abs": 2e-5,
    "corr_weights_bf16_abs": 3e-2,
    "mlp_f32_grad_rel_l2": 3e-3,
    "mlp_bf16_grad_rel_l2": 3e-2,
    # Whole step, GPU kernels vs CPU plain versions, f32.
    "step_loss_rel": 1e-3,
    "step_grad_rel": 1e-2,
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(got, want) -> float:
    scale = float(want.detach().abs().max())
    return float((got.detach().float() - want.detach().float()).abs().max()) / max(scale, 1e-30)


def rel_l2(got, want) -> float:
    diff = (got.detach().double() - want.detach().double()).norm()
    return float(diff / max(float(want.detach().double().norm()), 1e-30))


def abs_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Least work of each kernel, {direction: (bytes, operations)}: every input
# read once and every output written once; weights and per-pair matrices
# are left out where they are below 0.1% of the bytes.


def flow_loss_bound(f: int, h: int, w: int) -> dict[str, tuple[float, float]]:
    """A, f32: surfaces, both directions' flows (8 B) and masks (4 B) and M
    in; the backward also writes d_surfaces. ~60 operations per pixel and
    direction forward, twice that backward."""
    px, pairs_px = f * h * w, (f - 1) * h * w
    fwd = px * 12 + 2 * pairs_px * (8 + 4) + 2 * (f - 1) * 48
    ops = 2 * pairs_px * 60.0
    return {"fwd": (fwd, ops), "bwd": (fwd + px * 12, 2 * ops)}


def shift_warp_bound(n: int, h: int, w: int, c: int, itemsize: int):
    """B: features in, grid in (f32), result out; four taps of one multiply
    and one add per channel, each way."""
    each = 2 * n * h * w * c * itemsize + n * h * w * 2 * 4
    ops = n * h * w * c * 4 * 2.0
    return {"fwd": (each, ops), "bwd": (each, ops)}


def head_bound(n: int, h: int, w: int, itemsize: int):
    """C at (n, 64, h, w). Forward: x in; z (kept for the backward), the relu
    mask of the 128 phases (1 bit each) and y4 (f32) out; conv1 and the phase
    conv. Backward: x, z, the mask and g (f32) in, dx out; the input and
    weight gradients of both convolutions (dx, dk1: 2 x conv1; dz, dkp:
    2 x phases). Recomputing the phases is a design's choice, not counted."""
    px = n * h * w
    conv1 = 2.0 * px * 32 * 64 * 9
    phases = 2.0 * px * 128 * 32 * 9
    mask = px * 128 // 8
    fwd = px * 64 * itemsize + px * 32 * itemsize + mask + px * 4 * 4
    bwd = px * 64 * itemsize * 2 + px * 32 * itemsize + mask + px * 4 * 4
    return {"fwd": (fwd, conv1 + phases), "bwd": (bwd, 2 * conv1 + 2 * phases)}


def track_loss_bound(f, h, w, s, l, p, texels: int):
    """D, f32, per kernel. Sampling: xy in, the `texels` distinct surface
    texels this run's points touch (12 B each), xyz out; ~40 operations a
    point. Its backward: xy and d_xyz in, the whole d_surface out; ~30. Pair
    loss: xyz, xy, visibility and M in, two sums out; ~55 operations a
    pair-point (projection 18, divide and clamp 10, residual and root 10,
    huber 5, masks and sums 12), each division and root counted as one. Its
    backward also writes d_xyz and d_M; ~105 (the forward again without the
    huber value, then the VJP)."""
    points, pair_points = s * l * p, s * l * l * p
    pair_in = points * (12 + 8 + 1) + s * l * l * 48
    return {
        "sample_fwd": (points * 8 + texels * 12 + points * 12, points * 40.0),
        "sample_bwd": (points * (8 + 12) + f * h * w * 12, points * 30.0),
        "pair_fwd": (pair_in, pair_points * 55.0),
        "pair_bwd": (pair_in + points * 12 + s * l * l * 48, pair_points * 105.0),
    }


def warp_features_bound(n: int, h: int, w: int, c: int, itemsize: int):
    """E: features (or cotangent) in, grid in (f32), result out; per output
    channel two columns and two rows of one multiply and one add, each way."""
    each = 2 * n * h * w * c * itemsize + n * h * w * 2 * 4
    ops = n * h * w * c * 10.0
    return {"fwd": (each, ops), "bwd": (each, ops)}


def softmax_expectation_bound(b: int, l: int, c: int, d: int, itemsize: int, bias_groups: int):
    """F: q and k in (their type), values and the bias in (f32), result out;
    both products, a multiply and an add per term, and ~8 operations per score
    for the scale, bias, maximum, exponential and sum."""
    nbytes = 2 * b * l * c * itemsize + 2 * b * l * d * 4 + bias_groups * l * l * 4
    return nbytes, b * float(l) * l * (2 * (c + d) + 8)


def dense_warp_bound(n: int, c: int, h: int, w: int, itemsize: int):
    """G: coordinates (8 B a pixel) and the image in, the result (f32) out;
    per pixel ~16 operations for the weights and 8 a channel."""
    px = n * h * w
    return px * 8 + px * c * itemsize + px * c * 4, px * (16.0 + 8 * c)


# Operations of the weight MLP a pixel: 2 (128 x 128 + 128 x 64 + 64).
MLP_OPS = 2.0 * (128 * 128 + 128 * 64 + 64)


def weight_mlp_bound(p: int, itemsize: int):
    """I: wa and la in, f32 logits out; the three products. Backward: wa, la
    and the f32 cotangent in, dwa and dla out; counting only the gradients'
    products (dx0, d_in, dW0, dW1), not the forward's recomputation."""
    fwd = 2 * p * 64 * itemsize + p * 4
    grads = 2.0 * (64 * 128 + 128 * 128 + 128 * 128 + 64 * 128)
    return {"fwd": (fwd, p * MLP_OPS), "bwd": (fwd + 2 * p * 64 * itemsize, p * grads)}


def corr_weights_bound(n: int, hn: int, wn: int, itemsize: int):
    """H: native features (n + 1 frames) and the f32 grid in, f32 weights
    out; the MLP at every full-resolution pixel. Backward: features, grid and
    the f32 cotangent in, the feature gradient out; counting only the
    gradients, twice the MLP's operations (the interpolation's ~13 taps of
    64 channels a pixel are under 2% and left out)."""
    px = n * 4 * hn * wn
    feats = (n + 1) * hn * wn * 64 * itemsize
    fwd = feats + px * 8 + px * 4
    return {"fwd": (fwd, px * MLP_OPS), "bwd": (feats * 2 + px * 8 + px * 4, 2 * px * MLP_OPS)}


def grads_of(out, inputs, g=None):
    import torch

    return torch.autograd.grad(out, inputs, g, retain_graph=True)


def flow_loss_entry_ms(surfaces, extrinsics, intrinsics, flows, delta) -> dict[str, float]:
    """ms of A's two C entry points alone, without the wrapper's PyTorch work
    (the fold of M, the flows' copies, the sums of the partials)."""
    import torch

    from flowmap_tpu_torch.ops.kernels import build
    from flowmap_tpu_torch.ops.kernels import flow_loss as fl
    from flowmap_tpu_torch.types import Flows

    _, f, h, w, _ = surfaces.shape
    lib, stream = fl._lib(), build.stream_ptr(surfaces.device)
    surf = surfaces[0].detach().contiguous()
    m_fwd, m_bwd = (m.detach().contiguous() for m in fl.fold_projections(
        extrinsics[0].detach(), intrinsics[0].detach()))
    fl_flows = Flows(*(
        t[0].float().contiguous()
        for t in (flows.forward, flows.backward, flows.forward_mask, flows.backward_mask)
    ))
    args = fl._launch_args(surf, m_fwd, m_bwd, fl_flows, (h, w), delta)
    tiles = fl._num_tiles(h, w)
    p_fwd = torch.empty((f, tiles), device=surf.device)
    p_bwd = torch.empty((f, tiles, 24), device=surf.device)
    d_surf, g = torch.empty_like(surf), torch.ones(1, device=surf.device)

    def fwd():
        build.check(lib.flow_loss_fwd(*args, build.ptr(p_fwd), stream), "flow_loss_fwd")

    def bwd():
        build.check(lib.flow_loss_bwd(
            *args, build.ptr(g), build.ptr(p_bwd), build.ptr(d_surf), stream,
        ), "flow_loss_bwd")

    return {"fwd": time_ms(fwd, iters=20), "bwd": time_ms(bwd, iters=20)}


def check_flow_loss(batch, flows, depths) -> list[dict]:
    import torch

    from flowmap_tpu_torch.loss.mapping import MappingCfg
    from flowmap_tpu_torch.ops.geometry import sample_image_grid, unproject
    from flowmap_tpu_torch.ops.kernels import flow_loss as fl
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    h, w = IMAGE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    xy, _ = sample_image_grid((h, w), "cuda")
    noisy = depths * (1 + 0.05 * torch.randn(depths.shape, generator=gen, device="cuda"))
    surfaces = unproject(xy, noisy, batch.intrinsics[:, :, None, None]).contiguous()
    extrinsics = batch.extrinsics.clone()
    extrinsics[..., :3, 3] += 0.01 * torch.randn(extrinsics[..., :3, 3].shape, generator=gen, device="cuda")
    intrinsics = batch.intrinsics.clone()
    inputs = [t.requires_grad_(True) for t in (surfaces, extrinsics, intrinsics)]

    def kernel():
        return fl.flow_loss(*inputs, flows, (h, w), 0.01)[0]

    def plain():
        return fl.flow_loss_plain(*inputs, flows, (h, w), MappingCfg("huber", 0.01))[0]

    out_k, out_p = kernel(), plain()
    err_v = rel_err(out_k, out_p)
    g_k, g_p = grads_of(out_k, inputs), grads_of(out_p, inputs)
    err_g = max(rel_err(a, b) for a, b in zip(g_k, g_p))
    print(f"[A flow_loss f32] loss {float(out_k.detach()):.6f} vs plain "
          f"{float(out_p.detach()):.6f}: "
          f"rel {err_v:.3e}; grads rel {err_g:.3e}", flush=True)
    if not err_v <= TOL["flow_loss_value_rel"] or not err_g <= TOL["flow_loss_grad_rel"]:
        fail(f"flow_loss disagrees with its plain version: {err_v:.3e} / {err_g:.3e}")

    ms = {
        "fwd": time_ms(kernel), "fwd_plain": time_ms(plain),
        "bwd": time_ms(lambda: grads_of(out_k, inputs)),
        "bwd_plain": time_ms(lambda: grads_of(out_p, inputs)),
    }
    entry = flow_loss_entry_ms(*inputs, flows, 0.01)
    bounds = flow_loss_bound(NUM_FRAMES, h, w)
    print(f"[A flow_loss] ms fwd / bwd: wrapper {ms['fwd']:.4f} / {ms['bwd']:.4f}, "
          f"C entry alone {entry['fwd']:.4f} / {entry['bwd']:.4f}, bound "
          f"{bound_ms(*bounds['fwd'], 'float32')[0]:.4f} / "
          f"{bound_ms(*bounds['bwd'], 'float32')[0]:.4f}", flush=True)
    rows = []
    for d, err in (("fwd", abs_err(out_k, out_p)), ("bwd", max(abs_err(a, b) for a, b in zip(g_k, g_p)))):
        b_ms, b_by = bound_ms(*bounds[d], "float32")
        rows.append(dict(
            name=f"flow_loss_{d}", route="cuda",
            source="flowmap_tpu_torch/ops/kernels/csrc/flow_loss.cu",
            replaces="flowmap_tpu/ops/pallas/flow_loss.py:" + ("138" if d == "fwd" else "162"),
            max_abs_err=err, ms=ms[d], plain_ms=ms[f"{d}_plain"], bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        ))
    return rows


def check_shift_warp(flows, model_cfg) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from flowmap_tpu_torch.ops.geometry import sample_image_grid
    from flowmap_tpu_torch.ops.kernels import shift_warp as sw
    from flowmap_tpu_torch.ops.warp import warp_bilinear_shifts
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    h, w = IMAGE_SHAPE
    hn, wn, c = h // 2, w // 2, 64
    ry, rx = model_cfg.backbone.warp_radius_half, model_cfg.backbone.warp_radius_half_x
    fb = flows.backward[0]
    fb_half = fb.reshape(NUM_FRAMES - 1, hn, 2, wn, 2, 2).mean(dim=(2, 4))
    xy, _ = sample_image_grid((hn, wn), "cuda")
    grid = ((xy + fb_half) * 2.0 - 1.0).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn((NUM_FRAMES - 1, hn, wn, c), generator=gen, device="cuda").to(dtype)
        feats.requires_grad_(True)
        g = torch.randn(feats.shape, generator=gen, device="cuda").to(dtype)
        out_k = sw.warp_shifts(feats, grid, ry, rx)
        out_p = warp_bilinear_shifts(feats, grid, ry, rx)
        (d_k,), (d_p,) = grads_of(out_k, [feats], g), grads_of(out_p, [feats], g)
        e_f, e_b = abs_err(out_k, out_p), abs_err(d_k, d_p)
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"[B shift_warp {name}] ry={ry} rx={rx}: fwd max abs {e_f:.3e}, "
              f"bwd max abs {e_b:.3e}", flush=True)
        if e_f > TOL[f"shift_warp_{name}_abs"] or e_b > TOL[f"shift_warp_{name}_abs"]:
            fail(f"shift_warp {name} disagrees with its plain version")
        if dtype != torch.bfloat16:
            continue

        def library():
            return F.grid_sample(
                feats.permute(0, 3, 1, 2), grid.to(dtype), mode="bilinear",
                padding_mode="zeros", align_corners=False,
            )

        out_l = library()
        ms = {
            "fwd": time_ms(lambda: sw.warp_shifts(feats, grid, ry, rx)),
            "fwd_plain": time_ms(lambda: warp_bilinear_shifts(feats, grid, ry, rx), iters=3),
            "fwd_lib": time_ms(library),
            "bwd": time_ms(lambda: grads_of(out_k, [feats], g)),
            "bwd_plain": time_ms(lambda: grads_of(out_p, [feats], g), iters=3),
            "bwd_lib": time_ms(lambda: grads_of(out_l, [feats], g.permute(0, 3, 1, 2))),
        }
        bounds = shift_warp_bound(NUM_FRAMES - 1, hn, wn, c, 2)
        for d, err in (("fwd", e_f), ("bwd", e_b)):
            b_ms, b_by = bound_ms(*bounds[d], "bfloat16")
            rows.append(dict(
                name=f"shift_warp_{d}", route="cuda",
                source="flowmap_tpu_torch/ops/kernels/csrc/shift_warp.cu",
                replaces="flowmap_tpu/ops/pallas/shift_warp.py:" + ("243" if d == "fwd" else "275"),
                max_abs_err=err, ms=ms[d], plain_ms=ms[f"{d}_plain"], bound_ms=b_ms,
                bound_by=b_by, library_ms=ms[f"{d}_lib"],
            ))
    return rows


def check_head() -> list[dict]:
    import torch

    from flowmap_tpu_torch.model.backbone.midas_net import head_parity_kernel
    from flowmap_tpu_torch.ops.kernels import head_kernel as hk
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    n, h, w = NUM_FRAMES, IMAGE_SHAPE[0] // 2, IMAGE_SHAPE[1] // 2
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    k1, b1 = rnd((32, 64, 3, 3), (2 / 576) ** 0.5), rnd((32,), 0.1)
    w2, b2 = rnd((32, 32, 3, 3), (2 / 288) ** 0.5), rnd((32,), 0.1)
    w3, b3 = rnd((32,), 0.25), rnd((), 0.1)
    x32 = rnd((n, 64, h, w))
    g = rnd((n, 4, h, w))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        params = [t.to(dtype) for t in (k1, b1)] + [head_parity_kernel(w2.to(dtype))] + [
            t.to(dtype) for t in (b2, w3, b3)
        ]
        inputs = [x32.to(dtype)] + params
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        out_k = hk.head_interior(*inputs)
        out_p = hk.head_interior_plain(*inputs)
        g_k, g_p = grads_of(out_k, inputs, g), grads_of(out_p, inputs, g)
        e_v = rel_err(out_k, out_p)
        e_g = max(rel_l2(a, b) for a, b in zip(g_k, g_p))
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"[C head_interior {name}] fwd max rel {e_v:.3e}; grads rel L2 {e_g:.3e} "
              f"(per input: {[f'{rel_l2(a, b):.1e}' for a, b in zip(g_k, g_p)]}; "
              f"max rel {[f'{rel_err(a, b):.1e}' for a, b in zip(g_k, g_p)]})", flush=True)
        if not e_v <= TOL[f"head_{name}_rel"] or not e_g <= TOL[f"head_{name}_grad_rel"]:
            fail(f"head_interior {name} disagrees with its plain version")
        if dtype == torch.bfloat16:
            # Both bf16 versions against the f32 plain version on the same
            # (bf16-valued) inputs: the kernel must be no less accurate.
            in32 = [t.detach().float().requires_grad_(True) for t in inputs]
            out32 = hk.head_interior_plain(*in32)
            g32 = grads_of(out32, in32, g)
            acc_k = [rel_l2(a, b) for a, b in zip((out_k, *g_k), (out32, *g32))]
            acc_p = [rel_l2(a, b) for a, b in zip((out_p, *g_p), (out32, *g32))]
            print(f"[C head_interior bf16 vs f32] kernel rel L2 {[f'{e:.1e}' for e in acc_k]}; "
                  f"plain {[f'{e:.1e}' for e in acc_p]}", flush=True)
            if any(k > 1.25 * p + 1e-3 for k, p in zip(acc_k, acc_p)):
                fail("head_interior bf16 is less accurate than its plain version")
            # The tight checks: the kernels against the plain f32 emulation
            # of their own roundings, end to end and stage by stage.
            xs = [t.detach() for t in inputs]
            y_e, g_e, _ = hk.head_interior_mma_emulated(*xs, g)
            e_end = [rel_l2(a, b) for a, b in zip((out_k, *g_k), (y_e, *g_e))]
            y_s, z_s = hk.head_mma_forward(*xs)
            g_s, (dph_s, dz_s) = hk.head_mma_backward(xs[0], z_s, *xs[1:], g)
            if not torch.equal(y_s, out_k) or not all(
                torch.equal(a, b) for a, b in zip(g_s, g_k)
            ):
                fail("head_interior bf16: the stage launches differ from the autograd path")
            y_e, g_e, inter_e = hk.head_interior_mma_emulated(*xs, g, given=(z_s, dph_s, dz_s))
            e_stage = [rel_l2(a, b) for a, b in zip(
                (y_s, z_s, dph_s, dz_s, *g_s), (y_e, *inter_e, *g_e))]
            print(f"[C head_interior bf16 vs its f32 emulation] rel L2 end to end "
                  f"(y4, grads) {[f'{e:.1e}' for e in e_end]}; stage by stage "
                  f"(y4, z, d_phases, dz, grads) {[f'{e:.1e}' for e in e_stage]}", flush=True)
            if not max(e_end) <= TOL["head_bf16_emulated_rel"] or not (
                max(e_stage) <= TOL["head_bf16_emulated_stage_rel"]
            ):
                fail("head_interior bf16 disagrees with the emulation of its roundings")
            del y_e, g_e, inter_e, y_s, z_s, g_s, dph_s, dz_s
        if dtype != torch.bfloat16:
            continue
        ms = {
            "fwd": time_ms(lambda: hk.head_interior(*inputs), iters=5),
            "fwd_plain": time_ms(lambda: hk.head_interior_plain(*inputs), iters=5),
            "bwd": time_ms(lambda: grads_of(out_k, inputs, g), iters=5),
            "bwd_plain": time_ms(lambda: grads_of(out_p, inputs, g), iters=5),
        }
        bounds = head_bound(n, h, w, 2)
        for d, err in (("fwd", abs_err(out_k, out_p)),
                       ("bwd", max(abs_err(a, b) for a, b in zip(g_k, g_p)))):
            b_ms, b_by = bound_ms(*bounds[d], "bfloat16")
            rows.append(dict(
                name=f"head_interior_{d}", route="cuda",
                source="flowmap_tpu_torch/ops/kernels/csrc/head_kernel.cu",
                replaces="flowmap_tpu/ops/pallas/head_kernel.py:" + ("245" if d == "fwd" else "278"),
                max_abs_err=err, ms=ms[d], plain_ms=ms[f"{d}_plain"], bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
            ))
    return rows


def check_track_loss(batch, depths, tracks) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from flowmap_tpu_torch.loss.mapping import MappingCfg
    from flowmap_tpu_torch.ops import surface
    from flowmap_tpu_torch.ops.geometry import sample_image_grid, unproject
    from flowmap_tpu_torch.ops.kernels import build
    from flowmap_tpu_torch.ops.kernels import track_loss as tl
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    h, w = IMAGE_SHAPE
    mapping = MappingCfg("huber", 0.01)
    _, s, l, p, _ = tracks.xy.shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    xy_grid, _ = sample_image_grid((h, w), "cuda")
    noisy = depths * (1 + 0.05 * torch.randn(depths.shape, generator=gen, device="cuda"))
    surfaces = unproject(xy_grid, noisy, batch.intrinsics[:, :, None, None]).contiguous()
    extrinsics = batch.extrinsics.clone()
    extrinsics[..., :3, 3] += 0.01 * torch.randn(extrinsics[..., :3, 3].shape, generator=gen, device="cuda")
    inputs = [t.requires_grad_(True) for t in (surfaces, extrinsics, batch.intrinsics.clone())]

    def kernel():
        return tl.track_loss(*inputs, tracks, (h, w), 0.01)

    def plain():
        return tl.track_loss_plain(*inputs, tracks, (h, w), mapping)

    (out_k, valid_k), (out_p, valid_p) = kernel(), plain()
    err_v = rel_err(out_k, out_p)
    err_n = abs(float(valid_k) - float(valid_p)) / float(valid_p)
    g_k, g_p = grads_of(out_k, inputs), grads_of(out_p, inputs)
    err_g = [rel_l2(a, b) for a, b in zip(g_k, g_p)]
    print(f"[D track_loss f32] {s} x {l} x {p} tracks on {NUM_FRAMES} x {h} x {w} surfaces, in "
          f"one piece: loss sum {float(out_k.detach()):.4f} vs plain {float(out_p.detach()):.4f}: "
          f"rel {err_v:.3e}; valid {float(valid_k):.0f} vs {float(valid_p):.0f}; grads "
          f"(surfaces, extrinsics, intrinsics) rel L2 {[f'{e:.2e}' for e in err_g]}, max rel "
          f"{[f'{rel_err(a, b):.2e}' for a, b in zip(g_k, g_p)]}", flush=True)
    if not float(valid_p) > 0 or not all(bool(torch.isfinite(g).all()) for g in g_k):
        fail("track_loss: no valid pair, or a gradient is not finite")
    if (not err_v <= TOL["track_loss_value_rel"] or not err_n <= TOL["track_loss_valid_rel"]
            or not max(err_g) <= TOL["track_loss_grad_rel_l2"]):
        fail("track_loss disagrees with its plain version")
    again = grads_of(out_k, inputs)[0]
    print(f"[D track_loss] d_surfaces by atomics, two runs of the backward: max abs difference "
          f"{abs_err(again, g_k[0]):.3e} (max |d_surfaces| {float(g_k[0].abs().max()):.3e})",
          flush=True)
    ms_wrapper = {
        "fwd": time_ms(kernel), "fwd_plain": time_ms(plain, iters=3),
        "bwd": time_ms(lambda: grads_of(out_k, inputs)),
        "bwd_plain": time_ms(lambda: grads_of(out_p, inputs), iters=3),
    }
    del out_p, g_p, valid_p

    # Each of the four kernels against its part of the plain version, on the
    # same inputs, and timed alone through its C entry point.
    surf = surfaces[0].detach()
    xy, vis = tracks.xy[0].contiguous(), tracks.visibility[0].contiguous()
    starts = tracks.starts.to(torch.int32).contiguous()
    frame_idx = tracks.frame_index()
    m = tl.fold_pair_projections(extrinsics[0].detach(), batch.intrinsics[0], frame_idx)
    m_flat = m.reshape(s, l, l, 12).contiguous()
    g_one = torch.ones(1, device="cuda")

    surf_p = surf[None].clone().requires_grad_(True)
    xyz_p, _ = surface.sample_track_points_packed(surf_p, tracks)
    xyz_k = tl.sample_forward(surf, xy, starts)
    xyz_in = xyz_k.clone().requires_grad_(True)
    m_in = m.clone().requires_grad_(True)
    sum_p, _ = tl.pair_loss_plain(xyz_in, m_in, tracks, (h, w), mapping)
    sums_k = tl.pair_forward(xyz_k, m_flat, xy, vis, (h, w), 0.01)
    d_xyz_p, d_m_p = grads_of(sum_p, [xyz_in, m_in])
    d_xyz_k, d_m_k = tl.pair_backward(xyz_k, m_flat, xy, vis, (h, w), 0.01, g_one)
    d_surf_p = grads_of(xyz_p, [surf_p], d_xyz_k)[0][0]
    d_surf_k = tl.sample_backward(surf.shape, xy, starts, d_xyz_k)
    errs = {
        "sample_fwd": abs_err(xyz_k, xyz_p),
        "sample_bwd": abs_err(d_surf_k, d_surf_p),
        "pair_fwd": abs_err(sums_k[0], sum_p),
        "pair_bwd": max(abs_err(d_xyz_k, d_xyz_p), abs_err(d_m_k.reshape(m.shape), d_m_p)),
    }
    scales = {
        "sample_fwd": float(xyz_p.detach().abs().max()),
        "sample_bwd": float(d_surf_p.abs().max()),
        "pair_fwd": float(sum_p.detach().abs()),
    }
    rels = {k: errs[k] / scales[k] for k in scales}
    d_m_k = d_m_k.reshape(m.shape)
    off = (d_xyz_k - d_xyz_p).abs() > 1e-4 * d_xyz_p.abs().max()
    pair_bwd = {
        "d_xyz_rel_l2": rel_l2(d_xyz_k, d_xyz_p), "d_m_rel_l2": rel_l2(d_m_k, d_m_p),
        "d_xyz_max_rel": rel_err(d_xyz_k, d_xyz_p), "d_m_max_rel": rel_err(d_m_k, d_m_p),
        "d_xyz_off_share": float(off.float().mean()),
    }
    print(f"[D track_loss, kernel by kernel, same inputs] max abs err {errs}; relative to the "
          f"largest value {({k: f'{v:.2e}' for k, v in rels.items()})}; pair backward "
          f"{({k: f'{v:.2e}' for k, v in pair_bwd.items()})}, {int(off.any(dim=-1).sum())} of "
          f"{s * l * p} points off", flush=True)
    if (any(v > TOL["track_kernel_rel"] for v in rels.values())
            or max(pair_bwd["d_xyz_rel_l2"], pair_bwd["d_m_rel_l2"]) > TOL["track_pair_bwd_rel_l2"]
            or pair_bwd["d_xyz_off_share"] > TOL["track_pair_bwd_off_share"]
            or pair_bwd["d_m_max_rel"] > TOL["track_pair_bwd_dm_rel"]):
        fail("a track_loss kernel disagrees with its part of the plain version")
    # The in-frame step again: both f32 versions against a float64 run of the
    # plain pair loss on the same xyz.
    tracks64 = type(tracks)(xy=tracks.xy.double(), visibility=tracks.visibility,
                            starts=tracks.starts)
    xyz64 = xyz_k.double().requires_grad_(True)
    sum64, _ = tl.pair_loss_plain(xyz64, m.double(), tracks64, (h, w), mapping)
    (d_xyz64,) = grads_of(sum64, [xyz64])
    print(f"[D track_loss] d_xyz against a float64 run on the same xyz, rel L2 / max abs: kernel "
          f"{rel_l2(d_xyz_k, d_xyz64):.3e} / {abs_err(d_xyz_k, d_xyz64):.3e}, plain "
          f"{rel_l2(d_xyz_p, d_xyz64):.3e} / {abs_err(d_xyz_p, d_xyz64):.3e} "
          f"(max |d_xyz| {float(d_xyz_p.abs().max()):.3e})", flush=True)
    del tracks64, xyz64, sum64, d_xyz64

    lib, stream = tl._lib(), build.stream_ptr(surf.device)
    tiles = tl._num_tiles(p)
    partial = torch.empty((s, l, tiles, 2), device="cuda")
    dm_partial = torch.empty((s, l, tiles, l, 12), device="cuda")
    xyz_buf, d_xyz_buf = torch.empty_like(xyz_k), torch.empty_like(xyz_k)
    d_surf_buf = torch.zeros_like(surf)
    dims = tl._sample_dims(surf.shape, xy)
    pair_args = tl._pair_args(xyz_k, m_flat, xy, vis, (h, w), 0.01)

    def entry(name, *args):
        return lambda: build.check(getattr(lib, name)(*args, stream), name)

    def sample_bwd_entry():
        d_surf_buf.zero_()  # the scatter needs it cleared: part of the kernel's work
        build.check(lib.track_sample_bwd(
            build.ptr(xy), build.ptr(starts), build.ptr(d_xyz_k), build.ptr(d_surf_buf),
            *dims, stream), "track_sample_bwd")

    seg_nchw = surf.permute(0, 3, 1, 2)[frame_idx.reshape(-1)].contiguous().requires_grad_(True)
    lib_grid = (xy.reshape(s * l, p, 1, 2) * 2 - 1).contiguous()

    def library():
        return F.grid_sample(seg_nchw, lib_grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    out_l = library()
    e_lib = abs_err(out_l[..., 0].permute(0, 2, 1).reshape(xyz_k.shape), xyz_k)
    g_lib = d_xyz_k.reshape(s * l, p, 3).permute(0, 2, 1)[..., None].contiguous()
    ms = {
        "sample_fwd": time_ms(entry("track_sample_fwd", build.ptr(surf), build.ptr(xy),
                                    build.ptr(starts), build.ptr(xyz_buf), *dims), iters=20),
        "sample_bwd": time_ms(sample_bwd_entry, iters=20),
        "pair_fwd": time_ms(entry("track_pair_fwd", *pair_args, build.ptr(partial)), iters=20),
        "pair_bwd": time_ms(entry("track_pair_bwd", *pair_args, build.ptr(g_one),
                                  build.ptr(dm_partial), build.ptr(d_xyz_buf)), iters=20),
        "sample_fwd_plain": time_ms(
            lambda: surface.sample_track_points_packed(surf_p, tracks), iters=3),
        "sample_bwd_plain": time_ms(lambda: grads_of(xyz_p, [surf_p], d_xyz_k), iters=3),
        "pair_fwd_plain": time_ms(
            lambda: tl.pair_loss_plain(xyz_in, m_in, tracks, (h, w), mapping), iters=3),
        "pair_bwd_plain": time_ms(lambda: grads_of(sum_p, [xyz_in, m_in]), iters=3),
        "sample_fwd_lib": time_ms(library),
        "sample_bwd_lib": time_ms(lambda: grads_of(out_l, [seg_nchw], g_lib)),
    }
    corner_frames = frame_idx[:, :, None].expand(s, l, p).reshape(-1)
    px = (xy[..., 0] * w - 0.5).reshape(-1)
    py = (xy[..., 1] * h - 0.5).reshape(-1)
    texel_ids = torch.cat([
        (corner_frames * h + (torch.floor(py) + a).clamp(0, h - 1).long()) * w
        + (torch.floor(px) + b).clamp(0, w - 1).long()
        for a in (0, 1) for b in (0, 1)
    ])
    texels = int(torch.unique(texel_ids).numel())
    bounds = track_loss_bound(NUM_FRAMES, h, w, s, l, p, texels)
    print(f"[D track_loss] ms fwd / bwd: wrapper (fold of M, both kernels, sums) "
          f"{ms_wrapper['fwd']:.4f} / {ms_wrapper['bwd']:.4f}, plain {ms_wrapper['fwd_plain']:.3f} / "
          f"{ms_wrapper['bwd_plain']:.3f}; C entries alone: sample {ms['sample_fwd']:.4f} / "
          f"{ms['sample_bwd']:.4f} (with the clearing of d_surface), pair {ms['pair_fwd']:.4f} / "
          f"{ms['pair_bwd']:.4f}; bounds: sample "
          f"{bound_ms(*bounds['sample_fwd'], 'float32')[0]:.4f} / "
          f"{bound_ms(*bounds['sample_bwd'], 'float32')[0]:.4f}, pair "
          f"{bound_ms(*bounds['pair_fwd'], 'float32')[0]:.4f} / "
          f"{bound_ms(*bounds['pair_bwd'], 'float32')[0]:.4f}; {texels} distinct texels touched; "
          f"F.grid_sample(border) on the gathered frames: {ms['sample_fwd_lib']:.4f} / "
          f"{ms['sample_bwd_lib']:.4f} (max abs {e_lib:.2e} from the kernel; its backward does "
          f"not sum a frame's segments)", flush=True)
    lines = {"sample_fwd": "293", "sample_bwd": "323", "pair_fwd": "358", "pair_bwd": "395"}
    rows = []
    for name, line in lines.items():
        b_ms, b_by = bound_ms(*bounds[name], "float32")
        rows.append(dict(
            name=f"track_{name}", route="cuda",
            source="flowmap_tpu_torch/ops/kernels/csrc/track_loss.cu",
            replaces=f"flowmap_tpu/ops/pallas/track_loss.py:{line}",
            max_abs_err=errs[name], ms=ms[name], plain_ms=ms[f"{name}_plain"], bound_ms=b_ms,
            bound_by=b_by, library_ms=ms.get(f"{name}_lib"),
        ))
    return rows


def check_warp_features(flows, model_cfg) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from flowmap_tpu_torch.ops.geometry import sample_image_grid
    from flowmap_tpu_torch.ops.kernels import warp_features as wf
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    h, w = IMAGE_SHAPE
    n, hn, wn, c = NUM_FRAMES - 1, h // 2, w // 2, 64
    radius = max(1, model_cfg.backbone.warp_radius_half)
    fb_half = flows.backward[0].reshape(n, hn, 2, wn, 2, 2).mean(dim=(2, 4))
    xy, _ = sample_image_grid((hn, wn), "cuda")
    grid = ((xy + fb_half) * 2.0 - 1.0).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        feats = torch.randn((n, c, hn, wn), generator=gen, device="cuda").to(dtype)
        feats.requires_grad_(True)
        g = torch.randn(feats.shape, generator=gen, device="cuda").to(dtype)
        results = {}
        # The autosized radius, and one below the displacements, where the
        # window drops corners.
        for r in (radius, 0):
            out_k, out_p = wf.warp_features(feats, grid, r), wf.warp_features_plain(feats, grid, r)
            (d_k,), (d_p,) = grads_of(out_k, [feats], g), grads_of(out_p, [feats], g)
            e_f, e_b = rel_err(out_k, out_p), rel_err(d_k, d_p)
            n_f = int((out_k != out_p).sum())
            print(f"[E warp_features {name}] radius {r}: fwd max rel {e_f:.3e} ({n_f} of "
                  f"{out_k.numel()} values differ), bwd max rel {e_b:.3e}", flush=True)
            if max(e_f, e_b) > TOL[f"warp_features_{name}_rel"]:
                fail(f"warp_features {name} disagrees with its plain version at radius {r}")
            results[r] = (out_k, out_p, d_k, d_p)
        cut = abs_err(results[radius][0], results[0][0])
        if not cut > 1e-2:
            fail("warp_features: radius 0 cut nothing, the window is not exercised")
        out_k, out_p, d_k, d_p = results[radius]
        del results
        if dtype != torch.bfloat16:
            continue
        again = grads_of(out_k, [feats], g)[0]
        print(f"[E warp_features bf16] feature gradient by atomics, two runs: "
              f"{int((again != d_k).sum())} of {d_k.numel()} values differ, max abs "
              f"{abs_err(again, d_k):.3e}; radius 0 moves the result by up to {cut:.3f}", flush=True)

        def library():
            return F.grid_sample(feats, grid.to(dtype), mode="bilinear",
                                 padding_mode="zeros", align_corners=False)

        out_l = library()
        print(f"[E warp_features bf16] F.grid_sample(zeros), grid in bf16, unbounded rows: max "
              f"abs {abs_err(out_l, out_k):.3e} from the kernel", flush=True)
        ms = {
            "fwd": time_ms(lambda: wf.warp_features(feats, grid, radius)),
            "fwd_plain": time_ms(lambda: wf.warp_features_plain(feats, grid, radius), iters=3),
            "fwd_lib": time_ms(library),
            "bwd": time_ms(lambda: grads_of(out_k, [feats], g)),
            "bwd_plain": time_ms(lambda: grads_of(out_p, [feats], g), iters=3),
            "bwd_lib": time_ms(lambda: grads_of(out_l, [feats], g)),
        }
        bounds = warp_features_bound(n, hn, wn, c, 2)
        for d, err in (("fwd", abs_err(out_k, out_p)), ("bwd", abs_err(d_k, d_p))):
            b_ms, b_by = bound_ms(*bounds[d], "bfloat16")
            rows.append(dict(
                name=f"warp_features_{d}", route="cuda",
                source="flowmap_tpu_torch/ops/kernels/csrc/warp_features.cu",
                replaces="flowmap_tpu/ops/pallas/warp_kernel.py:" + ("290" if d == "fwd" else "334"),
                max_abs_err=err, ms=ms[d], plain_ms=ms[f"{d}_plain"], bound_ms=b_ms,
                bound_by=b_by, library_ms=ms[f"{d}_lib"],
            ))
    return rows


def check_correlation() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from flowmap_tpu_torch.flow.gmflow import coords_grid, shift_window_attn_mask
    from flowmap_tpu_torch.ops.kernels import correlation as corr

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # GMFlow at 640x896: the 1/8 grid is 80x112; a chunk of 8 pairs is 16
    # images, 64 windows of 40x56.
    h8, w8, c = 80, 112, 128
    lw, lg = (h8 // 2) * (w8 // 2), h8 * w8
    mask = torch.as_tensor(shift_window_attn_mask(h8, w8, 2)).cuda()
    grid = coords_grid(h8, w8, "cuda").reshape(lg, 2)
    f0 = rnd(8, lg, c)
    # A match 37 tokens away that scores ~9 above the rest: a peaked softmax.
    f1 = 0.8 * torch.roll(f0, 37, dims=1) + 0.6 * rnd(8, lg, c)
    rag_bias = torch.where(torch.rand((4, 450, 450), generator=gen, device="cuda") < 0.3, -100.0, 0.0)
    cases = {
        # name: (q, k, values, bias, limit, its unit, library's view of the batch)
        "window": (rnd(64, lw, c), rnd(64, lw, c), rnd(64, lw, c), mask,
                   "softmax_expectation_rel", "of max", (16, 4)),
        "correlation": (f0, f1, grid[None].expand(8, lg, 2), None,
                        "softmax_expectation_px", "px", (8, 1)),
        # The pretrain windows' length: 450 = 7 * 64 + 2.
        "ragged": (rnd(8, 450, c), rnd(8, 450, c), rnd(8, 450, c), rag_bias,
                   "softmax_expectation_rel", "of max", (2, 4)),
    }
    rows = []
    for name, (q, k, v, bias, tol, unit, (lb, lh)) in cases.items():
        b, l, _ = q.shape
        d = v.shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            qd, kd = q.to(dtype), k.to(dtype)
            out_k = corr.softmax_expectation(qd, kd, v, bias)
            torch.cuda.synchronize()
            out_p = corr.softmax_expectation_plain(qd, kd, v, bias)
            err = abs_err(out_k, out_p)
            shown = err if unit == "px" else err / float(out_p.abs().max())
            print(f"[F softmax_expectation {name} {tag}] ({b}, {l}, {c}) d={d} bias "
                  f"{None if bias is None else tuple(bias.shape)}: max err {shown:.3e} {unit} "
                  f"(max |plain| {float(out_p.abs().max()):.3f})", flush=True)
            if name == "correlation":
                # Both f32 versions against the plain version in float64.
                out_64 = corr.softmax_expectation_plain(qd, kd, v, bias, dtype=torch.float64)
                e_k64, e_p64 = abs_err(out_k, out_64), abs_err(out_p, out_64)
                print(f"[F softmax_expectation {name} {tag}] against float64, max px: kernel "
                      f"{e_k64:.3e}, plain {e_p64:.3e}", flush=True)
                del out_64
                if not e_k64 <= TOL["softmax_expectation_px_f64"]:
                    fail(f"softmax_expectation {name} {tag} is off its float64 reference")
            if not bool(torch.isfinite(out_k).all()) or not shown <= TOL[tol]:
                fail(f"softmax_expectation {name} {tag} disagrees with its plain version")
            if name == "ragged":
                continue

            def library():
                # One PyTorch call for the same function: heads stand for the
                # windows of one image, so that the mask broadcasts.
                return F.scaled_dot_product_attention(
                    qd.reshape(lb, lh, l, c), kd.reshape(lb, lh, l, c),
                    v.to(dtype).reshape(lb, lh, l, d), attn_mask=None if bias is None else bias.to(dtype),
                    scale=c**-0.5,
                )

            e_lib = abs_err(library().reshape(b, l, d), out_p)
            ms = {
                "k": time_ms(lambda: corr.softmax_expectation(qd, kd, v, bias), iters=5, warmup=1),
                "p": time_ms(lambda: corr.softmax_expectation_plain(qd, kd, v, bias), iters=3, warmup=1),
                "l": time_ms(library, iters=3, warmup=1),
            }
            nbytes, ops = softmax_expectation_bound(
                b, l, c, d, qd.element_size(), 0 if bias is None else bias.shape[0])
            b_ms, b_by = bound_ms(nbytes, ops, "float32")
            print(f"[F softmax_expectation {name} {tag}] ms kernel {ms['k']:.4f}, plain {ms['p']:.4f}, "
                  f"F.scaled_dot_product_attention {ms['l']:.4f} (max abs {e_lib:.2e} from plain), "
                  f"bound {b_ms:.4f} by {b_by}: {ops / ms['k'] / 1e9:.2f} TFLOP/s", flush=True)
            if dtype == torch.float32:
                rows.append(dict(
                    name=f"softmax_expectation_fwd_d{d}", route="cuda",
                    source="flowmap_tpu_torch/ops/kernels/csrc/correlation.cu",
                    replaces="flowmap_tpu/ops/pallas/correlation.py:" + ("116" if bias is None else "134"),
                    max_abs_err=err, ms=ms["k"], plain_ms=ms["p"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=ms["l"],
                ))
        del out_k, out_p
    return rows


def check_dense_warp() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from flowmap_tpu_torch.ops.kernels import dense_warp as dw
    from flowmap_tpu_torch.training.flagship import NUM_FRAMES, SOURCE_SHAPE

    n, c, (h, w) = NUM_FRAMES - 1, 3, SOURCE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    images = torch.rand((n, c, h, w), generator=gen, device="cuda")
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    # A smooth displacement field of tens of pixels, as the flow of a scene is
    # (noise at 1/64 of the resolution, enlarged: neighbouring samples lie
    # ~0.5 px further apart than their pixels), and one pixel in 16 thrown
    # up to three image sizes away.
    smooth = F.interpolate(torch.randn((n, 2, h // 64, w // 64), generator=gen, device="cuda"),
                           size=(h, w), mode="bilinear", align_corners=False) * 30
    far = (torch.rand((n, 2, h, w), generator=gen, device="cuda") < 1 / 32).float()
    jump = torch.randn((n, 2, h, w), generator=gen, device="cuda") * far
    px = xs + smooth[:, 0] + jump[:, 0] * 3 * w
    py = ys + smooth[:, 1] + jump[:, 1] * 3 * h
    del smooth, far, jump
    outside = float(((px < -1) | (px > w) | (py < -1) | (py > h)).float().mean())
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for mode in ("zeros", "border"):
            out_k = dw.dense_warp_bilinear_planar(images, px, py, mode, dtype)
            torch.cuda.synchronize()
            out_p = dw.dense_warp_bilinear_planar_plain(images, px, py, mode, dtype)
            err = abs_err(out_k, out_p)
            print(f"[G dense_warp {tag} {mode}] ({n}, {c}, {h}, {w}), {outside:.1%} of the "
                  f"samples outside the image: max abs err {err:.3e} "
                  f"({int((out_k != out_p).sum())} of {out_k.numel()} values differ)", flush=True)
            if not bool(torch.isfinite(out_k).all()) or not err <= TOL["dense_warp_abs"]:
                fail(f"dense_warp {tag} {mode} disagrees with its plain version")
            if (dtype, mode) != (torch.float32, "zeros"):
                del out_k, out_p
                continue
            lib_grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], dim=-1)

            def library():
                return F.grid_sample(images, lib_grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)

            # Far outside, the normalised grid has lost the fraction's low
            # bits: the library's result is compared where the sample is near.
            near = ((px.abs() < 2 * w) & (py.abs() < 2 * h))[:, None]
            e_lib = float(((library() - out_p).abs() * near).max())
            ms = {
                "k": time_ms(lambda: dw.dense_warp_bilinear_planar(images, px, py, mode, dtype)),
                "p": time_ms(lambda: dw.dense_warp_bilinear_planar_plain(images, px, py, mode, dtype),
                             iters=3, warmup=1),
                "l": time_ms(library),
            }
            b_ms, b_by = bound_ms(*dense_warp_bound(n, c, h, w, 4), "float32")
            # The worst field: every sample displaced on its own (30 px of
            # white noise), so that no two threads share a 32-byte sector.
            nx = xs + torch.randn((n, h, w), generator=gen, device="cuda") * 30
            ny = ys + torch.randn((n, h, w), generator=gen, device="cuda") * 30
            ms_noise = time_ms(lambda: dw.dense_warp_bilinear_planar(images, nx, ny, mode, dtype))
            del nx, ny
            print(f"[G dense_warp] ms kernel {ms['k']:.4f} (on white-noise displacements "
                  f"{ms_noise:.4f}), plain {ms['p']:.3f}, F.grid_sample {ms['l']:.4f} (max abs "
                  f"{e_lib:.2e} from plain near the image), bound {b_ms:.4f} by {b_by}", flush=True)
            rows.append(dict(
                name="dense_warp_fwd", route="cuda",
                source="flowmap_tpu_torch/ops/kernels/csrc/dense_warp.cu",
                replaces="flowmap_tpu/ops/pallas/dense_warp.py:200",
                max_abs_err=err, ms=ms["k"], plain_ms=ms["p"], bound_ms=b_ms, bound_by=b_by,
                library_ms=ms["l"],
            ))
            del out_k, out_p, lib_grid
    return rows


def mlp_params(dtype, gen, scale: float = 1.0):
    """(w0, b0, w1, b1, w2, b2) on the card as leaves: weights in `dtype`
    with the Kaiming scale of the backbone's init (times `scale` on the first
    layer), biases f32."""
    import torch

    def rnd(*shape, s):
        return torch.randn(shape, generator=gen, device="cuda") * s

    params = (rnd(128, 128, s=scale * (2 / 128) ** 0.5).to(dtype), rnd(128, s=0.1),
              rnd(64, 128, s=(2 / 128) ** 0.5).to(dtype), rnd(64, s=0.1),
              rnd(1, 64, s=(2 / 64) ** 0.5).to(dtype), rnd(1, s=0.1))
    return [t.requires_grad_(True) for t in params]


def mlp_rows(kernel: str, source: str, replaces: tuple[str, str], bounds, errs, ms) -> list[dict]:
    rows = []
    for d, line in zip(("fwd", "bwd"), replaces):
        b_ms, b_by = bound_ms(*bounds[d], "bfloat16")
        rows.append(dict(
            name=f"{kernel}_{d}", route="cuda", source=source, replaces=line,
            max_abs_err=errs[d], ms=ms[d], plain_ms=ms[f"{d}_plain"], bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        ))
    return rows


def compare_mlp_kernel(tag, name, run_k, run_p, inputs, g, out_tol, grad_tol, out_abs=False):
    """Forward and backward of a kernel against its plain version; returns
    (outputs, max abs errors). Gradients in relative L2 over every input;
    the parameter gradients of a second kernel run must be the same bits."""
    import torch

    out_k, out_p = run_k(), run_p()
    e_out = abs_err(out_k, out_p) if out_abs else rel_err(out_k, out_p)
    d_k = grads_of(out_k, inputs, g)
    d_p = grads_of(out_p, inputs, g)
    e_grad = max(rel_l2(a, b) for a, b in zip(d_k, d_p))
    again = grads_of(out_k, inputs, g)
    same_params = all(torch.equal(a, b) for a, b in zip(again[-6:], d_k[-6:]))
    n_in = int((again[0] != d_k[0]).sum())
    print(f"[{tag}] {name}: fwd max {'abs' if out_abs else 'rel'} {e_out:.3e}, "
          f"grads worst rel L2 {e_grad:.3e} (per input "
          f"{[float('%.2e' % rel_l2(a, b)) for a, b in zip(d_k, d_p)]}); second run: "
          f"parameter gradients {'equal' if same_params else 'DIFFER'}, "
          f"{n_in} of {d_k[0].numel()} input-gradient values differ", flush=True)
    if e_out > out_tol or e_grad > grad_tol:
        fail(f"{tag} {name} disagrees with its plain version")
    if not same_params:
        fail(f"{tag}: the parameter gradients are not the same bits on a second run")
    errs = {"fwd": abs_err(out_k, out_p),
            "bwd": max(abs_err(a, b) for a, b in zip(d_k, d_p))}
    return (out_k, out_p), errs


def check_weight_mlp() -> list[dict]:
    """I at the native path's shape: 149 x 80 x 112 pixels, f32 and bf16."""
    import torch

    from flowmap_tpu_torch.ops.kernels import weight_mlp as wm
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    p = (NUM_FRAMES - 1) * (IMAGE_SHAPE[0] // 2) * (IMAGE_SHAPE[1] // 2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        wa, la = (torch.randn((p, 64), generator=gen, device="cuda").mul_(0.5).to(dtype)
                  .requires_grad_(True) for _ in range(2))
        params = mlp_params(dtype, gen)
        inputs = [wa, la, *params]
        g = torch.randn(p, generator=gen, device="cuda")
        (out_k, out_p), errs = compare_mlp_kernel(
            "I weight_mlp", name, lambda: wm.weight_mlp(*inputs), lambda: wm.weight_mlp_plain(*inputs),
            inputs, g, TOL[f"weight_mlp_{name}_rel"], TOL[f"mlp_{name}_grad_rel_l2"])
        if dtype != torch.bfloat16:
            continue
        ms = {
            "fwd": time_ms(lambda: wm.weight_mlp(*inputs)),
            "fwd_plain": time_ms(lambda: wm.weight_mlp_plain(*inputs), iters=3),
            "bwd": time_ms(lambda: grads_of(out_k, inputs, g)),
            "bwd_plain": time_ms(lambda: grads_of(out_p, inputs, g), iters=3),
        }
        print(f"[I weight_mlp] bf16 ms {ms}", flush=True)
        rows += mlp_rows("weight_mlp", "flowmap_tpu_torch/ops/kernels/csrc/weight_mlp.cu",
                         ("flowmap_tpu/ops/pallas/weight_mlp.py:158",
                          "flowmap_tpu/ops/pallas/weight_mlp.py:182"),
                         weight_mlp_bound(p, 2), errs, ms)
    return rows


def check_corr_weights(flows, radius: int) -> list[dict]:
    """H at the full-resolution path's shapes: native features (150, 80,
    112, 64), the scene's full-resolution grid, the autosized radius and a
    radius of 0 (where the window drops corners), f32 and bf16."""
    import torch

    from flowmap_tpu_torch.ops.geometry import sample_image_grid
    from flowmap_tpu_torch.ops.kernels import corr_weights as cw
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES

    h, w = IMAGE_SHAPE
    xy, _ = sample_image_grid((h, w), "cuda")
    grid = ((xy + flows.backward[0].float()) * 2.0 - 1.0).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        feats = torch.randn((NUM_FRAMES, h // 2, w // 2, 64), generator=gen, device="cuda")
        feats = feats.to(dtype).requires_grad_(True)
        # A first layer 3x the init's scale spreads the weights over (0, 1).
        params = mlp_params(dtype, gen, scale=3.0)
        inputs = [feats, *params]
        g = torch.randn((NUM_FRAMES - 1, h, w), generator=gen, device="cuda")
        outs = {}
        for r in (radius, 0):
            outs[r], errs = compare_mlp_kernel(
                "H corr_weights", f"{name} radius {r}",
                lambda: cw.corr_weights(feats, grid, *params, r),
                lambda: cw.corr_weights_plain(feats, grid, *params, r),
                inputs, g, TOL[f"corr_weights_{name}_abs"], TOL[f"mlp_{name}_grad_rel_l2"],
                out_abs=True)
            if r == radius:
                keep = errs
            else:  # only its weights are needed now; free the plain graph
                outs[r] = (outs[r][0].detach(), None)
        cut = abs_err(outs[radius][0], outs[0][0])
        print(f"[H corr_weights] {name}: radius 0 moves the weights by up to {cut:.3f}; "
              f"weights in [{float(outs[radius][0].min()):.4f}, "
              f"{float(outs[radius][0].max()):.4f}]", flush=True)
        if not cut > 1e-3:
            fail("corr_weights: radius 0 cut nothing, the window is not exercised")
        out_k, out_p = outs[radius]
        del outs
        if dtype != torch.bfloat16:
            continue
        ms = {
            "fwd": time_ms(lambda: cw.corr_weights(feats, grid, *params, radius)),
            "fwd_plain": time_ms(lambda: cw.corr_weights_plain(feats, grid, *params, radius),
                                 iters=2, warmup=1),
            "bwd": time_ms(lambda: grads_of(out_k, inputs, g)),
            "bwd_plain": time_ms(lambda: grads_of(out_p, inputs, g), iters=2, warmup=1),
        }
        print(f"[H corr_weights] bf16 ms {ms}", flush=True)
        rows += mlp_rows("corr_weights", "flowmap_tpu_torch/ops/kernels/csrc/corr_weights.cu",
                         ("flowmap_tpu/ops/pallas/corr_weights.py:468",
                          "flowmap_tpu/ops/pallas/corr_weights.py:944"),
                         corr_weights_bound(NUM_FRAMES - 1, h // 2, w // 2, 2), keep, ms)
    return rows


def check_small_step() -> None:
    """Two f32 train steps (flow and tracking losses) on a small scene:
    kernels on the card vs the plain versions on the CPU. Compares both
    losses and every gradient leaf of the first step (per leaf, relative to
    max(|leaf|, 1e-3 * the largest leaf))."""
    import torch

    from flowmap_tpu_torch.training import flagship
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    results = {}
    for device in ("cpu", "cuda"):
        batch, flows, depths = flagship.scene(device, num_frames=8, image_shape=(64, 96))
        tracks = flagship.tracks(batch, depths, interval=2, radius=3, grid_size=6)
        cfg = flagship.model_cfg(flows, compute_dtype="float32")
        state = init_train_state(cfg, OverfitTrainerCfg(), 8, (64, 96), device=device)
        step = make_train_step(cfg, flagship.loss_cfgs(tracking_after=0))
        indices = torch.arange(0, 64 * 96, 3, device=device)
        first = step(state, batch, flows, tracks, intrinsics_indices=indices)
        if not float(first["loss/tracking"]) > 0:
            fail("small step: the tracking loss is zero")
        losses = [float(first["loss/total"])]
        grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
        losses.append(float(
            step(state, batch, flows, tracks, intrinsics_indices=indices)["loss/total"]))
        results[device] = (losses, grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    e_loss = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    e_grad = {
        k: float((g_gpu[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()), floor)
        for k in g_cpu
    }
    worst = max(e_grad, key=e_grad.get)
    print(f"[small step] losses gpu {l_gpu} cpu {l_cpu}: rel {e_loss:.3e}; "
          f"step-1 gradients: worst leaf {worst} rel {e_grad[worst]:.3e}", flush=True)
    if not all(math.isfinite(x) for x in l_gpu):
        fail("small step loss not finite")
    if not e_loss <= TOL["step_loss_rel"] or not e_grad[worst] <= TOL["step_grad_rel"]:
        fail("the train step on the card disagrees with the CPU reference")


STEP_KERNELS = ("flow_loss", "shift_warp", "head_interior", "track", "warp_features")


def run_main_path(batch, flows, tracks, warp_impl: str, warmup: int, timed: int,
                  tag: str = "main", precomputed: bool = False) -> dict:
    """The full-width overfit step with both losses, on the shift warp
    ("fused") or on the bounded-radius warp ("pallas"). With `precomputed`
    the flows and tracks are the precompute's own (GMFlow with random
    weights): either warp may be selected by the radii, the launch counts
    are left running from the precompute, and the tracking loss may be zero.
    Returns the launch counts when the steps are done."""
    import torch

    from flowmap_tpu_torch.ops import kernels
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES, loss_cfgs, model_cfg
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    tag = f"{tag}, warp_impl={warp_impl}"
    cfg = model_cfg(flows, warp_impl=warp_impl)
    bb = cfg.backbone
    ry, rx = bb.warp_radius_half, bb.warp_radius_half_x
    taps = (2 * ry + 2) * (2 * rx + 2)
    print(f"[{tag}] warp radii: full ({bb.warp_radius}, {bb.warp_radius_x}), "
          f"half ({ry}, {rx}), tap window {taps}", flush=True)
    if taps > 256 and not precomputed:
        fail("the shift-warp branch is not taken at the main path's radii")
    # The warp this path must take, and the one it must leave alone.
    used, unused = ("shift_warp", "warp_features") if warp_impl == "fused" and taps <= 256 else (
        "warp_features", "shift_warp")
    print(f"[{tag}] the weights path warps through {used}", flush=True)

    state = init_train_state(cfg, OverfitTrainerCfg(lr=3e-5), NUM_FRAMES, IMAGE_SHAPE)
    # The tracking loss's gate opens at step 50 in the product; here it is
    # open from step 0, so that these few steps run its backward with a
    # cotangent that is not zero.
    step = make_train_step(cfg, loss_cfgs(tracking_after=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    if not precomputed:
        kernels.reset_launch_counts()
    at_start = kernels.launch_counts()
    losses, tracking, step_times = [], [], []
    for i in range(warmup + timed):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, batch, flows, tracks)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        after = kernels.launch_counts()
        idle = [k for k in after if after[k] <= before[k] and k.startswith(STEP_KERNELS)
                and not k.startswith(unused)]
        if idle:
            fail(f"[{tag}] step {i}: kernels not launched: {idle}")
        losses.append(float(metrics["loss/total"]))
        tracking.append(float(metrics["loss/tracking"]))
    launches = kernels.launch_counts()
    timed_steps = step_times[warmup:]
    sps = len(timed_steps) / sum(timed_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] losses {losses}; loss/tracking {tracking}", flush=True)
    print(f"[{tag}] {NUM_FRAMES} frames {IMAGE_SHAPE}, flow + tracking losses: {sps:.4f} "
          f"steps/s over {len(timed_steps)} steps (step times s: "
          f"{[round(t, 4) for t in step_times]}), peak memory {peak:.2f} GiB, "
          f"launches {launches}", flush=True)
    if not all(math.isfinite(x) for x in losses + tracking):
        fail(f"[{tag}] a loss is not finite")
    if not precomputed and not all(x > 0 for x in tracking):
        fail(f"[{tag}] the tracking loss is zero")
    if any(launches[k] > at_start[k] for k in launches if k.startswith(unused)):
        fail(f"[{tag}] {unused} was launched on this path")
    return {k: v for k, v in launches.items() if not k.startswith(unused)}


def run_overfit_path(batch, flows, tracks, options: dict, kernel: str, steps: int,
                     tag: str) -> dict:
    """The flagship scene through `run_overfit` with a weight path of this
    slice (`options` for `flagship.model_cfg`), flow and tracking losses,
    `steps` steps with a fetch after each. `kernel` (H "corr_weights" or I
    "weight_mlp") must be launched forward and backward on every step, and
    the warps that the path bypasses never. Returns the path's launches."""
    import torch

    from flowmap_tpu_torch.ops import kernels
    from flowmap_tpu_torch.training.flagship import loss_cfgs, model_cfg
    from flowmap_tpu_torch.training.overfit import OverfitTrainerCfg, run_overfit

    cfg = model_cfg(flows, **options).backbone
    print(f"[{tag}] {options}: warp radii full ({cfg.warp_radius}, {cfg.warp_radius_x}), "
          f"half ({cfg.warp_radius_half}, {cfg.warp_radius_half_x})", flush=True)
    unused = {"corr_weights": ("shift_warp", "warp_features", "weight_mlp"),
              "weight_mlp": ("corr_weights", "warp_features")}[kernel]
    seen, times, fetched = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    last = dict(kernels.launch_counts())

    def on_validation(state, step, metrics):
        nonlocal last
        times.append(time.perf_counter())
        now = kernels.launch_counts()
        idle = [k for k in now if now[k] <= last[k]
                and k.startswith(STEP_KERNELS + (kernel,)) and not k.startswith(unused)]
        if idle:
            fail(f"[{tag}] step {step}: kernels not launched: {idle}")
        last = dict(now)
        seen.append(step)
        fetched.append((metrics["loss/total"], metrics["loss/tracking"]))

    t0 = time.perf_counter()
    _, info = run_overfit(model_cfg(flows, **options), loss_cfgs(tracking_after=0),
                          OverfitTrainerCfg(max_steps=steps, val_check_interval=1),
                          batch, flows, tracks, on_validation=on_validation)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_times = [b - a for a, b in zip([t0] + times[:-1], times)]
    sps = (len(times) - 1) / (times[-1] - times[0])
    print(f"[{tag}] losses (total, tracking) {fetched}", flush=True)
    print(f"[{tag}] run_overfit: {steps} steps in {info['optimization_runtime']:.3f} s; "
          f"{sps:.4f} steps/s over the last {len(times) - 1} (step times s "
          f"{[round(t, 4) for t in step_times]}, the first with set-up), peak memory "
          f"{peak:.2f} GiB, launches {launches}", flush=True)
    if seen != list(range(1, steps + 1)):
        fail(f"[{tag}] on_validation saw steps {seen}")
    if not all(math.isfinite(x) for pair in fetched for x in pair) or not all(
            t > 0 for _, t in fetched):
        fail(f"[{tag}] a loss is not finite, or the tracking loss is zero")
    if any(launches[k] > 0 for k in launches if k.startswith(unused)):
        fail(f"[{tag}] a bypassed kernel was launched: {launches}")
    if not launches[f"{kernel}_fwd"] == launches[f"{kernel}_bwd"] == steps:
        fail(f"[{tag}] {kernel} launched {launches} times, not once a step each way")
    return {k: v for k, v in launches.items() if k.startswith(kernel)}


def run_precompute_path(frames: int) -> dict:
    """The third path: the product's precompute at full width (source video,
    crops, GMFlow both ways, consistency masks, flow-chained tracks), then the
    full step on what it made. Returns the launch counts of the whole path."""
    import torch

    from flowmap_tpu_torch.flow.predictors import FlowPredictorGMFlowCfg
    from flowmap_tpu_torch.ops import kernels
    from flowmap_tpu_torch.training import flagship

    tag = "precompute"
    flow_cfg = FlowPredictorGMFlowCfg()
    video = flagship.source_video("cuda", num_frames=frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batch, flows, tracks = flagship.precompute(video, flow=flow_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launch_counts()

    pairs = frames - 1
    chunks = 2 * -(-pairs // flow_cfg.max_batch_size)  # both directions
    h, w = flagship.IMAGE_SHAPE
    fields = {"forward": flows.forward, "backward": flows.backward,
              "forward_mask": flows.forward_mask, "backward_mask": flows.backward_mask}
    for name, t in fields.items():
        want = (1, pairs, h, w, 2) if "mask" not in name else (1, pairs, h, w)
        if tuple(t.shape) != want or not bool(torch.isfinite(t).all()):
            fail(f"[{tag}] flows.{name}: shape {tuple(t.shape)} (want {want}) or not finite")
    for name in ("forward_mask", "backward_mask"):
        if float(fields[name].min()) < 0.0 or float(fields[name].max()) > 1.0:
            fail(f"[{tag}] flows.{name} leaves [0, 1]")
    if tuple(batch.videos.shape) != (1, frames, 3, h, w):
        fail(f"[{tag}] model batch shape {tuple(batch.videos.shape)}")
    # Per chunk of pairs GMFlow runs 12 window attentions (d = 128), the
    # global correlation and the propagation (d = 2); the mask is one dense
    # warp per direction.
    want_counts = {"softmax_expectation_fwd_d128": 12 * chunks,
                   "softmax_expectation_fwd_d2": 2 * chunks, "dense_warp_fwd": 2}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts:
        fail(f"[{tag}] launches {got_counts}, expected {want_counts}")
    flow_px = flows.forward.abs().amax(dim=(0, 1, 2, 3)) * torch.tensor([w, h], device="cuda")
    print(f"[{tag}] {frames} frames {tuple(video.videos.shape[-2:])} -> flow batch "
          f"{flagship.SOURCE_SHAPE}, model batch {(h, w)}; GMFlow {flow_cfg.compute_dtype}, "
          f"{chunks} chunks of up to {flow_cfg.max_batch_size} pairs; launches {got_counts}; "
          f"largest forward flow {[round(float(v), 2) for v in flow_px]} px at {(h, w)}; mask mean "
          f"{float(flows.forward_mask.mean()):.4f}; tracks {tuple(tracks.xy.shape)}, "
          f"{float(tracks.visibility.float().mean()):.3f} visible", flush=True)
    print(f"[{tag}] wall time {wall:.3f} s", flush=True)
    print(f"[{tag}] {2 * pairs / wall:.3f} pairs/s ({2 * pairs} pairs, both directions)", flush=True)
    print(f"[{tag}] peak memory {peak:.2f} GiB", flush=True)
    del video
    return run_main_path(batch, flows, tracks, "fused", PRECOMPUTE_WARMUP_STEPS,
                         PRECOMPUTE_TIMED_STEPS, tag="precompute, then the step", precomputed=True)


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "flowmap_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the flowmap_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    from flowmap_tpu_torch.ops.kernels import build
    from flowmap_tpu_torch.training import flagship

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    batch, flows, depths = flagship.scene("cuda")
    tracks = flagship.tracks(batch, depths)
    cfg = flagship.model_cfg(flows)
    rows = check_flow_loss(batch, flows, depths)
    rows += check_shift_warp(flows, cfg)
    rows += check_head()
    rows += check_track_loss(batch, depths, tracks)
    rows += check_warp_features(flows, cfg)
    rows += check_correlation()
    rows += check_dense_warp()
    full_radius = flagship.model_cfg(flows, weights_resolution="full").backbone.warp_radius
    print(f"[H corr_weights] the flagship scene's full-resolution radius: {full_radius}",
          flush=True)
    if full_radius > 6:
        fail("the full-resolution radius exceeds 6: the corr-weights kernel would not run")
    rows += check_weight_mlp()
    rows += check_corr_weights(flows, full_radius)
    check_small_step()

    # Each path's launches are counted over its own steps: the counts are set
    # to 0 just before it and read just after.
    launches = run_main_path(batch, flows, tracks, "fused", WARMUP_STEPS, TIMED_STEPS)
    launches.update({
        k: v
        for k, v in run_main_path(
            batch, flows, tracks, "pallas", PALLAS_WARMUP_STEPS, PALLAS_TIMED_STEPS
        ).items()
        if k.startswith("warp_features")
    })
    launches.update(run_overfit_path(batch, flows, tracks, dict(weights_resolution="full"),
                                     "corr_weights", OVERFIT_STEPS, "fourth path, full weights"))
    launches.update(run_overfit_path(batch, flows, tracks, dict(fused_weight_mlp=True),
                                     "weight_mlp", OVERFIT_STEPS, "fifth path, fused weight MLP"))
    del batch, flows, depths, tracks
    torch.cuda.empty_cache()
    launches.update({
        k: v for k, v in run_precompute_path(flagship.NUM_FRAMES).items()
        if k.startswith(("softmax_expectation", "dense_warp"))
    })
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on the main path")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
