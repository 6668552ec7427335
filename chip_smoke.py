#!/usr/bin/env python
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of `flowmap_tpu`, and in order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from `flowmap_tpu_torch/ops/kernels/csrc/` (one
   nvcc per source, in parallel) and prints the build time;
3. for each kernel of the overfit step -- the flow loss (A), the shift warp
   (B), the MiDaS head interior (C) -- calls the wrapper at the shapes the
   main path gives it and holds forward and backward against the plain
   PyTorch version: in float32 with TF32 off (tight) and, for B and C, in
   bfloat16 (looser; C's bf16 kernels are also held tightly against a plain
   f32 emulation of their own roundings); any mismatch raises. Prints each
   error and time, and A's C entry points timed alone;
4. checks the whole train step on a small scene: one step through the
   kernels on the card against the same step on the CPU through the plain
   versions;
5. drives the main path: a 150-frame 160x224 synthetic scene, the
   autosized warp radii (the shift branch must be taken), `init_train_state`
   for MiDaS-small (folded BN, bf16, random weights from a seed), softmin
   intrinsics and Procrustes extrinsics, flow loss, 2 warm-up and 5 timed
   Adam steps. Every kernel's launch counter must rise on every step; the
   loss must be finite. Prints steps/s and peak memory;
6. prints one JSON line with every kernel's launches, error and times, and
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


def check_small_step() -> None:
    """Two f32 train steps on a small scene: kernels on the card vs the plain
    versions on the CPU. Compares both losses and every gradient leaf of the
    first step (per leaf, relative to max(|leaf|, 1e-3 * the largest leaf))."""
    import torch

    from flowmap_tpu_torch.loss.loss import LossFlowCfg
    from flowmap_tpu_torch.training import flagship
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    results = {}
    for device in ("cpu", "cuda"):
        batch, flows, _ = flagship.scene(device, num_frames=8, image_shape=(64, 96))
        cfg = flagship.model_cfg(flows, compute_dtype="float32")
        state = init_train_state(cfg, OverfitTrainerCfg(), 8, (64, 96), device=device)
        step = make_train_step(cfg, [LossFlowCfg()])
        indices = torch.arange(0, 64 * 96, 3, device=device)
        losses = [float(step(state, batch, flows, intrinsics_indices=indices)["loss/total"])]
        grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
        losses.append(float(step(state, batch, flows, intrinsics_indices=indices)["loss/total"]))
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


def run_main_path(batch, flows) -> dict:
    import torch

    from flowmap_tpu_torch.loss.loss import LossFlowCfg
    from flowmap_tpu_torch.ops import kernels
    from flowmap_tpu_torch.training.flagship import IMAGE_SHAPE, NUM_FRAMES, model_cfg
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    cfg = model_cfg(flows)
    bb = cfg.backbone
    ry, rx = bb.warp_radius_half, bb.warp_radius_half_x
    taps = (2 * ry + 2) * (2 * rx + 2)
    print(f"[main] warp radii: full ({bb.warp_radius}, {bb.warp_radius_x}), "
          f"half ({ry}, {rx}), tap window {taps}", flush=True)
    if taps > 256:
        fail("the shift-warp branch is not taken at the main path's radii")

    state = init_train_state(cfg, OverfitTrainerCfg(lr=3e-5), NUM_FRAMES, IMAGE_SHAPE)
    step = make_train_step(cfg, [LossFlowCfg()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    losses = []
    step_times = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, batch, flows)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        after = kernels.launch_counts()
        idle = [k for k in after if after[k] <= before[k]]
        if idle:
            fail(f"step {i}: kernels not launched: {idle}")
        losses.append(float(metrics["loss/total"]))
    launches = kernels.launch_counts()
    timed = step_times[WARMUP_STEPS:]
    sps = len(timed) / sum(timed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] losses {losses}", flush=True)
    print(f"[main] {NUM_FRAMES} frames {IMAGE_SHAPE}: {sps:.4f} steps/s over "
          f"{len(timed)} steps (step times s: {[round(t, 4) for t in step_times]}), "
          f"peak memory {peak:.2f} GiB, launches {launches}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("main-path loss not finite")
    return launches


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
    cfg = flagship.model_cfg(flows)
    rows = check_flow_loss(batch, flows, depths)
    rows += check_shift_warp(flows, cfg)
    rows += check_head()
    check_small_step()

    launches = run_main_path(batch, flows)
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
