#!/usr/bin/env python
"""Where the time of the port's overfit step, or of one GMFlow chunk of its
flow precompute, goes on one NVIDIA GPU.

Runs the port's flagship configuration (`flowmap_tpu_torch/training/
flagship.py`: 150 frames at 160x224, MiDaS-small bf16 with folded BN,
softmin intrinsics, Procrustes extrinsics, flow and tracking losses with the
tracking loss enabled from step 0), then traces a few steps with
`torch.profiler`. With `--gmflow` it traces the flow predictor instead: one
chunk of 8 frame pairs at 640x896 per step (GMFlow, float32, random weights
from a seed), as the precompute runs 38 of for a 150-frame scene. Prints:

- the card's name and power limit, steps/s of the traced window;
- device time by kernel (top N by total CUDA time, summed over the steps);
- device time by category (convolutions, this repo's kernels, elementwise,
  reductions, GEMMs, copies, optimizer) and the device's idle share of the
  wall time.

Usage (from the root of a checkout, on a machine with the card):

    python3 scripts/torch_step_profile.py [--gmflow] [--steps 3] [--top 30] [--trace PATH]
        [--weights-resolution native|full] [--fused-weight-mlp]

`--trace` also writes the Chrome trace of the traced steps to PATH.
`--weights-resolution full` traces the step on the full-resolution weight
path (the corr-weights kernel) and `--fused-weight-mlp` the native path with
the fused weight-MLP kernel, the variants of `chip_smoke.py`'s fourth and
fifth paths.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CATEGORIES = [
    ("repo kernels", ("flow_loss_kernel", "shift_warp_", "conv3x3_kernel",
                      "conv3x3_mma_kernel", "head_tail_", "wgrad_kernel", "wgrad_mma_kernel",
                      "track_sample_", "track_pair_kernel", "warp_features_",
                      "softmax_expectation_kernel", "dense_warp_kernel", "weight_mlp_",
                      "corr_weights_", "reduce_partials")),
    # A name that says convolution first; then a GEMM (cuBLAS's carry "xmma"
    # or "cutlass" too); what is left of those families is cuDNN's.
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad",
                             "_fft", "pointwise_mult_and_sum_complex")),
    ("GEMM", ("gemm", "Gemm", "matmul")),
    ("convolution (cuDNN)", ("xmma", "sm90_", "cutlass")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / layout", ("copy", "Copy", "memcpy", "Memcpy", "memset", "Memset",
                       "transpose", "cat", "Cat")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
]


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gmflow", action="store_true",
                        help="trace one GMFlow chunk (8 pairs at 640x896) per step")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--trace", type=Path, default=None)
    parser.add_argument("--weights-resolution", choices=("native", "full"), default="native")
    parser.add_argument("--fused-weight-mlp", action="store_true")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    from flowmap_tpu_torch.ops.kernels import build
    from flowmap_tpu_torch.training import flagship
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    build.build_all()
    if args.gmflow:
        from flowmap_tpu_torch.flow.gmflow import GMFlowPredictor
        from flowmap_tpu_torch.flow.predictors import FlowPredictorGMFlowCfg

        torch.backends.cudnn.allow_tf32 = False  # float32 as the precompute's checks run it
        cfg = FlowPredictorGMFlowCfg()
        predictor = GMFlowPredictor(cfg, "cuda")
        video = flagship.source_video("cuda", num_frames=cfg.max_batch_size + 1).videos

        def run():
            predictor(video)
    else:
        batch, flows, depths = flagship.scene("cuda")
        tracks = flagship.tracks(batch, depths)
        cfg = flagship.model_cfg(flows, weights_resolution=args.weights_resolution,
                                 fused_weight_mlp=args.fused_weight_mlp)
        state = init_train_state(cfg, OverfitTrainerCfg(), flagship.NUM_FRAMES, flagship.IMAGE_SHAPE)
        step = make_train_step(cfg, flagship.loss_cfgs(tracking_after=0))

        def run():
            step(state, batch, flows, tracks)

    for _ in range(3):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"traced {args.steps} steps: {args.steps / wall:.4f} steps/s, "
          f"wall {wall * 1e3:.1f} ms")

    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += ev.device_time_total
            by_kernel[ev.name][1] += 1
            intervals.append((ev.time_range.start, ev.time_range.end))
    device_us = sum(v[0] for v in by_kernel.values())
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    print(f"device kernel time {device_us / 1e3:.1f} ms over {args.steps} steps; "
          f"device busy {busy / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"(idle share {1 - busy / 1e3 / (wall * 1e3):.3f})")

    cats = defaultdict(float)
    for name, (us, _) in by_kernel.items():
        cats[category(name)] += us
    print("by category (ms per step):")
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:24s} {us / 1e3 / args.steps:9.3f}  ({us / device_us:.1%})")
    print(f"top {args.top} kernels (ms per step, launches per step):")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {us / 1e3 / args.steps:9.3f} {n / args.steps:7.1f}  {name[:110]}")

    if args.trace is not None:
        prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
