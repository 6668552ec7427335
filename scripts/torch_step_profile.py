#!/usr/bin/env python
"""Where the time of the port's overfit step goes, on one NVIDIA GPU.

Runs the port's flagship configuration (`flowmap_tpu_torch/training/
flagship.py`: 150 frames at 160x224, MiDaS-small bf16 with folded BN,
softmin intrinsics, Procrustes extrinsics, flow loss),
then traces a few steps with `torch.profiler` and prints:

- the card's name and power limit, steps/s of the traced window;
- device time by kernel (top N by total CUDA time, summed over the steps);
- device time by category (convolutions, this repo's kernels, elementwise,
  reductions, GEMMs, copies, optimizer) and the device's idle share of the
  wall time.

Usage (from the root of a checkout, on a machine with the card):

    python3 scripts/torch_step_profile.py [--steps 3] [--top 30] [--trace PATH]

`--trace` also writes the Chrome trace of the traced steps to PATH.
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
                      "conv3x3_mma_kernel", "head_tail_", "wgrad_kernel", "wgrad_mma_kernel")),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "sm90_", "dgrad",
                             "wgrad", "cutlass")),
    ("GEMM", ("gemm", "Gemm", "matmul")),
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
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--trace", type=Path, default=None)
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

    from flowmap_tpu_torch.loss.loss import LossFlowCfg
    from flowmap_tpu_torch.ops.kernels import build
    from flowmap_tpu_torch.training import flagship
    from flowmap_tpu_torch.training.overfit import (
        OverfitTrainerCfg,
        init_train_state,
        make_train_step,
    )

    build.build_all()
    batch, flows, _ = flagship.scene("cuda")
    cfg = flagship.model_cfg(flows)
    state = init_train_state(cfg, OverfitTrainerCfg(), flagship.NUM_FRAMES, flagship.IMAGE_SHAPE)
    step = make_train_step(cfg, [LossFlowCfg()])
    for _ in range(3):
        step(state, batch, flows)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, flows)
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
