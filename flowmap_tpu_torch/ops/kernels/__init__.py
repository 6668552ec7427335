"""Hand-written Hopper kernels (CUDA C++ in `csrc/`), one module per kernel.

Each module holds the kernel's wrapper (a `torch.autograd.Function` where
the kernel has a backward), its plain PyTorch version, and a `LAUNCHES` dict
counting kernel launches per direction. A wrapper dispatches by device only: CPU tensors take the plain
version, CUDA tensors take the kernel or raise.
"""

from . import (
    corr_weights,
    correlation,
    dense_warp,
    flow_loss,
    head_kernel,
    shift_warp,
    track_loss,
    warp_features,
    weight_mlp,
)

KERNEL_MODULES = {
    "flow_loss": flow_loss,
    "shift_warp": shift_warp,
    "head_interior": head_kernel,
    "track": track_loss,
    "warp_features": warp_features,
    "softmax_expectation": correlation,
    "dense_warp": dense_warp,
    "weight_mlp": weight_mlp,
    "corr_weights": corr_weights,
}


def launch_counts() -> dict[str, int]:
    return {
        f"{name}_{direction}": count
        for name, module in KERNEL_MODULES.items()
        for direction, count in module.LAUNCHES.items()
    }


def reset_launch_counts() -> None:
    for module in KERNEL_MODULES.values():
        for direction in module.LAUNCHES:
            module.LAUNCHES[direction] = 0
