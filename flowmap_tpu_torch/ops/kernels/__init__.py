"""Hand-written Hopper kernels (CUDA C++ in `csrc/`), one module per kernel.

Each module holds the kernel's `torch.autograd.Function` wrapper, its plain
PyTorch version, and a `LAUNCHES` dict counting kernel launches per
direction. A wrapper dispatches by device only: CPU tensors take the plain
version, CUDA tensors take the kernel or raise.
"""

from . import flow_loss, head_kernel, shift_warp

KERNEL_MODULES = {
    "flow_loss": flow_loss,
    "shift_warp": shift_warp,
    "head_interior": head_kernel,
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
