"""Carry the JAX package's parameter tree into the port's modules.

`from_jax_params(tree)` takes `TrainState.params` of `flowmap_tpu` as nested
dicts/lists of NumPy arrays and returns a state dict for `FlowMapModel`.
Module names mirror the JAX keys, so the mapping is mechanical:

- a path joins with "." (`backbone.midas.encoder.blocks.3.dw_conv`);
- `kernel` and BN `scale` become `weight`;
- conv kernels go HWIO -> OIHW (depthwise (k, k, 1, c) -> (c, 1, k, k));
- dense kernels (in, out) -> (out, in), as `nn.Linear` stores them;
- biases (folded BN biases included), BN scale/bias and `focal_length`
  keep their layout.

`from_jax_params` applies to any tree shaped like the parameters, such as
their gradients.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def torch_name(path: tuple) -> str:
    """Parameter name in `FlowMapModel` for a JAX parameter path."""
    keys = [str(k) for k in path]
    if keys[-1] in ("kernel", "scale"):
        keys[-1] = "weight"
    return ".".join(keys)


def jax_leaf_to_torch(path: tuple, value) -> torch.Tensor:
    """One JAX leaf in the port's layout (float32 CPU tensor)."""
    arr = np.asarray(value, dtype=np.float32)
    if path[-1] == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # (in, out) -> (out, in)
            arr = arr.T
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """State dict for `FlowMapModel.load_state_dict` from a JAX param tree."""
    return {torch_name(path): jax_leaf_to_torch(path, leaf) for path, leaf in _flatten(tree)}

