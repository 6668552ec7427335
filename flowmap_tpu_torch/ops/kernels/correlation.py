"""Fused softmax expectation: the CUDA kernel (F) and its plain version.

Replaces the Pallas TPU kernels of `flowmap_tpu/ops/pallas/correlation.py`
(`softmax_expectation` at `:151`, `global_correlation_expectation` at `:194`;
pallas_calls at `:116` and `:134`). Source: `csrc/correlation.cu`.

`softmax_expectation(f0 (b, l, c), f1 (b, l, c), values (b, l, d), bias)` is
`softmax(f0 f1^T / sqrt(c) [+ bias]) @ values` in float32, with the (l, l)
scores never written to device memory. It serves GMFlow's swin window
attention (bias = the shifted-window mask), its global correlation (values =
the pixel grid, so the result is the expected correspondence) and its flow
propagation (values = the flow).

The bias is additive, (g, l, l) with g dividing b, and batch element i reads
group i % g: the window mask is the same for every image, so it is passed
once (g = windows per image) instead of tiled to the batch; a per-batch bias
is g = b. f0 and f1 are float32 or bfloat16 and enter the products exactly;
values and bias are taken in float32; the result is float32.

Design: the TPU kernel holds the whole key set in fast memory; an SM cannot,
so the CUDA kernel walks the keys in tiles with an online softmax (see the
source). It is compiled for the (c, d) pairs in `SUPPORTED`; any length l
works without padded copies. Bound: operations (`chip_smoke.py` computes it).

Forward only, as on the TPU (the flow net is frozen): under autograd an input
that requires a gradient raises. Dispatch is by device only: CPU tensors take
the plain version, CUDA tensors take the kernel or raise (an unsupported
(c, d) included).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

# (c, d) pairs compiled into the kernel: GMFlow's attention (128, 128), its
# correlation and propagation (128, 2), and two small pairs for the checks.
SUPPORTED = ((128, 128), (128, 2), (16, 8), (16, 2))

# Launches by value width d, so that a run can tell the attention calls
# (d = 128) from the correlation and propagation calls (d = 2).
LAUNCHES = {f"fwd_d{d}": 0 for d in sorted({d for _, d in SUPPORTED})}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"softmax_expectation_fwd": [_P] * 5 + [_I] * 6 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Above this length the plain version walks the queries in chunks, so that it
# never holds a whole (l, l) volume.
_PLAIN_CHUNK_ABOVE = 4096
_PLAIN_CHUNK = 2048


def _lib():
    return build.load("correlation", _SIGNATURES)


def _check_bias(bias: Optional[torch.Tensor], batch: int, length: int) -> None:
    if bias is None:
        return
    if bias.dim() != 3 or bias.shape[1:] != (length, length) or batch % bias.shape[0] != 0:
        raise ValueError(
            f"softmax_expectation: bias must be (g, {length}, {length}) with g dividing "
            f"{batch}, got {tuple(bias.shape)}"
        )


def softmax_expectation_plain(
    f0: torch.Tensor,  # (b, l, c)
    f1: torch.Tensor,  # (b, l, c)
    values: torch.Tensor,  # (b, l, d)
    bias: Optional[torch.Tensor] = None,  # (g, l, l), batch element i reads group i % g
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # (b, l, d) of `dtype`
    """einsum, bias, softmax, einsum in float32; for l above 4096 in chunks
    of 2048 queries. `dtype=torch.float64` gives the checks a reference."""
    b, length, c = f0.shape
    _check_bias(bias, b, length)
    f0, f1, values = f0.to(dtype), f1.to(dtype), values.to(dtype)
    step = _PLAIN_CHUNK if length > _PLAIN_CHUNK_ABOVE else length
    chunks = []
    for start in range(0, length, step):
        corr = torch.einsum("blc,bmc->blm", f0[:, start : start + step], f1) / (c**0.5)
        if bias is not None:
            g = bias.shape[0]
            part = bias[:, start : start + step].to(dtype)
            corr = (corr.reshape(b // g, g, -1, length) + part).reshape(b, -1, length)
        chunks.append(torch.einsum("blm,bmd->bld", torch.softmax(corr, dim=-1), values))
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)


def softmax_expectation(
    f0: torch.Tensor,  # (b, l, c) float32 or bfloat16
    f1: torch.Tensor,  # (b, l, c)
    values: torch.Tensor,  # (b, l, d)
    bias: Optional[torch.Tensor] = None,  # (g, l, l), batch element i reads group i % g
) -> torch.Tensor:  # (b, l, d) float32
    """softmax(f0 f1^T / sqrt(c) [+ bias]) @ values without the (l, l)
    probabilities in device memory; no gradient."""
    if not f0.is_cuda:
        return softmax_expectation_plain(f0, f1, values, bias)
    tensors = [f0, f1, values] + ([] if bias is None else [bias])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "softmax_expectation is forward-only (the flow net is frozen): "
            "call it under torch.no_grad() or on detached tensors"
        )
    if f0.dim() != 3 or f0.shape != f1.shape or values.shape[:2] != f0.shape[:2]:
        raise ValueError("softmax_expectation: f0, f1 must be (b, l, c) and values (b, l, d)")
    b, length, c = f0.shape
    d = values.shape[-1]
    _check_bias(bias, b, length)
    if f0.dtype not in _DTYPES or f1.dtype != f0.dtype:
        raise ValueError(f"softmax_expectation kernel: unsupported dtypes {f0.dtype}, {f1.dtype}")
    if (c, d) not in SUPPORTED:
        raise ValueError(
            f"softmax_expectation kernel: (c, d) = ({c}, {d}) is not compiled in; "
            f"supported pairs: {SUPPORTED}"
        )
    f0, f1 = f0.detach().contiguous(), f1.detach().contiguous()
    values = values.detach().float().contiguous()
    tensors = dict(f0=f0, f1=f1, values=values)
    if bias is not None:
        tensors["bias"] = bias = bias.detach().float().contiguous()
    build.require_cuda_tensors("softmax_expectation", **tensors)
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError("softmax_expectation kernel: inputs must be 16-byte aligned")
    out = torch.empty((b, length, d), device=f0.device, dtype=torch.float32)
    status = _lib().softmax_expectation_fwd(
        build.ptr(f0), build.ptr(f1), build.ptr(values),
        build.ptr(bias) if bias is not None else None, build.ptr(out),
        b, length, c, d, 1 if bias is None else bias.shape[0], _DTYPES[f0.dtype],
        build.stream_ptr(f0.device),
    )
    build.check(status, "softmax_expectation_fwd")
    LAUNCHES[f"fwd_d{d}"] += 1
    return out


def global_correlation_expectation(
    f0: torch.Tensor,  # (b, l, c)
    f1: torch.Tensor,  # (b, l, c)
    grid: torch.Tensor,  # (l, 2)
) -> torch.Tensor:  # (b, l, 2) float32
    """softmax(f0 f1^T / sqrt(c)) @ grid: the expected correspondence."""
    return softmax_expectation(f0, f1, grid[None].expand(f0.shape[0], *grid.shape))
