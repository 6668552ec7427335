"""Fused correspondence-weight MLP: the CUDA kernel (I) and its plain version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/weight_mlp.py:234`
(`weight_mlp`; its pallas_calls at `:158` forward, `:182` backward). Source:
`csrc/weight_mlp.cu` with the MLP itself in `csrc/mlp_core.cuh`, which the
full-resolution kernel H (`corr_weights.py`) shares.

`weight_mlp(wa, la, w0, b0, w1, b1, w2, b2)` gives the logits (p,) f32 of
the per-pixel MLP on [wa | la] (64 + 64 -> 128 -> 64 -> 1). The parameters
come in `nn.Linear`'s layout, (out, in): `w0[:, :64]` pairs with `wa`, as
`kernel[:64]` does in JAX. Weights and features are in the compute type
(float32 or bfloat16), biases in float32. Rounding points are the TPU
kernel's: z0 is accumulated in f32 with an f32 bias, x0 is rounded to the
compute type, x1 and the last layer stay f32; the backward rounds dz1 and dz0
to the compute type before their products and sums the bias gradients
unrounded. The plain version is a `torch.autograd.Function` with that
forward and backward written out in PyTorch; off the TPU the JAX package
runs its XLA formulation (`_reference`), which is the same in f32.

Design: the TPU kernel keeps every 128- and 64-wide intermediate in VMEM
and runs its products transposed for the lane layout. Here a block stages
the parameters in shared memory once and walks over tiles of 64 pixels
(32 in f32), all products on `mma.sync` (bf16, or three-pass TF32 for f32).
Parameter gradients are per-block partials summed in a fixed order (no
atomics). Bound: bytes (`chip_smoke.py` computes it).

Dispatch is by device only: CPU tensors take the plain version, CUDA
tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"fwd": 0, "bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "weight_mlp_fwd": [_P] * 9 + [_I, _I, _I, _P],
    "weight_mlp_bwd": [_P] * 11 + [_I, _I, _I, _P],
    "weight_mlp_reduce": [_P, _P, _I, _P],
    "weight_mlp_tile": [_I],
    "weight_mlp_partial_len": [],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
C, D0, D1 = 64, 128, 64


def _lib():
    return build.load("weight_mlp", _SIGNATURES)


# ---------------------------------------------------------------------------
# Plain version (CPU, and the card's reference in chip_smoke.py).
# ---------------------------------------------------------------------------


def mlp_forward_plain(x, w0, b0, w1, b1, w2, b2):
    """(logits (p,), x0, x1) of the MLP on x = [a | l] (p, 128)."""
    z0 = x.float() @ w0.float().t() + b0
    x0 = torch.relu(z0).to(x.dtype)
    x1 = torch.relu(x0.float() @ w1.float().t() + b1)
    y = x1 @ w2.float().t() + b2
    return y[:, 0], x0, x1


def mlp_backward_plain(x, w0, w1, w2, x0, x1, dy):
    """(d_x, dw0, db0, dw1, db1, dw2, db2) with the kernel's rounding points."""
    dtype = x.dtype
    dz1 = (dy[:, None] * w2.float()) * (x1 > 0)
    dz1c = dz1.to(dtype).float()
    dz0 = (dz1c @ w1.float()) * (x0 > 0)
    dz0c = dz0.to(dtype).float()
    d_x = (dz0c @ w0.float()).to(dtype)
    dw0 = (dz0c.t() @ x.float()).to(dtype)
    dw1 = (dz1c.t() @ x0.float()).to(dtype)
    dw2 = (dy @ x1)[None].to(dtype)
    return d_x, dw0, dz0.sum(0), dw1, dz1.sum(0), dw2, dy.sum()[None]


class _WeightMlpPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wa, la, w0, b0, w1, b1, w2, b2):
        x = torch.cat([wa, la], dim=1)
        y, x0, x1 = mlp_forward_plain(x, w0, b0, w1, b1, w2, b2)
        ctx.save_for_backward(x, w0, w1, w2, x0, x1)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w0, w1, w2, x0, x1 = ctx.saved_tensors
        d_x, dw0, db0, dw1, db1, dw2, db2 = mlp_backward_plain(
            x, w0, w1, w2, x0, x1, dy.float()
        )
        return d_x[:, :C], d_x[:, C:], dw0, db0, dw1, db1, dw2, db2


def weight_mlp_plain(wa, la, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    return _WeightMlpPlain.apply(wa, la, w0, b0, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------


def _blocks(device, tiles: int, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, per_sm * sms))


def reduce_grads(lib_fn, partial, nblocks, dtype, device, stream):
    """Sum the block partials in order and split them into (dw0, db0, dw1,
    db1, dw2, db2): weights in `dtype`, biases f32."""
    out = torch.empty(D0 * 2 * C + D1 * D0 + D0 + 2 * D1 + 1, device=device, dtype=torch.float32)
    build.check(lib_fn(build.ptr(partial), build.ptr(out), nblocks, stream), "mlp reduce")
    sizes = [D0 * 2 * C, D1 * D0, D0, D1, D1, 1]
    dw0, dw1, db0, db1, dw2, db2 = torch.split(out, sizes)
    return (dw0.view(D0, 2 * C).to(dtype), db0, dw1.view(D1, D0).to(dtype), db1,
            dw2.view(1, D1).to(dtype), db2)


class _WeightMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wa, la, w0, b0, w1, b1, w2, b2):
        lib = _lib()
        p = wa.shape[0]
        code = _DTYPES[wa.dtype]
        out = torch.empty(p, device=wa.device, dtype=torch.float32)
        tiles = -(-p // lib.weight_mlp_tile(code))
        status = lib.weight_mlp_fwd(
            *(build.ptr(t) for t in (wa, la, w0, b0, w1, b1, w2, b2, out)),
            p, _blocks(wa.device, tiles, 2), code, build.stream_ptr(wa.device),
        )
        build.check(status, "weight_mlp_fwd")
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(wa, la, w0, b0, w1, b1, w2)
        return out

    @staticmethod
    def backward(ctx, dy):
        wa, la, w0, b0, w1, b1, w2 = ctx.saved_tensors
        lib = _lib()
        p = wa.shape[0]
        code = _DTYPES[wa.dtype]
        dy = dy.float().contiguous()
        dwa, dla = torch.empty_like(wa), torch.empty_like(la)
        nblocks = _blocks(wa.device, -(-p // lib.weight_mlp_tile(code)), 1)
        partial = torch.empty((nblocks, lib.weight_mlp_partial_len()), device=wa.device,
                              dtype=torch.float32)
        stream = build.stream_ptr(wa.device)
        status = lib.weight_mlp_bwd(
            *(build.ptr(t) for t in (wa, la, w0, b0, w1, b1, w2, dy, dwa, dla, partial)),
            p, nblocks, code, stream,
        )
        build.check(status, "weight_mlp_bwd")
        LAUNCHES["bwd"] += 1
        grads = reduce_grads(lib.weight_mlp_reduce, partial, nblocks, wa.dtype, wa.device, stream)
        return (dwa, dla) + grads


def check_params(what: str, dtype, w0, b0, w1, b1, w2, b2) -> None:
    """Shapes and types the MLP kernels take."""
    shapes = {"w0": (w0, (D0, 2 * C), dtype), "w1": (w1, (D1, D0), dtype),
              "w2": (w2, (1, D1), dtype), "b0": (b0, (D0,), torch.float32),
              "b1": (b1, (D1,), torch.float32), "b2": (b2, (1,), torch.float32)}
    for name, (t, shape, want) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want} {shape}, got {t.dtype} {tuple(t.shape)}")


def weight_mlp(
    wa: torch.Tensor,  # (p, 64) float32 or bfloat16
    la: torch.Tensor,  # (p, 64)
    w0: torch.Tensor,  # (128, 128) in wa's type; w0[:, :64] pairs with wa
    b0: torch.Tensor,  # (128,) float32
    w1: torch.Tensor,  # (64, 128)
    b1: torch.Tensor,  # (64,) float32
    w2: torch.Tensor,  # (1, 64)
    b2: torch.Tensor,  # (1,) float32
) -> torch.Tensor:  # (p,) float32 logits
    """Per-pixel MLP logits on [wa | la]; differentiable in every input."""
    if not wa.is_cuda:
        return weight_mlp_plain(wa, la, w0, b0, w1, b1, w2, b2)
    if wa.dtype not in _DTYPES or la.dtype != wa.dtype:
        raise ValueError(f"weight_mlp kernel: unsupported dtypes {wa.dtype}, {la.dtype}")
    if wa.dim() != 2 or wa.shape[1] != C or la.shape != wa.shape:
        raise ValueError("weight_mlp kernel: wa and la must both be (p, 64)")
    check_params("weight_mlp kernel", wa.dtype, w0, b0, w1, b1, w2, b2)
    args = [t.contiguous() for t in (wa, la, w0, b0, w1, b1, w2, b2)]
    build.require_cuda_tensors("weight_mlp", **dict(zip(
        ("wa", "la", "w0", "b0", "w1", "b1", "w2", "b2"), args)))
    return _WeightMlpFn.apply(*args)
