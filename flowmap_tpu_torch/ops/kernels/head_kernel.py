"""MiDaS head interior: the CUDA kernel (C) and its plain PyTorch version.

Replaces the Pallas TPU kernel `flowmap_tpu/ops/pallas/head_kernel.py:333`
(`head_interior`; its pallas_calls at `:245` forward, `:278` and `:295`
backward). Source: `csrc/head_kernel.cu`.

    z  = conv1(x) + b1              3x3, 64 -> 32, zero padding
    ph = conv_kp(z)                 3x3, 32 -> 4*32 parity kernel, zero padding
    y4[:, j] = relu(ph[:, 32j:32j+32] + b2) . w3 + b3

Border rows/columns of y4 are not valid; the caller splices exact strips
over them (`model/backbone/midas_net.py:head_forward`).

Design: the forward is two launches -- conv1 writes z (kept for the
backward, as the TPU kernel keeps it), then a fused tail computes the
phases, relu and projection per tile with z's halo in shared memory, so the
128-channel phase tensor never reaches device memory. The backward
recomputes the phases, writes d_phases, and runs two transposed 3x3
convolutions (the forward's conv kernel with flipped weights) and two
weight-gradient GEMMs whose per-block partials PyTorch sums: deterministic,
no atomics. f32 accumulation throughout. The input's dtype picks the
arithmetic: bf16 (the main path) runs every product on the tensor cores
(`mma.sync`, z, d_phases and dz kept in bf16 as the TPU kernel keeps them
in its compute dtype); f32 runs on the CUDA cores in full f32, for the
`compute_dtype="float32"` configuration. `head_interior_mma_emulated`
repeats the bf16 path's roundings in plain f32, to hold it to. Bound:
operations (~149 GFLOP forward, ~297 GFLOP backward at the main path's
shape; `chip_smoke.py` computes it).

Dispatch is by device only: CPU tensors take `head_interior_plain`, CUDA
tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

LAUNCHES = {"fwd": 0, "bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "head_conv3x3": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "head_tail_fwd": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "head_tail_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "head_wgrad": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "head_num_tiles": [_I, _I, _I],
    "head_conv3x3_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "head_tail_mma_num_tiles": [_I, _I, _I],
    "head_tail_mma_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "head_tail_mma_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "head_wgrad_mma": [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGRAD_CHUNKS = 96
_MMA_WGRAD_CHUNKS = 192  # x 3 row offsets = 576 blocks


def _lib():
    return build.load("head_kernel", _SIGNATURES)


def head_interior_plain(x, k1, b1, kp, b2, w3, b3):
    """Plain version: conv2d of the zero-padded features, conv2d with the
    parity kernel on zero-padded z, relu and the per-phase projection.

    x (n, 64, h, w); k1 (32, 64, 3, 3); b1 (32,); kp (128, 32, 3, 3);
    b2 (32,); w3 (32,); b3 (). Returns y4 (n, 4, h, w) float32."""
    n, _, h, w = x.shape
    z = F.conv2d(x, k1.to(x.dtype), b1.to(x.dtype), padding=1)
    ph = F.conv2d(z, kp.to(z.dtype), padding=1).float()
    t = torch.relu(ph.reshape(n, 4, 32, h, w) + b2.float()[None, None, :, None, None])
    return torch.einsum("njchw,c->njhw", t, w3.float()) + b3.float()


def _conv(x, w_tap, bias, out_dtype, cout):
    """Launch the 3x3 SAME conv kernel: w_tap is f32 [3][3][cin][cout]."""
    n, cin, h, w = x.shape
    out = torch.empty((n, cout, h, w), device=x.device, dtype=out_dtype)
    status = _lib().head_conv3x3(
        build.ptr(x), _CODES[x.dtype], build.ptr(w_tap),
        build.ptr(bias) if bias is not None else None,
        build.ptr(out), _CODES[out_dtype], n, cin, cout, h, w,
        build.stream_ptr(x.device),
    )
    build.check(status, "head_conv3x3")
    return out


def _tap_layout(weight_oihw):
    """OIHW -> f32 [3][3][cin][cout] (cout fastest)."""
    return weight_oihw.float().permute(2, 3, 1, 0).contiguous()


def _flipped_transpose_layout(weight_oihw):
    """Weights of the transposed conv as a forward conv: W'[a][b][o][i] =
    W[o, i, 2 - a, 2 - b], f32 [3][3][cout][cin]."""
    return weight_oihw.float().flip(2, 3).permute(2, 3, 0, 1).contiguous()


def _chunking(total: int, target: int, multiple: int) -> tuple[int, int]:
    """Split the weight-gradient GEMMs' K dimension of `total` units (pixels
    or row segments) into about `target` chunks of a multiple of `multiple`
    units: (chunks, units per chunk)."""
    per = -(-total // target)
    per = -(-per // multiple) * multiple
    return -(-total // per), per


def _wgrad(kind, a, b, ca, cb):
    """Sum over pixels of A x shift(B) per tap: (ca, cb, 3, 3) and (ca,)."""
    n, _, h, w = a.shape
    chunks, chunk = _chunking(n * h * w, _WGRAD_CHUNKS, 32)
    pw = torch.empty((chunks, 9, ca, cb), device=a.device, dtype=torch.float32)
    pb = torch.empty((chunks, ca), device=a.device, dtype=torch.float32)
    status = _lib().head_wgrad(
        kind, build.ptr(a), build.ptr(b), _CODES[b.dtype], n, h, w, chunks, chunk,
        build.ptr(pw), build.ptr(pb), build.stream_ptr(a.device),
    )
    build.check(status, "head_wgrad")
    dw = pw.sum(dim=0).reshape(3, 3, ca, cb).permute(2, 3, 0, 1)
    return dw, pb.sum(dim=0)


def _conv_mma(x, w_tap_bf16, bias, cout):
    """bf16 tensor-core 3x3 SAME conv: w_tap_bf16 is [3][3][cout][cin]."""
    n, cin, h, w = x.shape
    out = torch.empty((n, cout, h, w), device=x.device, dtype=torch.bfloat16)
    status = _lib().head_conv3x3_mma(
        build.ptr(x), build.ptr(w_tap_bf16),
        build.ptr(bias) if bias is not None else None, build.ptr(out),
        n, cin, cout, h, w, build.stream_ptr(x.device),
    )
    build.check(status, "head_conv3x3_mma")
    return out


def _wgrad_mma(kind, a, b, ca, cb):
    """Tensor-core weight gradients; K runs over 16-pixel row segments."""
    n, _, h, w = a.shape
    chunks, segs = _chunking(n * h * -(-w // 16), _MMA_WGRAD_CHUNKS, 2)
    pw = torch.empty((chunks, 9, ca, cb), device=a.device, dtype=torch.float32)
    pb = torch.empty((chunks, ca), device=a.device, dtype=torch.float32)
    status = _lib().head_wgrad_mma(
        kind, build.ptr(a), build.ptr(b), n, h, w, chunks, segs,
        build.ptr(pw), build.ptr(pb), build.stream_ptr(a.device),
    )
    build.check(status, "head_wgrad_mma")
    return pw.sum(dim=0).reshape(3, 3, ca, cb).permute(2, 3, 0, 1), pb.sum(dim=0)


def _mma_layout(weight_oihw):
    """OIHW -> bf16 [3][3][cout][cin] (cin fastest) for the tensor-core kernels."""
    return weight_oihw.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()


def _mma_transposed_layout(weight_oihw):
    """The transposed conv as a forward conv, bf16 [3][3][cin][cout]:
    W'[a][b][i][o] = W[o, i, 2 - a, 2 - b]."""
    return weight_oihw.flip(2, 3).permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()


def _mma_tail_args(b2, w3, b3):
    return b2.float().contiguous(), w3.float().contiguous(), b3.float().reshape(1).contiguous()


def head_mma_forward(x, k1, b1, kp, b2, w3, b3):
    """The bf16 path's forward launches on bf16 x: (y4 f32, z bf16)."""
    n, _, h, w = x.shape
    z = _conv_mma(x, _mma_layout(k1), b1.float().contiguous(), 32)
    y4 = torch.empty((n, 4, h, w), device=x.device, dtype=torch.float32)
    status = _lib().head_tail_mma_fwd(
        build.ptr(z), build.ptr(_mma_layout(kp)),
        *(build.ptr(t) for t in _mma_tail_args(b2, w3, b3)),
        build.ptr(y4), n, h, w, build.stream_ptr(x.device),
    )
    build.check(status, "head_tail_mma_fwd")
    return y4, z


def head_mma_backward(x, z, k1, b1, kp, b2, w3, b3, g):
    """The bf16 path's backward launches for the cotangent g of y4.

    Returns the gradients of (x, k1, b1, kp, b2, w3, b3), each in its
    input's dtype, and the intermediates (d_phases, dz), bf16."""
    n, _, h, w = x.shape
    lib = _lib()
    tail = _mma_tail_args(b2, w3, b3)
    g = g.float().contiguous()
    dph = torch.empty((n, 128, h, w), device=x.device, dtype=torch.bfloat16)
    partial = torch.empty(
        (lib.head_tail_mma_num_tiles(n, h, w), 33), device=x.device, dtype=torch.float32
    )
    status = lib.head_tail_mma_bwd(
        build.ptr(z), build.ptr(_mma_layout(kp)), *(build.ptr(t) for t in tail),
        build.ptr(g), build.ptr(dph), build.ptr(partial), n, h, w, build.stream_ptr(x.device),
    )
    build.check(status, "head_tail_mma_bwd")
    red = partial.sum(dim=0)
    dkp, db2_phases = _wgrad_mma(0, dph, z, 128, 32)
    dz = _conv_mma(dph, _mma_transposed_layout(kp), None, 32)
    dk1, db1 = _wgrad_mma(1, dz, x, 32, 64)
    dx = _conv_mma(dz, _mma_transposed_layout(k1), None, 64)
    grads = (
        dx, dk1.to(k1.dtype), db1.to(b1.dtype), dkp.to(kp.dtype),
        db2_phases.reshape(4, 32).sum(dim=0).to(b2.dtype), red[:32].to(w3.dtype),
        red[32].to(b3.dtype).reshape(b3.shape),
    )
    return grads, (dph, dz)


class _HeadMmaFn(torch.autograd.Function):
    """bf16 path: every convolution on the tensor cores (mma.sync), f32
    accumulation; z, d_phases and dz are kept in bf16."""

    @staticmethod
    def forward(ctx, x, k1, b1, kp, b2, w3, b3):
        y4, z = head_mma_forward(x, k1, b1, kp, b2, w3, b3)
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(x, z, k1, b1, kp, b2, w3, b3)
        return y4

    @staticmethod
    def backward(ctx, g):
        grads, _ = head_mma_backward(*ctx.saved_tensors, g)
        LAUNCHES["bwd"] += 1
        return grads


class _HeadFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, kp, b2, w3, b3):
        n, _, h, w = x.shape
        lib = _lib()
        tail = (
            _tap_layout(kp), b2.float().contiguous(), w3.float().contiguous(),
            b3.float().reshape(1).contiguous(),
        )
        z = _conv(x, _tap_layout(k1), b1.float().contiguous(), x.dtype, 32)
        y4 = torch.empty((n, 4, h, w), device=x.device, dtype=torch.float32)
        status = lib.head_tail_fwd(
            build.ptr(z), _CODES[z.dtype], *(build.ptr(t) for t in tail),
            build.ptr(y4), n, h, w, build.stream_ptr(x.device),
        )
        build.check(status, "head_tail_fwd")
        LAUNCHES["fwd"] += 1
        ctx.save_for_backward(x, z, k1, kp, *tail)
        ctx.dtypes = (k1.dtype, b1.dtype, kp.dtype, b2.dtype, w3.dtype, b3.dtype, b3.shape)
        return y4

    @staticmethod
    def backward(ctx, g):
        x, z, k1, kp, kp_tap, b2f, w3f, b3f = ctx.saved_tensors
        k1_dt, b1_dt, kp_dt, b2_dt, w3_dt, b3_dt, b3_shape = ctx.dtypes
        n, _, h, w = x.shape
        lib = _lib()
        g = g.float().contiguous()
        tiles = lib.head_num_tiles(n, h, w)
        dph = torch.empty((n, 128, h, w), device=x.device, dtype=torch.float32)
        partial = torch.empty((tiles, 33), device=x.device, dtype=torch.float32)
        status = lib.head_tail_bwd(
            build.ptr(z), _CODES[z.dtype], build.ptr(kp_tap), build.ptr(b2f),
            build.ptr(w3f), build.ptr(b3f), build.ptr(g), build.ptr(dph),
            build.ptr(partial), n, h, w, build.stream_ptr(x.device),
        )
        build.check(status, "head_tail_bwd")
        red = partial.sum(dim=0)
        dw3, db3 = red[:32], red[32]
        dkp, db2_phases = _wgrad(0, dph, z, 128, 32)
        db2 = db2_phases.reshape(4, 32).sum(dim=0)
        dz = _conv(dph, _flipped_transpose_layout(kp), None, torch.float32, 32)
        dk1, db1 = _wgrad(1, dz, x, 32, 64)
        dx = _conv(dz, _flipped_transpose_layout(k1), None, x.dtype, 64)
        LAUNCHES["bwd"] += 1
        return (
            dx, dk1.to(k1_dt), db1.to(b1_dt), dkp.to(kp_dt), db2.to(b2_dt),
            dw3.to(w3_dt), db3.to(b3_dt).reshape(b3_shape),
        )


def head_interior(x, k1, b1, kp, b2, w3, b3):
    """Interior of the parity head on NCHW features; y4 (n, 4, h, w) float32.

    Argument layouts as `head_interior_plain`. Phase index j = 2p + q."""
    if not x.is_cuda:
        return head_interior_plain(x, k1, b1, kp, b2, w3, b3)
    n, c, h, w = x.shape
    if c != 64 or tuple(k1.shape) != (32, 64, 3, 3) or tuple(kp.shape) != (128, 32, 3, 3):
        raise ValueError("head kernel: expects 64 -> 32 -> 4*32 channels")
    if x.dtype not in _CODES:
        raise ValueError(f"head kernel: unsupported dtype {x.dtype}")
    build.require_cuda_tensors("head_interior", x=x)
    fn = _HeadMmaFn if x.dtype == torch.bfloat16 else _HeadFn
    return fn.apply(x, k1, b1, kp, b2, w3, b3)


def head_interior_mma_emulated(x, k1, b1, kp, b2, w3, b3, g, rounded=True, given=None):
    """Plain f32 version of the bf16 tensor-core path's arithmetic.

    x, k1 and kp enter as bf16 values; z, d_phases, dz and dx are rounded to
    bf16 where `head_mma_forward` / `head_mma_backward` store them; every
    product and sum is f32 (run it with TF32 off). Returns y4, the gradients
    of (x, k1, b1, kp, b2, w3, b3) for the cotangent g (n, 4, h, w), each in
    its input's dtype, and the intermediates (z, d_phases, dz).

    `given`, the kernels' own (z, d_phases, dz), makes each stage start from
    what the kernels computed, so every stage is held on its own: otherwise a
    one-ulp difference in a rounded z tips relu sides downstream, which
    moves the gradients by ~1e-3 in either version. With `rounded=False`
    nothing is rounded: the same analytic backward in plain f32."""
    rnd = (lambda t: t.to(torch.bfloat16).float()) if rounded else (lambda t: t)
    n, _, h, w = x.shape
    xf, k1f, kpf = (rnd(t.float()) for t in (x, k1, kp))
    b1f, b2f, w3f, g = b1.float(), b2.float(), w3.float(), g.float()
    z = rnd(F.conv2d(xf, k1f, b1f, padding=1))
    z_in = given[0].float() if given is not None else z
    ph = F.conv2d(z_in, kpf, padding=1).reshape(n, 4, 32, h, w)
    t = torch.relu(ph + b2f[None, None, :, None, None])
    y4 = torch.einsum("njchw,c->njhw", t, w3f) + b3.float()
    gw = g[:, :, None] * w3f[None, None, :, None, None]
    dph = rnd(torch.where(t > 0, gw, 0.0)).reshape(n, 128, h, w)
    dph_in = given[1].float() if given is not None else dph
    dz = rnd(torch.nn.grad.conv2d_input(z.shape, kpf, dph_in, padding=1))
    dz_in = given[2].float() if given is not None else dz
    grads = (
        rnd(torch.nn.grad.conv2d_input(x.shape, k1f, dz_in, padding=1)),
        torch.nn.grad.conv2d_weight(xf, k1.shape, dz_in, padding=1),
        dz_in.sum(dim=(0, 2, 3)),
        torch.nn.grad.conv2d_weight(z_in, kp.shape, dph_in, padding=1),
        dph_in.sum(dim=(0, 2, 3)).reshape(4, 32).sum(dim=0),
        torch.einsum("njhw,njchw->c", g, t),
        g.sum().reshape(b3.shape),
    )
    grads = tuple(d.to(a.dtype) for d, a in zip(grads, (x, k1, b1, kp, b2, w3, b3)))
    return y4, grads, (z, dph, dz)
