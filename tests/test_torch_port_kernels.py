"""Plain versions of the port's three kernels vs the JAX package's kernels.

On the CPU each wrapper of `flowmap_tpu_torch/ops/kernels/` runs its plain
PyTorch version. It is held against the Pallas kernel it replaces, run in
interpret mode (`pallas_mode("force")`), and against the JAX package's XLA
formulation: values and every gradient, float32. The CUDA kernels themselves
are held against these plain versions on the card (`chip_smoke.py`,
`tests/test_torch_port_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from flowmap_tpu.loss.loss import LossFlowCfg, loss_flow
from flowmap_tpu.model.backbone.midas_net import _head_parity_kernel
from flowmap_tpu.ops.pallas import flow_loss as j_fl
from flowmap_tpu.ops.pallas import head_kernel as j_head
from flowmap_tpu.ops.pallas import shift_warp as j_sw
from flowmap_tpu.ops.pallas.runtime import pallas_mode
from flowmap_tpu.ops.warp import warp_bilinear_shifts as j_shifts
from flowmap_tpu.types import Flows as JFlows
from flowmap_tpu.types import ModelOutput as JModelOutput
from flowmap_tpu_torch.model.backbone.midas_net import head_parity_kernel
from flowmap_tpu_torch.ops.kernels import flow_loss as t_fl
from flowmap_tpu_torch.ops.kernels import head_kernel as t_head
from flowmap_tpu_torch.ops.kernels import shift_warp as t_sw
from flowmap_tpu_torch.types import Flows as TFlows

torch.set_num_threads(1)


def T(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------------- A: flow loss


def _flow_scene(rng, f=5, h=16, w=24):
    surfaces = rng.normal(size=(1, f, h, w, 3)).astype(np.float32)
    surfaces[..., 2] += 4.0
    ext = np.zeros((1, f, 4, 4), np.float32)
    for i in range(f):
        v = rng.normal(size=3) * 0.15
        skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        ext[0, i, :3, :3] = expm(skew)
        ext[0, i, :3, 3] = rng.normal(size=3) * 0.3
        ext[0, i, 3, 3] = 1.0
    k = np.zeros((1, f, 3, 3), np.float32)
    k[0, :, 0, 0] = 1.2 + 0.1 * rng.normal(size=f)
    k[0, :, 1, 1] = 1.3 + 0.1 * rng.normal(size=f)
    k[0, :, :2, 2] = 0.5
    k[0, :, 2, 2] = 1.0
    flows = [
        (rng.normal(size=(1, f - 1, h, w, 2)) * 0.05).astype(np.float32),
        (rng.normal(size=(1, f - 1, h, w, 2)) * 0.05).astype(np.float32),
        rng.uniform(size=(1, f - 1, h, w)).astype(np.float32),
        rng.uniform(size=(1, f - 1, h, w)).astype(np.float32),
    ]
    return surfaces, ext, k, flows, (h, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_loss_plain_vs_pallas_and_xla(seed):
    """Loss rtol 2e-5; gradients to surfaces, extrinsics and intrinsics 2e-4
    of each gradient's max (reassociated f32 sums)."""
    surfaces, ext, k, flows, shape = _flow_scene(np.random.default_rng(seed))
    j_flows = JFlows(*(jnp.asarray(a) for a in flows))

    def j_kernel(s, e, kk):
        loss_sum, valid = j_fl.flow_loss_pallas(s, e, kk, j_flows, shape, 0.01)
        return loss_sum / jnp.maximum(valid, 1.0)

    def j_xla(s, e, kk):
        out = JModelOutput(depths=None, surfaces=s, intrinsics=kk, extrinsics=e,
                           backward_correspondence_weights=None)
        return loss_flow(LossFlowCfg(), j_flows, out, shape)

    ts, te, tk = T(surfaces, True), T(ext, True), T(k, True)
    loss_sum, valid = t_fl.flow_loss(ts, te, tk, TFlows(*(T(a) for a in flows)), shape, 0.01)
    t_loss = loss_sum / torch.clamp(valid, min=1.0)
    t_grads = torch.autograd.grad(t_loss, (ts, te, tk))
    for fn, mode in ((j_kernel, "force"), (j_xla, "off")):
        with pallas_mode(mode):
            j_loss, j_grads = jax.value_and_grad(fn, (0, 1, 2))(surfaces, ext, k)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=2e-5)
        for got, want in zip(t_grads, j_grads):
            assert rel(got, want) < 2e-4


# ---------------------------------------------------------------- B: shift warp


def _warp_scene(rng, n, h, w, c, max_dx, max_dy):
    feats = rng.normal(size=(n, h, w, c)).astype(np.float32)
    base = np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h,
                                indexing="xy"), -1)[None]
    flow = (rng.uniform(size=(n, h, w, 2)) - 0.5) * 2 * np.array([max_dx / w, max_dy / h])
    return feats, ((base + flow) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("radii", [(1, 2), (3, 4)])
def test_shift_warp_plain_vs_pallas_and_xla(radii):
    """Values and feature gradients within 1e-5 (the same stencil)."""
    ry, rx = radii
    feats, grid = _warp_scene(np.random.default_rng(ry), 2, 16, 24, 8, rx, ry)
    probe = np.random.default_rng(9).normal(size=feats.shape).astype(np.float32)

    def j_kernel(a):
        return jnp.sum(j_sw.warp_shifts_tpu(a, grid, ry, rx) * probe)

    def j_xla(a):
        return jnp.sum(j_shifts(a, grid, ry, rx) * probe)

    tf = T(feats, True)
    t_out = t_sw.warp_shifts(tf, T(grid), ry, rx)
    (t_grad,) = torch.autograd.grad(torch.sum(t_out * T(probe)), tf)
    with pallas_mode("force"):
        j_out = j_sw.warp_shifts_tpu(feats, grid, ry, rx)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=1e-5)
    for fn, mode in ((j_kernel, "force"), (j_xla, "off")):
        with pallas_mode(mode):
            j_grad = jax.grad(fn)(feats)
        np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), atol=1e-5)


# ---------------------------------------------------------------- C: head interior


def test_head_interior_plain_vs_pallas():
    """The interior y4 (borders excluded: they are spliced over) within 1e-5
    of its max, and every gradient within 2e-4 of its max for a cotangent
    that is zero on the border, as the splice delivers it."""
    rng = np.random.default_rng(3)
    n, h, w = 2, 12, 20
    x = rng.normal(size=(n, 64, h, w)).astype(np.float32)
    k1 = (0.1 * rng.normal(size=(3, 3, 64, 32))).astype(np.float32)  # HWIO
    b1 = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    w2 = (0.1 * rng.normal(size=(3, 3, 32, 32))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    w3 = rng.normal(size=(32,)).astype(np.float32)
    b3 = np.float32(0.3)
    g = rng.normal(size=(n, 4, h, w)).astype(np.float32)
    g[:, :, [0, -1]] = 0.0
    g[:, :, :, [0, -1]] = 0.0

    kp_j = _head_parity_kernel({"kernel": jnp.asarray(w2)}, jnp.float32)
    kp_t = head_parity_kernel(T(w2).permute(3, 2, 0, 1))
    np.testing.assert_allclose(
        kp_t.numpy(), np.asarray(kp_j).transpose(3, 2, 0, 1), rtol=1e-6, atol=1e-7
    )

    def j_fn(x_, k1_, b1_, kp_, b2_, w3_, b3_):
        y4 = j_head.head_interior(x_, k1_, b1_, kp_, b2_, w3_, b3_)
        return jnp.sum(y4 * g), y4

    with pallas_mode("force"), jax.default_matmul_precision("highest"):
        (_, y4_j), grads_j = jax.value_and_grad(j_fn, argnums=tuple(range(7)), has_aux=True)(
            x, k1, b1, kp_j, b2, w3, b3
        )
    inputs = [
        T(x, True), T(k1).permute(3, 2, 0, 1).detach().requires_grad_(True), T(b1, True),
        T(np.asarray(kp_j)).permute(3, 2, 0, 1).detach().requires_grad_(True),
        T(b2, True), T(w3, True), T(b3, True),
    ]
    y4_t = t_head.head_interior(*inputs)
    assert rel(y4_t[:, :, 1:-1, 1:-1], np.asarray(y4_j)[:, :, 1:-1, 1:-1]) < 1e-5
    grads_t = torch.autograd.grad(torch.sum(y4_t * T(g)), inputs)
    layouts = [None, (3, 2, 0, 1), None, (3, 2, 0, 1), None, None, None]
    for got, want, perm in zip(grads_t, grads_j, layouts):
        want = np.asarray(want)
        if perm is not None:
            want = want.transpose(perm)
        assert rel(got, want) < 2e-4


@pytest.mark.parametrize("mode", ["unrounded", "rounded", "given"])
def test_head_interior_mma_emulation(mode):
    """The plain f32 emulation of the bf16 kernels' arithmetic, which the
    card holds them to. Unrounded, its analytic backward is autograd's of
    the plain version within 1e-5 (rel L2). Rounded, on bf16 inputs, it
    stays within 5e-2 of the f32 plain version and its dx is bf16-valued.
    Given its own intermediates, it repeats itself exactly."""
    rng = np.random.default_rng(4)
    n, h, w = 2, 10, 18
    shapes_scales = [((n, 64, h, w), 1.0), ((32, 64, 3, 3), 0.06), ((32,), 0.1),
                     ((128, 32, 3, 3), 0.08), ((32,), 0.1), ((32,), 0.25), ((), 0.1)]
    base = [T(s * rng.normal(size=shape)) for shape, s in shapes_scales]
    rounded = mode != "unrounded"
    if rounded:
        base = [t.to(torch.bfloat16).float() for t in base]
    g = T(rng.normal(size=(n, 4, h, w)))
    got, got_grads, inter = t_head.head_interior_mma_emulated(*base, g, rounded=rounded)
    if mode == "given":
        again = t_head.head_interior_mma_emulated(*base, g, given=inter)
        for a, b in zip((got, *got_grads, *inter), (again[0], *again[1], *again[2])):
            assert torch.equal(a, b)
        return
    inputs = [t.clone().requires_grad_(True) for t in base]
    want = t_head.head_interior_plain(*inputs)
    want_grads = torch.autograd.grad(want, inputs, g)
    tol = 5e-2 if rounded else 1e-5
    for a, b in zip((got, *got_grads), (want, *want_grads)):
        assert a.shape == b.shape
        assert float((a - b).detach().norm()) <= tol * float(b.detach().norm())
    if rounded:
        dx = got_grads[0]
        assert torch.equal(dx, dx.to(torch.bfloat16).float())
        assert not torch.equal(dx, want_grads[0])
