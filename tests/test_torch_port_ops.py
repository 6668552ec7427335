"""The port's geometry, sampling, Procrustes and warp ops vs flowmap_tpu.

Same NumPy inputs (from a seed) go through the JAX function and its
counterpart in `flowmap_tpu_torch`, on the CPU in float32; values and, where
differentiable, gradients must agree within the tolerance each test states
(f32 round-off of differently ordered sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from flowmap_tpu.loss import mapping as j_mapping
from flowmap_tpu.ops import geometry as j_geo
from flowmap_tpu.ops import grid_sample as j_gs
from flowmap_tpu.ops import procrustes as j_pro
from flowmap_tpu.ops import resize as j_resize
from flowmap_tpu.ops import surface as j_surface
from flowmap_tpu.ops import warp as j_warp
from flowmap_tpu_torch.loss import mapping as t_mapping
from flowmap_tpu_torch.ops import geometry as t_geo
from flowmap_tpu_torch.ops import grid_sample as t_gs
from flowmap_tpu_torch.ops import procrustes as t_pro
from flowmap_tpu_torch.ops import resize as t_resize
from flowmap_tpu_torch.ops import surface as t_surface
from flowmap_tpu_torch.ops import warp as t_warp

torch.set_num_threads(1)


def T(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def assert_close(got, want, rtol, atol):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol
    )


def _poses(rng, f, scale=0.15):
    out = np.zeros((1, f, 4, 4), np.float32)
    for i in range(f):
        w = rng.normal(size=3) * scale
        skew = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        out[0, i, :3, :3] = expm(skew)
        out[0, i, :3, 3] = rng.normal(size=3) * 0.3
        out[0, i, 3, 3] = 1.0
    return out


def _intrinsics(rng, f):
    k = np.zeros((1, f, 3, 3), np.float32)
    k[0, :, 0, 0] = 1.2 + 0.1 * rng.normal(size=f)
    k[0, :, 1, 1] = 1.3 + 0.1 * rng.normal(size=f)
    k[0, :, 0, 2] = 0.5
    k[0, :, 1, 2] = 0.5
    k[0, :, 2, 2] = 1.0
    return k


def test_sample_image_grid_and_focal_intrinsics():
    xy_j, idx_j = j_geo.sample_image_grid((5, 7))
    xy_t, idx_t = t_geo.sample_image_grid((5, 7))
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    f = np.array([0.5, 1.1, 2.0], np.float32)
    assert_close(
        t_geo.focal_lengths_to_intrinsics(T(f), (6, 10)),
        j_geo.focal_lengths_to_intrinsics(jnp.asarray(f), (6, 10)),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("num_pairs", [1, 6, 11])
def test_pose_chain_matches_associative_scan(num_pairs):
    rng = np.random.default_rng(num_pairs)
    rel = _poses(rng, num_pairs)
    assert_close(
        t_geo.get_extrinsics(T(rel)), j_geo.get_extrinsics(jnp.asarray(rel)),
        rtol=1e-5, atol=1e-5,
    )


def test_flows_values_and_gradients():
    """Forward/backward induced flow, unproject and the rigid inverse: values
    and gradients (rtol 1e-5 / 1e-4)."""
    rng = np.random.default_rng(0)
    f, h, w = 4, 6, 8
    surfaces = rng.normal(size=(1, f, h, w, 3)).astype(np.float32)
    surfaces[..., 2] += 4.0
    ext = _poses(rng, f)
    k = _intrinsics(rng, f)
    probe = rng.normal(size=(1, f - 1, h, w, 2)).astype(np.float32)

    def j_fn(s, e, kk):
        return jnp.sum(
            (j_geo.compute_forward_flow(s, e, kk) + 2 * j_geo.compute_backward_flow(s, e, kk))
            * probe
        )

    ts, te, tk = T(surfaces, True), T(ext, True), T(k, True)
    t_val = torch.sum(
        (t_geo.compute_forward_flow(ts, te, tk) + 2 * t_geo.compute_backward_flow(ts, te, tk))
        * T(probe)
    )
    j_val, j_grads = jax.value_and_grad(j_fn, (0, 1, 2))(surfaces, ext, k)
    assert_close(t_val, j_val, rtol=1e-5, atol=1e-5)
    t_grads = torch.autograd.grad(t_val, (ts, te, tk))
    for got, want in zip(t_grads, j_grads):
        assert_close(got, want, rtol=1e-4, atol=1e-4)

    xy = rng.uniform(size=(h, w, 2)).astype(np.float32)
    z = rng.uniform(1, 3, size=(1, f, h, w)).astype(np.float32)
    assert_close(
        t_geo.unproject(T(xy), T(z), T(k)[:, :, None, None]),
        j_geo.unproject(xy, z, k[:, :, None, None]),
        rtol=1e-6, atol=1e-6,
    )
    assert_close(t_geo.rigid_inverse(T(ext)), j_geo.rigid_inverse(ext), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_points(padding_mode):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 3, 7, 9)).astype(np.float32)
    xy = rng.uniform(-0.2, 1.2, size=(2, 50, 2)).astype(np.float32)
    probe = rng.normal(size=(2, 3, 50)).astype(np.float32)
    j_val, j_grad = jax.value_and_grad(
        lambda a: jnp.sum(j_gs.grid_sample_points(a, xy, padding_mode) * probe)
    )(img)
    ti = T(img, True)
    t_out = t_gs.grid_sample_points(ti, T(xy), padding_mode)
    assert_close(t_out, j_gs.grid_sample_points(img, xy, padding_mode), rtol=1e-5, atol=1e-6)
    (t_grad,) = torch.autograd.grad(torch.sum(t_out * T(probe)), ti)
    assert_close(t_grad, j_grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 20), (11, 13)])
def test_resize_bilinear(shape):
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 1, 8, 10)).astype(np.float32)
    assert_close(
        t_resize.resize_bilinear(T(img), shape), j_resize.resize_bilinear(img, shape),
        rtol=1e-5, atol=1e-6,
    )


def test_align_rigid_values_and_gradients():
    """Horn's quaternion by repeated squaring: values rtol 1e-4, gradients
    1e-3 (ten normalized 4x4 squarings amplify f32 round-off)."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(3, 40, 3)).astype(np.float32)
    rot = _poses(rng, 3, scale=0.5)[0]
    q = (np.einsum("bij,bnj->bni", rot[:, :3, :3], p) + rot[:, None, :3, 3]
         + 0.01 * rng.normal(size=p.shape)).astype(np.float32)
    wts = rng.uniform(0.1, 1.0, size=(3, 40)).astype(np.float32)
    probe = rng.normal(size=(3, 4, 4)).astype(np.float32)
    j_val, j_grads = jax.value_and_grad(
        lambda a, b, c: jnp.sum(j_pro.align_rigid(a, b, c) * probe), (0, 1, 2)
    )(p, q, wts)
    tp, tq, tw = T(p, True), T(q, True), T(wts, True)
    t_out = t_pro.align_rigid(tp, tq, tw)
    assert_close(t_out, j_pro.align_rigid(p, q, wts), rtol=1e-4, atol=1e-5)
    t_grads = torch.autograd.grad(torch.sum(t_out * T(probe)), (tp, tq, tw))
    for got, want in zip(t_grads, j_grads):
        assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_align_surfaces_values_and_gradients():
    rng = np.random.default_rng(4)
    f, h, w = 4, 8, 12
    surfaces = rng.normal(size=(1, f, h, w, 3)).astype(np.float32) * 0.3
    surfaces[..., 2] += 3.0
    flows = (rng.normal(size=(1, f - 1, h, w, 2)) * 0.05).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(1, f - 1, h, w)).astype(np.float32)
    idx = np.linspace(0, h * w - 1, 50).astype(np.int32)
    probe = rng.normal(size=(1, f, 4, 4)).astype(np.float32)
    j_val, j_grads = jax.value_and_grad(
        lambda s, wt: jnp.sum(j_surface.align_surfaces(s, flows, wt, jnp.asarray(idx)) * probe),
        (0, 1),
    )(surfaces, weights)
    ts, tw = T(surfaces, True), T(weights, True)
    t_out = t_surface.align_surfaces(ts, T(flows), tw, torch.as_tensor(idx, dtype=torch.long))
    assert_close(
        t_out, j_surface.align_surfaces(surfaces, flows, weights, jnp.asarray(idx)),
        rtol=1e-4, atol=1e-5,
    )
    t_grads = torch.autograd.grad(torch.sum(t_out * T(probe)), (ts, tw))
    for got, want in zip(t_grads, j_grads):
        assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_shift_warp_stencil_and_radius():
    """The plain shift stencil equals ops/warp.py's (values and feature
    gradients, 1e-6); `radius_for_flows` is the same host function."""
    rng = np.random.default_rng(5)
    n, h, w, c = 2, 10, 14, 5
    feats = rng.normal(size=(n, h, w, c)).astype(np.float32)
    base = np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h,
                                indexing="xy"), -1)
    flow = (rng.uniform(size=(n, h, w, 2)) - 0.5) * np.array([4 / w, 3 / h])
    grid = ((base + flow) * 2 - 1).astype(np.float32)
    probe = rng.normal(size=(n, h, w, c)).astype(np.float32)
    j_val, j_grad = jax.value_and_grad(
        lambda a: jnp.sum(j_warp.warp_bilinear_shifts(a, grid, 2, 3) * probe)
    )(feats)
    tf = T(feats, True)
    t_out = t_warp.warp_bilinear_shifts(tf, T(grid), 2, 3)
    assert_close(t_out, j_warp.warp_bilinear_shifts(feats, grid, 2, 3), rtol=1e-6, atol=1e-6)
    (t_grad,) = torch.autograd.grad(torch.sum(t_out * T(probe)), tf)
    assert_close(t_grad, j_grad, rtol=1e-6, atol=1e-6)
    for margin in (0, 1):
        assert t_warp.radius_for_flows(flow[..., 1], h, margin) == j_warp.radius_for_flows(
            flow[..., 1], h, margin
        )


@pytest.mark.parametrize("name", ["huber", "l1", "l2"])
def test_mapping(name):
    rng = np.random.default_rng(6)
    a = rng.normal(size=(3, 5, 2)).astype(np.float32) * 0.02
    b = rng.normal(size=(3, 5, 2)).astype(np.float32) * 0.02
    j_cfg = j_mapping.MappingCfg(name=name)
    t_cfg = t_mapping.MappingCfg(name=name)
    assert_close(
        t_mapping.apply_mapping(t_cfg, T(a), T(b), (6, 10)),
        j_mapping.apply_mapping(j_cfg, a, b, (6, 10)),
        rtol=1e-5, atol=1e-8,
    )
