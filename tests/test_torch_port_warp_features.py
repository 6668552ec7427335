"""The bounded-radius feature warp: the port's plain versions vs the JAX package's.

`warp_features` on the CPU runs `warp_features_plain`
(`ops/warp.py:windowed_matmul_warp` with out-of-window corners dropped). It
is held against the Pallas kernel it replaces, run in interpret mode
(`pallas_mode("force")`), also with displacements beyond the radius, where
that kernel drops a corner outside its window; and against the JAX package's
`warp_bilinear_matmul` within the radius. The port's `warp_bilinear_matmul`
(which clamps beyond the radius, as the JAX one does) and `grid_sample_2d`
are held against their counterparts too. float32, 1e-5, values and feature
gradients. The CUDA kernel is held against the plain version on the card
(`chip_smoke.py`, `tests/test_torch_port_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from flowmap_tpu.ops.pallas import warp_kernel as j_wk
from flowmap_tpu.ops.pallas.runtime import pallas_mode
from flowmap_tpu.ops.warp import warp_bilinear_matmul as j_matmul
from flowmap_tpu_torch.ops.grid_sample import grid_sample_2d
from flowmap_tpu_torch.ops.kernels import warp_features as t_wf
from flowmap_tpu_torch.ops.warp import warp_bilinear_matmul, windowed_matmul_warp

torch.set_num_threads(1)


def T(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def _scene(seed, n=2, c=5, h=16, w=24, wg=None, max_dx=3.0, max_dy=1.6):
    """Features, a displacement grid (n, h, wg, 2) with |dx| <= max_dx and
    |dy| <= max_dy pixels, and a probe for the gradient."""
    rng = np.random.default_rng(seed)
    wg = wg or w
    feats = rng.normal(size=(n, c, h, w)).astype(np.float32)
    base = np.stack(np.meshgrid((np.arange(wg) + 0.5) / wg, (np.arange(h) + 0.5) / h,
                                indexing="xy"), -1)[None]
    flow = (rng.uniform(size=(n, h, wg, 2)) - 0.5) * 2 * np.array([max_dx / w, max_dy / h])
    grid = ((base + flow) * 2 - 1).astype(np.float32)
    probe = rng.normal(size=(n, c, h, wg)).astype(np.float32)
    return feats, grid, probe


def _t_value_and_grad(fn, feats, grid, probe):
    tf = T(feats, True)
    out = fn(tf, T(grid))
    (grad,) = torch.autograd.grad(torch.sum(out * T(probe)), tf)
    return out.detach().numpy(), grad.numpy()


def _j_value_and_grad(fn, feats, grid, probe):
    out, vjp = jax.vjp(lambda a: fn(a, jnp.asarray(grid)), jnp.asarray(feats))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(probe))[0])


@pytest.mark.parametrize(
    "case",
    [
        dict(seed=0, max_dy=1.6, radius=4),  # inside the radius
        dict(seed=1, max_dy=6.0, radius=2),  # beyond it: corners are dropped
        dict(seed=2, max_dy=1.0, radius=1, wg=16),  # a grid narrower than the features
        dict(seed=3, max_dy=2.5, radius=3, max_dx=40.0),  # columns far outside the image
    ],
)
def test_warp_features_plain_vs_pallas(case):
    radius = case.pop("radius")
    feats, grid, probe = _scene(**case)
    got, got_grad = _t_value_and_grad(
        lambda a, g: t_wf.warp_features(a, g, radius), feats, grid, probe)
    with pallas_mode("force"):
        want, want_grad = _j_value_and_grad(
            lambda a, g: j_wk.warp_features(a, g, radius), feats, grid, probe)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_features_plain_vs_matmul_within_the_radius(seed):
    """Within the radius the window cuts nothing: the plain version, the JAX
    matmul warp and the unbounded `grid_sample_2d` all agree."""
    feats, grid, probe = _scene(seed, max_dy=2.5)
    got, got_grad = _t_value_and_grad(
        lambda a, g: t_wf.warp_features_plain(a, g, 3), feats, grid, probe)
    with pallas_mode("off"):
        want, want_grad = _j_value_and_grad(
            lambda a, g: j_matmul(a, g, radius=3), feats, grid, probe)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-5)
    free, free_grad = _t_value_and_grad(
        lambda a, g: grid_sample_2d(a, g, "zeros"), feats, grid, probe)
    np.testing.assert_allclose(got, free, atol=1e-5)
    np.testing.assert_allclose(got_grad, free_grad, atol=1e-5)


@pytest.mark.parametrize("max_dy,radius", [(1.6, 4), (6.0, 2)])
def test_warp_bilinear_matmul_vs_jax(max_dy, radius):
    """The port's matmul warp is the JAX package's everywhere: beyond the
    radius both clamp the floor corner's slot to the window's edge, which is
    not what the kernel does there."""
    feats, grid, probe = _scene(5, max_dy=max_dy)
    got, got_grad = _t_value_and_grad(
        lambda a, g: warp_bilinear_matmul(a, g, radius=radius), feats, grid, probe)
    want, want_grad = _j_value_and_grad(
        lambda a, g: j_matmul(a, g, radius=radius), feats, grid, probe)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-5)
    dropped = windowed_matmul_warp(T(feats), T(grid), radius, "drop").numpy()
    assert (np.abs(dropped - got).max() > 1e-2) == (max_dy > radius)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d_vs_jax(padding_mode):
    feats, grid, probe = _scene(6, max_dx=30.0, max_dy=20.0)
    got, got_grad = _t_value_and_grad(
        lambda a, g: grid_sample_2d(a, g, padding_mode), feats, grid, probe)
    want, want_grad = _j_value_and_grad(
        lambda a, g: j_grid_sample_2d(a, g, padding_mode), feats, grid, probe)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-5)
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample_2d(T(feats), T(grid), "reflection")


def test_warp_features_gives_the_grid_no_gradient_and_keeps_dtype():
    feats, grid, _ = _scene(7)
    tg = T(grid, True)
    out = t_wf.warp_features(T(feats, True), tg, 3)
    assert torch.autograd.grad(out.sum(), tg, allow_unused=True)[0] is None
    bf = t_wf.warp_features(T(feats).to(torch.bfloat16), T(grid), 3)
    assert bf.dtype == torch.bfloat16 and bf.shape == out.shape
    assert float((bf.float() - out.detach()).abs().max()) < 0.05


def test_warp_features_plain_bf16_rounding_points():
    """In bfloat16 the plain version rounds where the kernels do: the column
    weights and, in the backward, the row-weighted cotangent; sums are f32
    and the results are rounded once. Each is reproduced here by hand for a
    one-pixel warp."""
    feats = torch.zeros((1, 8, 3, 4), dtype=torch.bfloat16)
    feats[0, :, 1, 1] = 1.0
    feats[0, :, 1, 2] = 3.0
    feats[0, :, 2, 1] = 5.0
    feats[0, :, 2, 2] = 7.0
    feats.requires_grad_(True)
    tx, ty = 0.3, 0.7
    grid = torch.zeros((1, 3, 1, 2))
    grid[0, :, 0, 0] = 5.0  # rows 0 and 2 sample far outside the image
    grid[0, 1, 0] = torch.tensor([(2 * (1 + tx) + 1) / 4 - 1, (2 * (1 + ty) + 1) / 3 - 1])
    out = t_wf.warp_features_plain(feats, grid, 1)
    x = ((grid[0, 1, 0, 0] + 1) * 4 - 1) * 0.5
    y = ((grid[0, 1, 0, 1] + 1) * 3 - 1) * 0.5
    fx, fy = x - torch.floor(x), y - torch.floor(y)
    w0, w1 = (1 - fx).to(torch.bfloat16).float(), fx.to(torch.bfloat16).float()
    want = (1 - fy) * (w0 * 1.0 + w1 * 3.0) + fy * (w0 * 5.0 + w1 * 7.0)
    assert torch.equal(out[0, :, 1, 0], want.to(torch.bfloat16).expand(8))
    (grad,) = torch.autograd.grad(out, feats, torch.full_like(out, 1.5))
    gw = ((1 - fy) * 1.5).to(torch.bfloat16).float()
    assert torch.equal(grad[0, :, 1, 2], (w1 * gw).to(torch.bfloat16).expand(8))


def test_warp_features_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper launches or raises; its checks come
    before any launch, so a tensor that only claims to be on the card drives
    them here."""
    feats, grid, _ = _scene(8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_wf.warp_features(T(feats).double(), T(grid), 2)
    with pytest.raises(ValueError, match="vector width"):
        t_wf.warp_features(T(feats), T(grid), 2)  # 5 channels
    with pytest.raises(ValueError, match="grid must be"):
        t_wf.warp_features(T(feats[:, :4]), T(grid[:, :8]), 2)
