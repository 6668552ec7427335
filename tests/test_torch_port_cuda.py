"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
`flowmap_tpu_torch/ops/kernels/csrc/`); elsewhere they skip. On the card:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

(`--noconftest`: the suite's conftest imports JAX, which that machine lacks.)

Small shapes, float32 with TF32 off; `chip_smoke.py` repeats the comparison
at the main path's shapes and in bfloat16.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def test_shift_warp_kernel_matches_stencil_exactly(cuda):
    from flowmap_tpu_torch.ops.kernels.shift_warp import warp_shifts
    from flowmap_tpu_torch.ops.warp import warp_bilinear_shifts

    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn((3, 12, 20, 16), generator=gen, device=cuda).to(dtype)
        feats.requires_grad_(True)
        base_y = (torch.arange(12, device=cuda) + 0.5) / 12
        base_x = (torch.arange(20, device=cuda) + 0.5) / 20
        gy, gx = torch.meshgrid(base_y, base_x, indexing="ij")
        flow = (torch.rand((3, 12, 20, 2), generator=gen, device=cuda) - 0.5) * 0.2
        grid = ((torch.stack([gx, gy], -1) + flow) * 2 - 1).contiguous()
        g = torch.randn(feats.shape, generator=gen, device=cuda).to(dtype)
        out_k = warp_shifts(feats, grid, 2, 3)
        out_p = warp_bilinear_shifts(feats, grid, 2, 3)
        assert torch.equal(out_k, out_p)
        (d_k,) = torch.autograd.grad(out_k, feats, g)
        (d_p,) = torch.autograd.grad(out_p, feats, g)
        assert torch.equal(d_k, d_p)


def test_flow_loss_kernel_matches_plain(cuda):
    from flowmap_tpu_torch.loss.mapping import MappingCfg
    from flowmap_tpu_torch.ops.kernels.flow_loss import flow_loss, flow_loss_plain
    from flowmap_tpu_torch.utils.synthetic import SyntheticSceneCfg, make_scene
    from flowmap_tpu_torch.ops.geometry import sample_image_grid, unproject

    batch, flows, depths = make_scene(SyntheticSceneCfg(num_frames=6, image_shape=(32, 48)), cuda)
    xy, _ = sample_image_grid((32, 48), cuda)
    surfaces = unproject(xy, depths * 1.05, batch.intrinsics[:, :, None, None])
    inputs = [t.clone().requires_grad_(True) for t in (surfaces, batch.extrinsics, batch.intrinsics)]
    got = flow_loss(*inputs, flows, (32, 48), 0.01)[0]
    want = flow_loss_plain(*inputs, flows, (32, 48), MappingCfg("huber", 0.01))[0]
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(got, inputs), torch.autograd.grad(want, inputs)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_head_kernel_matches_plain(cuda):
    from flowmap_tpu_torch.ops.kernels.head_kernel import head_interior, head_interior_plain

    gen = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).requires_grad_(True)

    inputs = [rnd(2, 64, 20, 36), rnd(32, 64, 3, 3, scale=0.06), rnd(32, scale=0.1),
              rnd(128, 32, 3, 3, scale=0.08), rnd(32, scale=0.1), rnd(32, scale=0.25),
              rnd(scale=0.1)]
    g = torch.randn((2, 4, 20, 36), generator=gen, device=cuda)
    got, want = head_interior(*inputs), head_interior_plain(*inputs)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for a, b in zip(torch.autograd.grad(got, inputs, g), torch.autograd.grad(want, inputs, g)):
        assert float((a - b).norm()) <= 2e-3 * float(b.norm())


def test_head_kernel_bf16_matches_plain_on_ragged_tiles(cuda):
    """The bf16 tensor-core path on a frame that fills no tile exactly
    (20 x 36): every stage within 1e-3 (rel L2) of the f32 emulation of its
    roundings, started from the kernels' own intermediates; within 1e-1 of
    the bf16 plain version, and no less accurate than it against the f32
    plain version on the same inputs."""
    from flowmap_tpu_torch.ops.kernels.head_kernel import (
        head_interior,
        head_interior_mma_emulated,
        head_interior_plain,
        head_mma_backward,
        head_mma_forward,
    )

    gen = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=cuda)

    base = [rnd(3, 64, 20, 36), rnd(32, 64, 3, 3, scale=0.06), rnd(32, scale=0.1),
            rnd(128, 32, 3, 3, scale=0.08), rnd(32, scale=0.1), rnd(32, scale=0.25),
            rnd(scale=0.1)]
    g = torch.randn((3, 4, 20, 36), generator=gen, device=cuda)
    bf = [t.to(torch.bfloat16).requires_grad_(True) for t in base]
    f32 = [t.detach().float().requires_grad_(True) for t in bf]
    got, plain, ref = head_interior(*bf), head_interior_plain(*bf), head_interior_plain(*f32)
    grads = [torch.autograd.grad(o, ins, g) for o, ins in ((got, bf), (plain, bf), (ref, f32))]

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    xs = [t.detach() for t in bf]
    y_s, z_s = head_mma_forward(*xs)
    grads_s, (dph_s, dz_s) = head_mma_backward(xs[0], z_s, *xs[1:], g)
    assert torch.equal(y_s, got)
    assert all(torch.equal(a, b) for a, b in zip(grads_s, grads[0]))
    y_e, grads_e, inter_e = head_interior_mma_emulated(*xs, g, given=(z_s, dph_s, dz_s))
    for k_out, e_out in zip((y_s, z_s, dph_s, dz_s, *grads_s), (y_e, *inter_e, *grads_e)):
        assert rel_l2(k_out, e_out) <= 1e-3
    for k_out, p_out, r_out in zip((got, *grads[0]), (plain, *grads[1]), (ref, *grads[2])):
        assert rel_l2(k_out, p_out) <= 1e-1
        assert rel_l2(k_out, r_out) <= 1.25 * rel_l2(p_out, r_out) + 1e-3


def _track_scene(device, f=9, h=33, w=45, s=4, l=5, p=37, seed=5):
    """Ragged small shapes: p not a multiple of 32, odd h and w, points
    outside the frame, invisible points and an all-invisible padding frame."""
    from flowmap_tpu_torch.types import TracksPacked

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    surfaces = rnd(1, f, h, w, 3)
    surfaces[..., 2] += 4.0
    extrinsics = torch.eye(4, device=device).repeat(1, f, 1, 1)
    skew = 0.1 * rnd(f, 3)
    zero = torch.zeros(f, device=device)
    generators = torch.stack([
        torch.stack([zero, -skew[:, 2], skew[:, 1]], -1),
        torch.stack([skew[:, 2], zero, -skew[:, 0]], -1),
        torch.stack([-skew[:, 1], skew[:, 0], zero], -1),
    ], 1)
    extrinsics[0, :, :3, :3] = torch.linalg.matrix_exp(generators)
    extrinsics[0, :, :3, 3] = 0.3 * rnd(f, 3)
    intrinsics = torch.zeros(1, f, 3, 3, device=device)
    intrinsics[0, :, 0, 0] = 1.2 + 0.1 * rnd(f)
    intrinsics[0, :, 1, 1] = 1.3 + 0.1 * rnd(f)
    intrinsics[0, :, :2, 2] = 0.5
    intrinsics[0, :, 2, 2] = 1.0
    xy = torch.rand((1, s, l, p, 2), generator=gen, device=device) * 1.1 - 0.05
    vis = torch.rand((1, s, l, p), generator=gen, device=device) > 0.2
    xy[0, 1, 0] = 0.5
    vis[0, 1, 0] = False
    starts = torch.linspace(0, f - l, s).to(torch.int32).to(device)
    return [surfaces, extrinsics, intrinsics], TracksPacked(xy=xy, visibility=vis, starts=starts)


@pytest.mark.parametrize("p", [37, 600])
def test_track_loss_kernel_matches_plain(cuda, p):
    """Sums within 2e-5 rel (valid counts equal); gradients to surfaces,
    extrinsics and intrinsics within 2e-4 of each one's max (f32 sums in
    another order; the scatter's atomics). 600 points span two of the pair
    kernels' 512-point tiles, the second one ragged."""
    from flowmap_tpu_torch.loss.mapping import MappingCfg
    from flowmap_tpu_torch.ops.kernels.track_loss import track_loss, track_loss_plain

    inputs, tracks = _track_scene(cuda, p=p)
    inputs = [t.requires_grad_(True) for t in inputs]
    got, got_valid = track_loss(*inputs, tracks, (33, 45), 0.01)
    want, want_valid = track_loss_plain(*inputs, tracks, (33, 45), MappingCfg("huber", 0.01))
    assert float(got_valid) == float(want_valid) > 0
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=2e-5)
    for a, b in zip(torch.autograd.grad(got, inputs), torch.autograd.grad(want, inputs)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())


def _warp_scene(device, dtype, n=3, c=16, h=11, w=19, wg=19, max_dy=1.5, seed=6):
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((n, c, h, w), generator=gen, device=device).to(dtype).requires_grad_(True)
    base_y = (torch.arange(h, device=device) + 0.5) / h
    base_x = (torch.arange(wg, device=device) + 0.5) / wg
    gy, gx = torch.meshgrid(base_y, base_x, indexing="ij")
    flow = (torch.rand((n, h, wg, 2), generator=gen, device=device) - 0.5) * 2
    flow = flow * torch.tensor([6.0 / w, max_dy / h], device=device)
    grid = ((torch.stack([gx, gy], -1) + flow) * 2 - 1).contiguous()
    g = torch.randn((n, c, h, wg), generator=gen, device=device).to(dtype)
    return feats, grid, g


@pytest.mark.parametrize("max_dy,wg", [(1.5, 19), (5.0, 19), (1.5, 13)])
def test_warp_features_kernel_matches_plain(cuda, max_dy, wg):
    """Radius 2, displacements inside it and beyond it (where out-of-window
    corners are dropped), and a grid narrower than the features. f32: 1e-5
    of max, values and feature gradient. bf16: the plain version rounds where
    the kernel does, so all that differs is the f32 summation order under the
    final rounding: one bf16 ulp."""
    from flowmap_tpu_torch.ops.kernels.warp_features import warp_features, warp_features_plain

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        feats, grid, g = _warp_scene(cuda, dtype, wg=wg, max_dy=max_dy)
        got, want = warp_features(feats, grid, 2), warp_features_plain(feats, grid, 2)
        assert got.shape == want.shape and got.dtype == dtype
        assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())
        (d_got,) = torch.autograd.grad(got, feats, g)
        (d_want,) = torch.autograd.grad(want, feats, g)
        assert d_got.dtype == dtype
        assert float((d_got.float() - d_want.float()).abs().max()) <= tol * float(d_want.abs().max())


@pytest.mark.parametrize("case", [
    dict(b=8, length=700, c=128, d=128, groups=4),  # attention: 700 = 10 * 64 + 60
    dict(b=3, length=1000, c=128, d=2, groups=0),  # expected coordinates, no bias
    dict(b=4, length=130, c=16, d=8, groups=4),  # a per-batch bias
    dict(b=2, length=64, c=16, d=2, groups=1),  # one full tile
])
def test_softmax_expectation_kernel_matches_plain(cuda, case):
    """float32 and bfloat16 inputs, lengths that fill no tile, a grouped
    bias of 0 / -100 with one query row masked everywhere: 1e-4 of the
    largest value (d = 2: against the plain version in float64)."""
    from flowmap_tpu_torch.ops.kernels.correlation import (
        softmax_expectation,
        softmax_expectation_plain,
    )

    b, length, c, d, groups = (case[k] for k in ("b", "length", "c", "d", "groups"))
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k = (torch.randn((b, length, c), generator=gen, device=cuda) for _ in range(2))
    v = torch.rand((b, length, d), generator=gen, device=cuda) * (100.0 if d == 2 else 1.0)
    bias = None
    if groups:
        bias = torch.where(torch.rand((groups, length, length), generator=gen, device=cuda) < 0.3,
                           -100.0, 0.0)
        bias[0, 5] = -100.0
    for dtype in (torch.float32, torch.bfloat16):
        got = softmax_expectation(q.to(dtype), k.to(dtype), v, bias)
        want = softmax_expectation_plain(
            q.to(dtype), k.to(dtype), v, bias, dtype=torch.float64 if d == 2 else torch.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_softmax_expectation_kernel_raises_on_what_it_does_not_take(cuda):
    from flowmap_tpu_torch.ops.kernels import correlation

    q = torch.randn((2, 64, 32), device=cuda)
    with pytest.raises(ValueError, match="not compiled in"):
        correlation.softmax_expectation(q, q, q)
    before = dict(correlation.LAUNCHES)
    q = torch.randn((2, 64, 16), device=cuda)
    v = torch.randn((2, 64, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        correlation.softmax_expectation(q.requires_grad_(True), q, v)
    with pytest.raises(ValueError, match="dividing"):
        correlation.softmax_expectation(q.detach(), q.detach(), v, torch.zeros((3, 64, 64), device=cuda))
    assert correlation.LAUNCHES == before
    correlation.softmax_expectation(q.detach(), q.detach(), v)
    assert correlation.LAUNCHES["fwd_d8"] == before["fwd_d8"] + 1


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_dense_warp_kernel_matches_plain(cuda, padding_mode):
    """Odd sizes, a grid of another size than the image, coordinates far
    outside it: float32 and bfloat16 equal to 2e-5; the backward raises."""
    from flowmap_tpu_torch.ops.kernels.dense_warp import (
        dense_warp_bilinear,
        dense_warp_bilinear_planar_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(8)
    images = torch.rand((3, 5, 37, 53), generator=gen, device=cuda)
    xy = torch.rand((3, 29, 41, 2), generator=gen, device=cuda) * torch.tensor([80.0, 60.0], device=cuda) - 12
    xy[0, 0, :4] = torch.tensor([[-1e30, 1e30], [1e9, -1e9], [-0.5, 36.5], [52.0, 0.0]], device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = dense_warp_bilinear(images, xy, padding_mode, dtype)
        want = dense_warp_bilinear_planar_plain(images, xy[..., 0], xy[..., 1], padding_mode, dtype)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, 29, 41)
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 2e-5
    with pytest.raises(NotImplementedError, match="forward-only"):
        dense_warp_bilinear(images.requires_grad_(True), xy, padding_mode).sum().backward()


def _mlp_params(device, dtype, gen, scale=1.0):
    """(w0, b0, w1, b1, w2, b2): weights in `dtype`, biases f32, as leaves."""
    def rnd(*shape, s):
        return (torch.randn(shape, generator=gen, device=device) * s)

    params = (rnd(128, 128, s=scale / 128 ** 0.5).to(dtype), rnd(128, s=0.1),
              rnd(64, 128, s=1 / 128 ** 0.5).to(dtype), rnd(64, s=0.1),
              rnd(1, 64, s=1 / 8).to(dtype), rnd(1, s=0.1))
    return [p.requires_grad_(True) for p in params]


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


@pytest.mark.parametrize("p", [37, 1500])
def test_weight_mlp_kernel_matches_plain(cuda, p):
    """Pixel counts that fill no tile: float32 (three-pass TF32) to 1e-5 of
    the largest logit, gradients to 1e-4 in relative L2; bfloat16 (the same
    roundings, another f32 order) to 1e-2 and 3e-2. The parameter gradients
    are the same bits on a second run (fixed-order partials)."""
    from flowmap_tpu_torch.ops.kernels import weight_mlp as wm

    gen = torch.Generator(device=cuda).manual_seed(9)
    for dtype, tol, tol_g in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 1e-2, 3e-2)):
        wa, la = (torch.randn((p, 64), generator=gen, device=cuda).to(dtype).requires_grad_(True)
                  for _ in range(2))
        params = _mlp_params(cuda, dtype, gen)
        g = torch.randn(p, generator=gen, device=cuda)
        before = wm.LAUNCHES["bwd"]
        out_k = wm.weight_mlp(wa, la, *params)
        out_p = wm.weight_mlp_plain(wa, la, *params)
        scale = float(out_p.abs().max())
        assert float((out_k - out_p).abs().max()) <= tol * scale
        d_k = torch.autograd.grad(out_k, [wa, la, *params], g, retain_graph=True)
        d_p = torch.autograd.grad(out_p, [wa, la, *params], g)
        assert wm.LAUNCHES["bwd"] == before + 1
        for a, b in zip(d_k, d_p):
            assert a.dtype == b.dtype and _rel_l2(a, b) <= tol_g
        again = torch.autograd.grad(out_k, [wa, la, *params], g)
        assert all(torch.equal(a, b) for a, b in zip(again, d_k))


@pytest.mark.parametrize("max_dy,radius", [(2.5, 3), (4.5, 1)])
def test_corr_weights_kernel_matches_plain(cuda, max_dy, radius):
    """Native 13x21 (a pixel count that fills no tile), displacements within
    the radius and beyond it (the window drops corners in both versions);
    float32 to 1e-5, gradients to 1e-4 relative L2; bfloat16 to 3e-2 and
    3e-2; the grid gets no gradient; the wrapper refuses radius 7."""
    from flowmap_tpu_torch.ops.kernels import corr_weights as cw

    gen = torch.Generator(device=cuda).manual_seed(10)
    f, hn, wn = 3, 13, 21
    h, w = 2 * hn, 2 * wn
    ys, xs = (torch.arange(h, device=cuda) + 0.5) / h, (torch.arange(w, device=cuda) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    flow = (torch.rand((f - 1, h, w, 2), generator=gen, device=cuda) - 0.5) * 2
    flow = flow * torch.tensor([2.5 / w, max_dy / h], device=cuda)
    grid = ((torch.stack([gx, gy], -1) + flow) * 2 - 1).contiguous()
    for dtype, tol, tol_g in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 3e-2, 3e-2)):
        feats = torch.randn((f, hn, wn, 64), generator=gen, device=cuda).to(dtype)
        feats.requires_grad_(True)
        params = _mlp_params(cuda, dtype, gen, scale=3.0)
        g = torch.randn((f - 1, h, w), generator=gen, device=cuda)
        out_k = cw.corr_weights(feats, grid, *params, radius)
        out_p = cw.corr_weights_plain(feats, grid, *params, radius)
        assert out_k.shape == (f - 1, h, w) and out_k.dtype == torch.float32
        assert float((out_k - out_p).abs().max()) <= tol
        d_k = torch.autograd.grad(out_k, [feats, *params], g)
        d_p = torch.autograd.grad(out_p, [feats, *params], g)
        for a, b in zip(d_k, d_p):
            assert a.dtype == b.dtype and _rel_l2(a, b) <= tol_g
    t_grid = grid.clone().requires_grad_(True)
    out = cw.corr_weights(feats, t_grid, *params, radius)
    assert torch.autograd.grad(out.sum(), t_grid, allow_unused=True)[0] is None
    with pytest.raises(ValueError, match="radius"):
        cw.corr_weights(feats, grid, *params, 7)
