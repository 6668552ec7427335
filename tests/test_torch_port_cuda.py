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
