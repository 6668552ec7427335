"""The flow precompute: the port's modules vs the JAX package's, on the CPU.

The dense warp's plain version is held against the Pallas kernel it replaces
(interpret mode, `pallas_mode("force")`), the JAX package's flat-take form
(`"off"`) and both packages' `grid_sample_2d`; the consistency mask, the
rescaling and the bidirectional compute against `flowmap_tpu.flow.common`;
the cropping against `flowmap_tpu.utils.cropping`; and the precompute as a whole,
`compute_flows` of both packages on one video with the same GMFlow weights
(one `.npz`, read by both `load_params`). float32; 2e-5 unless stated. The
CUDA kernel is held against the plain version on the card (`chip_smoke.py`,
`tests/test_torch_port_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.flow import common as j_common
from flowmap_tpu.flow import predictors as j_pred
from flowmap_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from flowmap_tpu.ops.pallas import dense_warp as j_dw
from flowmap_tpu.ops.pallas.runtime import pallas_mode
from flowmap_tpu.types import Batch as JBatch
from flowmap_tpu.utils import cropping as j_crop
from flowmap_tpu_torch.flow import common as t_common
from flowmap_tpu_torch.flow import predictors as t_pred
from flowmap_tpu_torch.ops.grid_sample import grid_sample_2d
from flowmap_tpu_torch.ops.kernels import dense_warp as t_dw
from flowmap_tpu_torch.types import Batch, Flows
from flowmap_tpu_torch.utils import cropping as t_crop

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 3, 24, 40), (1, 3, 17, 29)])
def test_plain_dense_warp_matches_jax(shape, padding_mode):
    """Coordinates far outside the image included."""
    n, c, h, w = shape
    rng = np.random.default_rng(0)
    img = rng.uniform(size=shape).astype(np.float32)
    grid = rng.uniform(-1.8, 1.8, size=(n, h, w, 2)).astype(np.float32)
    pixel_xy = ((grid + 1.0) * np.array([w, h], np.float32) - 1.0) * 0.5
    got = t_dw.dense_warp_bilinear(T(img), T(pixel_xy), padding_mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    for mode in ("force", "off"):
        with pallas_mode(mode):
            _close(got, j_dw.dense_warp_bilinear(jnp.asarray(img), jnp.asarray(pixel_xy), padding_mode))
    _close(got, j_grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode))
    _close(got, grid_sample_2d(T(img), T(grid), padding_mode))
    planar = t_dw.dense_warp_bilinear_planar(
        T(img), T(pixel_xy[..., 0]), T(pixel_xy[..., 1]), padding_mode)
    assert torch.equal(planar, got)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_plain_dense_warp_bfloat16_and_far_coordinates(padding_mode):
    """bfloat16 rounds the image and the x weights as the Pallas kernel does
    (its products are exact in float32, so 2e-5 holds there too), and
    coordinates of any size give finite values."""
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(2, 3, 17, 29)).astype(np.float32)
    xy = rng.uniform(-20, 50, size=(2, 17, 29, 2)).astype(np.float32)
    got = t_dw.dense_warp_bilinear(T(img), T(xy), padding_mode, torch.bfloat16)
    with pallas_mode("force"):
        want = j_dw.dense_warp_bilinear(jnp.asarray(img), jnp.asarray(xy), padding_mode, jnp.bfloat16)
    _close(got, want)
    far = t_dw.dense_warp_bilinear(T(img), T(xy) * 1e30, padding_mode)
    assert bool(torch.isfinite(far).all())
    if padding_mode == "zeros":
        assert float(far.abs().max()) == 0.0
    with pytest.raises(ValueError, match="padding_mode"):
        t_dw.dense_warp_bilinear(T(img), T(xy), "reflection")


def test_dense_warp_backward_raises():
    img = torch.ones((1, 3, 8, 8), requires_grad=True)
    xy = torch.full((1, 8, 8, 2), 3.0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        t_dw.dense_warp_bilinear(img, xy).sum().backward()


def test_consistency_mask_matches_jax():
    rng = np.random.default_rng(2)
    videos = rng.uniform(size=(1, 4, 3, 24, 32)).astype(np.float32)
    flow = rng.normal(scale=0.15, size=(1, 3, 24, 32, 2)).astype(np.float32)
    got = t_common.compute_consistency_mask(T(videos), T(flow))
    for mode in ("force", "off"):
        with pallas_mode(mode):
            _close(got, j_common.compute_consistency_mask(jnp.asarray(videos), jnp.asarray(flow)))
    assert tuple(got.shape) == (1, 3, 24, 32)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("src,dst", [((32, 48), (8, 12)), ((8, 12), (32, 48)), ((24, 32), (12, 20))])
def test_rescale_matches_jax(src, dst):
    """Shrinking by 4 (the precompute's case: no antialiasing), growing by 4,
    and a ratio that is no integer."""
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(1, 3, *src, 2)).astype(np.float32)
    mask = rng.uniform(size=(1, 3, *src)).astype(np.float32)
    _close(t_common.rescale_flow(T(flow), dst), j_common.rescale_flow(jnp.asarray(flow), dst))
    _close(t_common.rescale_mask(T(mask), dst), j_common.rescale_mask(jnp.asarray(mask), dst))


def test_bidirectional_flow_matches_jax():
    """A stand-in predictor (frame differences), so that only the time
    reversal, the masks and the rescaling are compared."""
    rng = np.random.default_rng(4)
    videos = rng.uniform(size=(1, 5, 3, 16, 24)).astype(np.float32)

    def predict(v):
        delta = v[:, 1:, :2] - v[:, :-1, :2]  # (b, f - 1, 2, h, w)
        return 0.2 * (delta.permute(0, 1, 3, 4, 2) if isinstance(v, torch.Tensor)
                      else jnp.transpose(delta, (0, 1, 3, 4, 2)))

    indices = np.arange(5)[None]
    got = t_common.compute_bidirectional_flow(
        predict, Batch(videos=T(videos), indices=torch.as_tensor(indices)), (8, 12))
    want = j_common.compute_bidirectional_flow(
        predict, JBatch(videos=jnp.asarray(videos), indices=jnp.asarray(indices)), (8, 12))
    for name in ("forward", "backward", "forward_mask", "backward_mask"):
        _close(getattr(got, name), getattr(want, name))
    assert tuple(got.backward.shape) == (1, 4, 8, 12, 2)


def test_compute_flows_matches_jax(tmp_path):
    """The precompute as a whole: a 5-frame 64x96 video, GMFlow in chunks of 2
    pairs (the last one ragged here, padded there), masks, rescaling to
    (32, 48). Flows are normalised, so 5e-3 px is 5e-5 of the width; masks
    within 1e-3 (the eighth power of a colour difference through a sample
    displaced by the flow's own error)."""
    from flowmap_tpu.flow import gmflow as j_gm

    params = j_gm.init_params(jax.random.PRNGKey(1))
    path = tmp_path / "gmflow.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    rng = np.random.default_rng(5)
    # A smooth video (two waves per frame and channel): the mask compares
    # colours at flow-displaced positions, and on white noise it would
    # magnify the flows' rounding differences by the image gradient.
    yy, xx = np.meshgrid(np.arange(64) / 64, np.arange(96) / 96, indexing="ij")
    freq = rng.uniform(-2, 2, size=(5, 3, 2, 1, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(5, 3, 1, 1))
    videos = 0.5 + 0.25 * np.sin(2 * np.pi * (freq[:, :, 0] * xx + freq[:, :, 1] * yy) + phase)
    videos = videos[None].astype(np.float32)
    indices = np.arange(5)[None]
    got = t_pred.compute_flows(
        Batch(videos=T(videos), indices=torch.as_tensor(indices)), (32, 48),
        t_pred.FlowPredictorGMFlowCfg(checkpoint=path, max_batch_size=2))
    want = j_pred.compute_flows(
        JBatch(videos=jnp.asarray(videos), indices=jnp.asarray(indices)), (32, 48),
        j_pred.FlowPredictorGMFlowCfg(checkpoint=path, max_batch_size=2))
    assert tuple(got.forward.shape) == (1, 4, 32, 48, 2)
    assert float(np.abs(np.asarray(want.forward)).max()) * 96 > 0.5  # the flows are not trivial
    for name in ("forward", "backward"):
        _close(getattr(got, name), getattr(want, name), tol=5e-5)
    for name in ("forward_mask", "backward_mask"):
        _close(getattr(got, name), getattr(want, name), tol=1e-3)


def test_precomputed_flows_round_trip_and_raft_raises(tmp_path):
    rng = np.random.default_rng(6)
    flows = Flows(
        forward=T(rng.normal(size=(1, 2, 16, 24, 2))), backward=T(rng.normal(size=(1, 2, 16, 24, 2))),
        forward_mask=T(rng.uniform(size=(1, 2, 16, 24))), backward_mask=T(rng.uniform(size=(1, 2, 16, 24))),
    )
    t_pred.save_flows(tmp_path / "flows.npz", flows)
    batch = Batch(videos=torch.zeros((1, 3, 3, 16, 24)), indices=torch.arange(3)[None])
    same = t_pred.compute_flows(batch, (16, 24), t_pred.FlowPredictorPrecomputedCfg(path=tmp_path / "flows.npz"))
    assert torch.equal(same.forward, flows.forward) and torch.equal(same.backward_mask, flows.backward_mask)
    small = t_pred.load_precomputed_flows(tmp_path / "flows.npz", (8, 12))
    want = j_pred.load_precomputed_flows(tmp_path / "flows.npz", (8, 12))
    _close(small.forward, want.forward)
    _close(small.backward_mask, want.backward_mask)
    with pytest.raises(NotImplementedError, match="RAFT"):
        t_pred.compute_flows(batch, (16, 24), t_pred.FlowPredictorRaftCfg())


@pytest.mark.parametrize("source", [(50, 70), (64, 96)])
def test_cropping_matches_jax(source):
    """The product's configuration (a pixel budget) and an exact shape."""
    rng = np.random.default_rng(7)
    videos = rng.uniform(size=(1, 3, 3, *source)).astype(np.float32)
    k = np.broadcast_to(np.array([[1.1, 0, 0.5], [0, 1.3, 0.5], [0, 0, 1]], np.float32), (1, 3, 3, 3))
    indices = np.arange(3)[None]
    t_batch = Batch(videos=T(videos), indices=torch.as_tensor(indices), intrinsics=T(k))
    j_batch = JBatch(videos=jnp.asarray(videos), indices=jnp.asarray(indices), intrinsics=jnp.asarray(k))
    for image_shape in (600, (24, 40)):
        t_cfg = t_crop.CroppingCfg(image_shape=image_shape, flow_scale_multiplier=2, patch_size=8)
        j_cfg = j_crop.CroppingCfg(image_shape=image_shape, flow_scale_multiplier=2, patch_size=8)
        assert t_crop.get_image_shape(source, t_cfg) == j_crop.get_image_shape(source, j_cfg)
        (got, got_pre), (want, want_pre) = (
            t_crop.crop_and_resize_batch_for_model(t_batch, t_cfg),
            j_crop.crop_and_resize_batch_for_model(j_batch, j_cfg),
        )
        assert got_pre == want_pre and tuple(got.videos.shape) == tuple(want.videos.shape)
        _close(got.videos, want.videos)
        _close(got.intrinsics, want.intrinsics)
        got_f = t_crop.crop_and_resize_batch_for_flow(t_batch, t_cfg)
        want_f = j_crop.crop_and_resize_batch_for_flow(j_batch, j_cfg)
        assert tuple(got_f.videos.shape) == tuple(want_f.videos.shape)
        _close(got_f.videos, want_f.videos)
        _close(got_f.intrinsics, want_f.intrinsics)
    assert t_crop.compute_patch_cropped_shape((175, 246), 32) == (160, 224)
    assert t_crop.center_crop_intrinsics(None, (4, 4), (2, 2)) is None


def test_flagship_precompute_shapes():
    """The chain `chip_smoke.py` drives at full size, here at 4 frames of
    64x96: the two crops, GMFlow flows, flow-chained packed tracks."""
    from flowmap_tpu_torch.tracking import TrackPrecomputationCfg, TrackPredictorFlowChainCfg
    from flowmap_tpu_torch.training import flagship

    video = flagship.source_video("cpu", num_frames=4, image_shape=(64, 96))
    assert tuple(video.videos.shape) == (1, 4, 3, 64, 96)
    batch, flows, tracks = flagship.precompute(
        video, t_crop.CroppingCfg(image_shape=(16, 24), flow_scale_multiplier=4, patch_size=8),
        t_pred.FlowPredictorGMFlowCfg(max_batch_size=2), TrackPredictorFlowChainCfg(grid_size=3),
        TrackPrecomputationCfg(interval=2, radius=1))
    assert tuple(batch.videos.shape) == (1, 4, 3, 16, 24)
    assert tuple(flows.forward.shape) == (1, 3, 16, 24, 2) == tuple(flows.backward.shape)
    assert tuple(flows.forward_mask.shape) == (1, 3, 16, 24)
    assert all(bool(torch.isfinite(getattr(flows, n)).all())
               for n in ("forward", "backward", "forward_mask", "backward_mask"))
    assert 0.0 <= float(flows.forward_mask.min()) and float(flows.forward_mask.max()) <= 1.0
    assert tuple(tracks.xy.shape) == (1, 2, 3, 9, 2)
    assert flagship.CroppingCfg() == t_crop.CroppingCfg(43200, 4, 32)
