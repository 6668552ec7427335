"""The port's tracks and tracking loss vs the JAX package's.

The same arrays, made from a seed with numpy, go through both packages:
the synthetic track makers, the segment windows, `pack_tracks` and the npz
round trip (exact); the flow-chain tracker, the track reprojection and the
packed sampling (1e-5); and the plain version of the track-loss kernel
against the JAX package's XLA formulation, its Pallas kernels in interpret
mode (`pallas_mode("force")`) and the ragged-list route. The CUDA kernels
are held against that plain version on the card (`chip_smoke.py`,
`tests/test_torch_port_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from flowmap_tpu.loss.loss import LossTrackingCfg as JLossTrackingCfg
from flowmap_tpu.loss.loss import _track_loss_packed_fused as j_packed_fused
from flowmap_tpu.loss.loss import compute_losses as j_compute_losses
from flowmap_tpu.loss.loss import loss_tracking as j_loss_tracking
from flowmap_tpu.ops import surface as j_surface
from flowmap_tpu.ops.grid_sample import bilinear_onehot_weights as j_onehot
from flowmap_tpu.ops.pallas import track_loss as j_tl
from flowmap_tpu.ops.pallas.runtime import pallas_mode
from flowmap_tpu.tracking import tracker_flow_chain as j_chain
from flowmap_tpu.tracking import tracking as j_tracking
from flowmap_tpu.types import ModelOutput as JModelOutput
from flowmap_tpu.types import Tracks as JTracks
from flowmap_tpu.types import TracksPacked as JTracksPacked
from flowmap_tpu.utils import synthetic as j_synthetic
from flowmap_tpu_torch.loss.loss import LossTrackingCfg, compute_losses, loss_tracking
from flowmap_tpu_torch.loss.mapping import MappingCfg
from flowmap_tpu_torch.ops import surface as t_surface
from flowmap_tpu_torch.ops.grid_sample import bilinear_onehot_weights
from flowmap_tpu_torch.ops.kernels import track_loss as t_tl
from flowmap_tpu_torch.tracking import tracker_flow_chain as t_chain
from flowmap_tpu_torch.tracking import tracking as t_tracking
from flowmap_tpu_torch.types import ModelOutput
from flowmap_tpu_torch.utils import synthetic as t_synthetic
from flowmap_tpu_torch.utils.params import tracks_from_numpy, tracks_packed_from_numpy

torch.set_num_threads(1)

F, H, W = 10, 64, 96


def T(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def scenes():
    j = j_synthetic.make_scene(j_synthetic.SyntheticSceneCfg(num_frames=F, image_shape=(H, W)))
    t = t_synthetic.make_scene(
        t_synthetic.SyntheticSceneCfg(num_frames=F, image_shape=(H, W)), "cpu")
    return j, t


def _assert_segments_equal(t_segments, j_segments):
    assert len(t_segments) == len(j_segments)
    for a, b in zip(t_segments, j_segments):
        assert a.start_frame == b.start_frame
        np.testing.assert_array_equal(a.xy.numpy(), np.asarray(b.xy))
        np.testing.assert_array_equal(a.visibility.numpy(), np.asarray(b.visibility))


# ------------------------------------------------ track makers, windows, packing


@pytest.mark.parametrize("interval,radius,grid_size", [(2, 3, 5), (3, 2, 7), (5, 20, 6)])
def test_make_track_segments_equal(scenes, interval, radius, grid_size):
    (j_batch, _, j_depths), (batch, _, depths) = scenes
    _assert_segments_equal(
        t_synthetic.make_track_segments(batch, depths, interval, radius, grid_size),
        j_synthetic.make_track_segments(j_batch, j_depths, interval, radius, grid_size),
    )


def test_make_tracks_equal(scenes):
    (j_batch, _, j_depths), (batch, _, depths) = scenes
    _assert_segments_equal(
        t_synthetic.make_tracks(batch, depths, num_points=17, seed=3),
        j_synthetic.make_tracks(j_batch, j_depths, num_points=17, seed=3),
    )


@pytest.mark.parametrize("args", [(10, 2, 3), (150, 5, 20), (7, 3, 10), (1, 5, 20)])
def test_segment_windows_equal(args):
    assert t_tracking.segment_windows(*args) == j_tracking.segment_windows(*args)


@pytest.mark.parametrize("interval,radius", [(2, 3), (3, 2), (5, 20)])
def test_pack_tracks_equal(scenes, interval, radius):
    """Equal arrays, including segments whose start is clamped so that the
    common window still ends inside the video (the last ones here)."""
    (j_batch, _, j_depths), (batch, _, depths) = scenes
    j_packed = j_tracking.pack_tracks(
        j_synthetic.make_track_segments(j_batch, j_depths, interval, radius, 5), F)
    segments = t_synthetic.make_track_segments(batch, depths, interval, radius, 5)
    packed = t_tracking.pack_tracks(segments, F)
    np.testing.assert_array_equal(packed.xy.numpy(), np.asarray(j_packed.xy))
    np.testing.assert_array_equal(packed.visibility.numpy(), np.asarray(j_packed.visibility))
    np.testing.assert_array_equal(packed.starts.numpy(), np.asarray(j_packed.starts))
    assert packed.starts.dtype == torch.int32
    clamped = [s for s, t in zip(packed.starts.tolist(), segments) if s != t.start_frame]
    assert clamped or radius >= F
    length = packed.xy.shape[2]
    np.testing.assert_array_equal(
        packed.frame_index().numpy(), packed.starts.numpy()[:, None] + np.arange(length))
    assert int(packed.frame_index().max()) < F


def test_pack_tracks_refuses_an_empty_list():
    with pytest.raises(ValueError, match="empty"):
        t_tracking.pack_tracks([], 5)


def test_save_load_tracks_round_trip(scenes, tmp_path):
    """The port's npz is the JAX package's: each reads the other's file."""
    (j_batch, _, j_depths), (batch, _, depths) = scenes
    segments = t_synthetic.make_track_segments(batch, depths, 3, 2, 5)
    j_segments = j_synthetic.make_track_segments(j_batch, j_depths, 3, 2, 5)
    t_tracking.save_tracks(tmp_path / "t.npz", segments)
    j_tracking.save_tracks(tmp_path / "j.npz", j_segments)
    _assert_segments_equal(t_tracking.load_tracks(tmp_path / "t.npz"), j_segments)
    _assert_segments_equal(t_tracking.load_tracks(tmp_path / "j.npz"), j_segments)
    _assert_segments_equal(segments, j_tracking.load_tracks(tmp_path / "t.npz"))


def test_compute_tracks_precomputed_cache_and_cotracker(scenes, tmp_path):
    (_, _, _), (batch, flows, depths) = scenes
    segments = t_synthetic.make_track_segments(batch, depths, 3, 2, 5)
    t_tracking.save_tracks(tmp_path / "pre.npz", segments)
    loaded = t_tracking.compute_tracks(
        batch, t_tracking.TrackPredictorPrecomputedCfg(path=tmp_path / "pre.npz"),
        t_tracking.TrackPrecomputationCfg())
    _assert_segments_equal(loaded, segments)

    cfg = t_tracking.TrackPredictorFlowChainCfg(grid_size=4)
    pre = t_tracking.TrackPrecomputationCfg(interval=4, radius=2, cache_path=tmp_path / "cache")
    first = t_tracking.compute_tracks(batch, cfg, pre, flows)
    assert len(list((tmp_path / "cache").glob("*.npz"))) == 1
    again = t_tracking.compute_tracks(batch, cfg, pre, None)  # served from the cache
    _assert_segments_equal(again, first)
    with pytest.raises(ValueError, match="flows"):
        t_tracking.compute_tracks(batch, cfg, t_tracking.TrackPrecomputationCfg(), None)
    with pytest.raises(NotImplementedError, match="CoTracker"):
        t_tracking.compute_tracks(
            batch, t_tracking.TrackPredictorCoTrackerCfg(), t_tracking.TrackPrecomputationCfg())


def test_cache_key_equal(scenes):
    (j_batch, _, _), (batch, _, _) = scenes
    j_key = j_tracking.get_cache_key(
        j_chain.TrackPredictorFlowChainCfg(grid_size=9),
        j_tracking.TrackPrecomputationCfg(interval=4, radius=7), j_batch)
    t_key = t_tracking.get_cache_key(
        t_chain.TrackPredictorFlowChainCfg(grid_size=9),
        t_tracking.TrackPrecomputationCfg(interval=4, radius=7), batch)
    assert t_key == j_key


# --------------------------------------------------------------- flow-chain tracker


@pytest.mark.parametrize("interval,radius,grid_size", [(2, 3, 6), (4, 9, 5)])
def test_tracker_flow_chain(scenes, interval, radius, grid_size):
    """Positions within 1e-5, visibility equal, on the synthetic scene's flows."""
    (j_batch, j_flows, _), (batch, flows, _) = scenes
    j_segments = j_chain.generate_video_tracks_flow_chain(
        j_batch, j_flows, j_chain.TrackPredictorFlowChainCfg(grid_size=grid_size),
        interval, radius)
    segments = t_tracking.compute_tracks(
        batch, t_chain.TrackPredictorFlowChainCfg(grid_size=grid_size),
        t_tracking.TrackPrecomputationCfg(interval=interval, radius=radius), flows)
    assert len(segments) == len(j_segments)
    for a, b in zip(segments, j_segments):
        assert a.start_frame == b.start_frame and a.xy.shape == b.xy.shape
        np.testing.assert_allclose(a.xy.numpy(), np.asarray(b.xy), atol=1e-5)
        np.testing.assert_array_equal(a.visibility.numpy(), np.asarray(b.visibility))
        assert not a.xy.requires_grad


# ------------------------------------------- track reprojection and packed sampling


def _rotation(rng, scale=0.2):
    v = rng.normal(size=3) * scale
    return expm(np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64))


def _loss_scene(rng, f=12, h=24, w=32, s=3, l=7, p=13):
    """Random surfaces and cameras with packed tracks: points up to 5% outside
    the frame (border clamp; they fail the in-frame masks), 20% invisible, one
    all-invisible padding frame at xy 0.5 as `pack_tracks` makes them, and a
    source point whose projection into target 1 of segment 0 has a
    denominator z' + 1e-5 within 1e-4 of 0 (the nan/inf guards)."""
    surfaces = rng.normal(size=(1, f, h, w, 3)).astype(np.float32)
    surfaces[..., 2] += 4.0
    extrinsics = np.zeros((1, f, 4, 4), np.float32)
    for i in range(f):
        e = np.eye(4)
        e[:3, :3] = _rotation(rng)
        e[:3, 3] = rng.normal(size=3) * 0.3
        extrinsics[0, i] = e
    intrinsics = np.zeros((1, f, 3, 3), np.float32)
    intrinsics[0, :, 0, 0] = 1.2 + 0.1 * rng.normal(size=f)
    intrinsics[0, :, 1, 1] = 1.3 + 0.1 * rng.normal(size=f)
    intrinsics[0, :, :2, 2] = 0.5
    intrinsics[0, :, 2, 2] = 1.0
    starts = np.linspace(0, f - l, s).astype(np.int32)
    xy = rng.uniform(-0.05, 1.05, size=(1, s, l, p, 2)).astype(np.float32)
    vis = rng.uniform(size=(1, s, l, p)) > 0.2
    xy[0, 1, l - 1] = 0.5
    vis[0, 1, l - 1] = False
    # Put one texel of segment 0's first frame where target 1's camera sees
    # it at z' = -1e-5 (+- rounding), and sample it exactly (a pixel centre).
    rel = np.linalg.inv(extrinsics[0, starts[0] + 1].astype(np.float64)) @ extrinsics[
        0, starts[0]].astype(np.float64)
    point = np.array([0.3, -0.2, 0.0])
    point[2] = (-1e-5 - rel[2, 3] - rel[2, :2] @ point[:2]) / rel[2, 2]
    surfaces[0, starts[0], 5, 7] = point
    xy[0, 0, 0, 0] = [(7 + 0.5) / w, (5 + 0.5) / h]
    vis[0, 0, :2, 0] = True
    return surfaces, extrinsics, intrinsics, xy, vis, starts, (h, w)


def _both_packed(xy, vis, starts):
    return (JTracksPacked(xy=jnp.asarray(xy), visibility=jnp.asarray(vis),
                          starts=jnp.asarray(starts)),
            tracks_packed_from_numpy(xy, vis, starts))


def _j_output(s, e, k):
    return JModelOutput(depths=None, surfaces=s, intrinsics=k, extrinsics=e,
                        backward_correspondence_weights=None)


def _t_output(s, e, k):
    return ModelOutput(depths=None, surfaces=s, intrinsics=k, extrinsics=e,
                       backward_correspondence_weights=None)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_bilinear_onehot_weights(padding_mode):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2.0, 9.0, size=(3, 11)).astype(np.float32)
    got = bilinear_onehot_weights(T(coords), 8, padding_mode, torch.float32)
    want = j_onehot(jnp.asarray(coords), 8, padding_mode, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_compute_track_flow(scenes):
    """One ragged segment: reprojected locations 1e-5, masks equal."""
    rng = np.random.default_rng(1)
    surfaces, extrinsics, intrinsics, xy, vis, _, _ = _loss_scene(rng)
    seg_xy, seg_vis = xy[:, 0], vis[:, 0]
    f = seg_xy.shape[1]
    j_xy, j_vis = j_surface.compute_track_flow(
        surfaces[:, 2:2 + f], extrinsics[:, 2:2 + f], intrinsics[:, 2:2 + f],
        JTracks(xy=jnp.asarray(seg_xy), visibility=jnp.asarray(seg_vis), start_frame=2))
    t_xy, t_vis = t_surface.compute_track_flow(
        T(surfaces[:, 2:2 + f]), T(extrinsics[:, 2:2 + f]), T(intrinsics[:, 2:2 + f]),
        tracks_from_numpy(seg_xy, seg_vis, 2))
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))
    keep = np.asarray(j_vis)
    np.testing.assert_allclose(t_xy.numpy()[keep], np.asarray(j_xy)[keep], atol=1e-5)


def test_sample_track_points_packed_and_flow_packed():
    """Packed sampling 1e-5 (points outside the frame read the border); the
    packed reprojection 1e-5 where the mask holds, masks equal."""
    rng = np.random.default_rng(2)
    surfaces, extrinsics, intrinsics, xy, vis, starts, _ = _loss_scene(rng)
    j_packed, packed = _both_packed(xy, vis, starts)
    j_xyz, j_idx = j_surface.sample_track_points_packed(jnp.asarray(surfaces), j_packed)
    t_xyz, t_idx = t_surface.sample_track_points_packed(T(surfaces), packed)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_xyz.numpy(), np.asarray(j_xyz), atol=1e-5)
    j_xy, j_vis = j_surface.compute_track_flow_packed(
        jnp.asarray(surfaces), jnp.asarray(extrinsics), jnp.asarray(intrinsics), j_packed)
    t_xy, t_vis = t_surface.compute_track_flow_packed(
        T(surfaces), T(extrinsics), T(intrinsics), packed)
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))
    keep = np.asarray(j_vis)
    np.testing.assert_allclose(t_xy.numpy()[keep], np.asarray(j_xy)[keep], atol=1e-5)


# ----------------------------------------------------------------- D: track loss


@pytest.mark.parametrize("seed", [0, 1])
def test_track_loss_plain_vs_pallas_and_xla(seed):
    """Loss sums 2e-5 rel, valid counts equal, gradients to surfaces,
    extrinsics and intrinsics 2e-4 of each gradient's max (reassociated f32
    sums), against the XLA formulation and the Pallas kernels in interpret
    mode. The scene has points outside the frame, padding frames and a
    near-zero denominator; every gradient stays finite."""
    surfaces, extrinsics, intrinsics, xy, vis, starts, shape = _loss_scene(
        np.random.default_rng(seed))
    j_packed, packed = _both_packed(xy, vis, starts)

    def j_xla(s, e, k):
        return j_packed_fused(JLossTrackingCfg(), j_packed, _j_output(s, e, k), shape)

    def j_kernel(s, e, k):
        return j_tl.track_loss_pallas(s, e, k, j_packed, shape, 0.01)

    ts, te, tk = T(surfaces, True), T(extrinsics, True), T(intrinsics, True)
    t_sum, t_valid = t_tl.track_loss(ts, te, tk, packed, shape, 0.01)
    t_grads = torch.autograd.grad(t_sum, (ts, te, tk))
    assert all(torch.isfinite(g).all() for g in t_grads)
    assert float(t_valid) > 100
    for fn, mode in ((j_xla, "off"), (j_kernel, "force")):
        with pallas_mode(mode):
            (j_sum, j_valid), j_grads = jax.value_and_grad(
                lambda *a: fn(*a), (0, 1, 2), has_aux=True)(surfaces, extrinsics, intrinsics)
        assert float(t_valid) == float(j_valid)
        np.testing.assert_allclose(float(t_sum.detach()), float(j_sum), rtol=2e-5)
        for got, want in zip(t_grads, j_grads):
            assert rel(got, want) < 2e-4


def test_track_loss_guards_and_padding():
    """The near-zero denominator takes the clamp (its quotient is beyond
    +-1e8 or huge), fails the in-frame mask and adds nothing; with every
    point invisible the sums are exactly 0 and no gradient is NaN."""
    surfaces, extrinsics, intrinsics, xy, vis, starts, shape = _loss_scene(
        np.random.default_rng(0))
    _, packed = _both_packed(xy, vis, starts)
    xyz, frame_idx = t_surface.sample_track_points_packed(T(surfaces), packed)
    m = t_tl.fold_pair_projections(T(extrinsics)[0], T(intrinsics)[0], frame_idx)
    z = m[0, 0, 1, 2, :3] @ xyz[0, 0, 0] + m[0, 0, 1, 2, 3]
    assert abs(float(z) + 1e-5) < 1e-4

    _, dark = _both_packed(xy, np.zeros_like(vis), starts)
    ts, te, tk = T(surfaces, True), T(extrinsics, True), T(intrinsics, True)
    t_sum, t_valid = t_tl.track_loss(ts, te, tk, dark, shape, 0.01)
    assert float(t_sum.detach()) == 0.0 and float(t_valid) == 0.0
    for g in torch.autograd.grad(t_sum, (ts, te, tk)):
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("mapping", ["huber", "l1", "l2"])
def test_loss_tracking_routes_agree(scenes, mapping):
    """The ragged segment list, the packed form through `track_loss` (huber)
    or the plain packed form (l1, l2), and the JAX package on both: the loss
    within 2e-5 rel, the gradients within 2e-4 of max (l1: 2e-3; a pair of a
    frame with itself has a residual of rounding noise, and l1's gradient is
    that residual's direction)."""
    from flowmap_tpu.loss.mapping import MappingCfg as JMappingCfg

    (j_batch, _, j_depths), (batch, _, depths) = scenes
    rng = np.random.default_rng(4)
    j_segments = j_synthetic.make_track_segments(j_batch, j_depths, 3, 2, 6)
    segments = t_synthetic.make_track_segments(batch, depths, 3, 2, 6)
    packed = t_tracking.pack_tracks(segments, F)
    j_packed = j_tracking.pack_tracks(j_segments, F)

    xy, _ = (np.stack(np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H,
                                  indexing="xy"), -1), None)
    k = np.asarray(j_batch.intrinsics)
    d = np.asarray(j_depths) * (1 + 0.05 * rng.standard_normal(np.shape(j_depths)))
    rays = np.stack([(xy[..., 0] - 0.5) / k[0, 0, 0, 0], (xy[..., 1] - 0.5) / k[0, 0, 1, 1],
                     np.ones((H, W))], -1)
    surfaces = (rays[None, None] * d[..., None]).astype(np.float32)
    extrinsics = np.asarray(j_batch.extrinsics).copy()
    extrinsics[..., :3, 3] += 0.01 * rng.standard_normal(extrinsics[..., :3, 3].shape)

    j_cfg = JLossTrackingCfg(mapping=JMappingCfg(name=mapping))
    cfg = LossTrackingCfg(mapping=MappingCfg(name=mapping))

    def j_fn(tracks):
        return jax.value_and_grad(
            lambda s, e, kk: j_loss_tracking(j_cfg, tracks, _j_output(s, e, kk), (H, W)),
            (0, 1, 2))(surfaces, extrinsics, k)

    with pallas_mode("off"):
        j_ragged, j_ragged_grads = j_fn(j_segments)
        j_pack, j_pack_grads = j_fn(j_packed)
    np.testing.assert_allclose(float(j_pack), float(j_ragged), rtol=2e-5)
    # The packed form folds the whole of K into M, so K's constant bottom row
    # gets a gradient there and none in the ragged form: each route is held
    # against its own counterpart.
    for tracks, j_grads in ((segments, j_ragged_grads), (packed, j_pack_grads)):
        ts, te, tk = T(surfaces, True), T(extrinsics, True), T(k, True)
        loss = loss_tracking(cfg, tracks, _t_output(ts, te, tk), (H, W))
        assert float(loss) > 0
        np.testing.assert_allclose(float(loss), float(j_ragged), rtol=2e-5)
        for got, want in zip(torch.autograd.grad(loss, (ts, te, tk)), j_grads):
            assert rel(got, want) < (2e-3 if mapping == "l1" else 2e-4)


def test_compute_losses_with_tracking(scenes):
    """The gate, the weight, the empty list and the missing tracks, as the
    JAX package's `compute_losses` has them."""
    (j_batch, j_flows, j_depths), (batch, flows, depths) = scenes
    j_segments = j_synthetic.make_track_segments(j_batch, j_depths, 3, 2, 5)
    packed = t_tracking.pack_tracks(t_synthetic.make_track_segments(batch, depths, 3, 2, 5), F)
    xy = np.stack(np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H,
                              indexing="xy"), -1)
    k = np.asarray(j_batch.intrinsics)
    rays = np.stack([(xy[..., 0] - 0.5) / k[0, 0, 0, 0], (xy[..., 1] - 0.5) / k[0, 0, 1, 1],
                     np.ones((H, W))], -1)
    surfaces = (rays[None, None] * (np.asarray(j_depths) * 1.03)[..., None]).astype(np.float32)
    j_out = _j_output(jnp.asarray(surfaces), j_batch.extrinsics, j_batch.intrinsics)
    t_out = _t_output(T(surfaces), batch.extrinsics, batch.intrinsics)
    for step in (0, 49, 50):
        with pallas_mode("off"):
            j_total, j_each = j_compute_losses(
                [JLossTrackingCfg()], j_flows, j_segments, j_out, step, (H, W))
        total, each = compute_losses([LossTrackingCfg()], flows, packed, t_out, step, (H, W))
        np.testing.assert_allclose(float(total), float(j_total), rtol=2e-5)
        np.testing.assert_allclose(float(each["tracking"]), float(j_each["tracking"]), rtol=2e-5)
        assert (float(total) > 0) == (step >= 50)
    total, each = compute_losses([LossTrackingCfg(enable_after=0)], flows, [], t_out, 0, (H, W))
    assert float(total) == 0.0 and each == {}
    with pytest.raises(ValueError, match="requires tracks"):
        compute_losses([LossTrackingCfg()], flows, None, t_out, 0, (H, W))
    with pytest.raises(ValueError, match="unknown loss cfg"):
        compute_losses([object()], flows, None, t_out, 0, (H, W))


def test_track_loss_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper launches or raises: its checks come
    before any launch, so they can be driven here by a tensor that only
    claims to be on the card."""
    surfaces, extrinsics, intrinsics, xy, vis, starts, shape = _loss_scene(
        np.random.default_rng(0))
    _, packed = _both_packed(xy, vis, starts)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="model resolution"):
        t_tl.track_loss(T(surfaces), T(extrinsics), T(intrinsics), packed, (8, 8), 0.01)
    with pytest.raises(ValueError, match="float32"):
        t_tl.track_loss(T(surfaces).double(), T(extrinsics), T(intrinsics), packed, shape, 0.01)
