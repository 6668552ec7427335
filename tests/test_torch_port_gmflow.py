"""GMFlow and its softmax-expectation kernel's plain version vs the JAX package.

The same NumPy inputs and the same weights (the JAX package's
`init_params`, carried across by `gmflow_state_dict_from_jax`) go through
`flowmap_tpu.flow.gmflow` and `flowmap_tpu_torch.flow.gmflow` on the CPU,
float32. On the CPU the port's `softmax_expectation` runs its plain version;
the JAX one runs its Pallas kernel in interpret mode (`pallas_mode("force")`)
or its jnp form (`"off"`). The CUDA kernel is held against the plain version
on the card (`chip_smoke.py`, `tests/test_torch_port_cuda.py`).

Tolerances: the expectation 1e-4 (rtol and atol, as the JAX package's own
kernel tests); the network's stages 1e-4 of each one's largest value; the
whole network atol 5e-3 px and rtol 1e-3, the JAX package's own tolerance
against the original PyTorch GMFlow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.flow import gmflow as j_gm
from flowmap_tpu.ops.pallas import correlation as j_corr
from flowmap_tpu.ops.pallas.runtime import pallas_mode
from flowmap_tpu_torch.flow import gmflow as t_gm
from flowmap_tpu_torch.ops.kernels import correlation as t_corr
from flowmap_tpu_torch.utils.params import gmflow_state_dict_from_jax

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's model holding the same weights)."""
    params = j_gm.init_params(jax.random.PRNGKey(0))
    model = t_gm.GMFlow().eval().requires_grad_(False)
    model.load_state_dict(gmflow_state_dict_from_jax(params))
    return params, model


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 255, size=(1, 3, *shape)).astype(np.float32)
    return img0, np.roll(img0, 2, axis=3)


@pytest.mark.parametrize("mode", ["force", "off"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("length,d", [(64, 2), (64, 8), (300, 2), (300, 8)])
def test_plain_softmax_expectation_matches_jax(length, d, with_bias, mode):
    rng = np.random.default_rng(length + d)
    f0, f1 = (rng.normal(size=(2, length, 16)).astype(np.float32) for _ in range(2))
    values = rng.uniform(0, 50, size=(2, length, d)).astype(np.float32)
    bias = None
    if with_bias:
        bias = np.where(rng.random((2, length, length)) < 0.3, -100.0, 0.0).astype(np.float32)
    with pallas_mode(mode):
        want = j_corr.softmax_expectation(
            jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(values),
            bias=None if bias is None else jnp.asarray(bias),
        )
    got = t_corr.softmax_expectation(T(f0), T(f1), T(values), None if bias is None else T(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_plain_softmax_expectation_grouped_bias_and_chunks():
    """A (g, l, l) bias is the (b, l, l) bias tiled to the batch, and the
    query-chunked form above l = 4096 is the unchunked one."""
    rng = np.random.default_rng(7)
    f0, f1 = (T(rng.normal(size=(6, 40, 16))) for _ in range(2))
    values = T(rng.normal(size=(6, 40, 8)))
    bias = T(np.where(rng.random((3, 40, 40)) < 0.3, -100.0, 0.0))
    got = t_corr.softmax_expectation(f0, f1, values, bias)
    want = t_corr.softmax_expectation(f0, f1, values, bias.repeat(2, 1, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="dividing"):
        t_corr.softmax_expectation(f0, f1, values, bias[:2].repeat(2, 1, 1))

    g0, g1 = (T(rng.normal(size=(1, 4200, 8))) for _ in range(2))
    grid = T(rng.uniform(0, 64, size=(4200, 2)))
    chunked = t_corr.global_correlation_expectation(g0, g1, grid)
    whole = torch.softmax(g0 @ g1.transpose(1, 2) / 8**0.5, dim=-1) @ grid
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-4, atol=1e-4)


def test_state_dict_names_and_layout(weights):
    """The module's state dict has exactly the JAX package's parameter names
    (those of the public checkpoint), in PyTorch's layout, and the JAX
    package's converter maps it back."""
    params, model = weights
    state = model.state_dict()
    assert set(state) == set(j_gm._param_spec())
    assert state["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert state["transformer.layers.0.cross_attn_ffn.mlp.0.weight"].shape == (1024, 256)
    back = j_gm.convert_torch_state_dict(state)
    for name, value in params.items():
        np.testing.assert_array_equal(np.asarray(back[name]), np.asarray(value))


def test_encoder_matches_jax(weights):
    params, model = weights
    img0, img1 = _images(0, (32, 48))
    mean, std = j_gm._IMAGENET_MEAN * 255.0, j_gm._IMAGENET_STD * 255.0
    x = (np.concatenate([img0, img1]).transpose(0, 2, 3, 1) - mean) / std
    want = np.asarray(j_gm._encoder(params, jnp.asarray(x, jnp.float32)))
    f0, f1 = model.features(T(img0), T(img1))
    got = torch.cat([f0, f1]).numpy()
    assert got.shape == want.shape == (2, 4, 6, 128)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_position_and_shift_mask_match_jax():
    np.testing.assert_array_equal(
        t_gm.position_embedding_sine(5, 7, 64), j_gm._position_embedding_sine(5, 7, 64))
    np.testing.assert_array_equal(
        t_gm.shift_window_attn_mask(8, 12, 2), j_gm._shift_window_attn_mask(8, 12, 2))
    rng = np.random.default_rng(1)
    f0, f1 = (rng.normal(size=(2, 8, 12, 128)).astype(np.float32) for _ in range(2))
    want = j_gm._feature_add_position(jnp.asarray(f0), jnp.asarray(f1), 2)
    got = t_gm._feature_add_position(T(f0), T(f1), 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("mode", ["force", "off"])
@pytest.mark.parametrize("layer", [0, 1])
def test_transformer_block_matches_jax(weights, layer, mode):
    """One self + cross block on an 8x12 grid (2x2 windows of 4x6, so every
    window has several rows): layer 0 unshifted, layer 1 shifted with the
    mask as the kernel's grouped bias."""
    params, model = weights
    rng = np.random.default_rng(2 + layer)
    b, h, w, c = 2, 8, 12, 128
    source, target = (rng.normal(size=(b, h * w, c)).astype(np.float32) for _ in range(2))
    mask = j_gm._shift_window_attn_mask(h, w, 2)
    shift = layer % 2 == 1
    prefix = f"transformer.layers.{layer}"
    with pallas_mode(mode):
        mid = j_gm._transformer_layer(
            params, f"{prefix}.self_attn", jnp.asarray(source), jnp.asarray(source), h, w, 2,
            shift, jnp.asarray(mask), no_ffn=True)
        want = np.asarray(j_gm._transformer_layer(
            params, f"{prefix}.cross_attn_ffn", mid, jnp.asarray(target), h, w, 2,
            shift, jnp.asarray(mask), no_ffn=False))
    with torch.no_grad():
        got = model.transformer.layers[layer](
            T(source), T(target), h, w, 2, T(mask) if shift else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_propagation_and_upsampler_match_jax(weights):
    params, model = weights
    rng = np.random.default_rng(4)
    feature = rng.normal(size=(2, 4, 6, 128)).astype(np.float32)
    flow = rng.normal(scale=2.0, size=(2, 4, 6, 2)).astype(np.float32)
    want_p = np.asarray(j_gm._flow_propagation(params, jnp.asarray(feature), jnp.asarray(flow)))
    want_u = np.asarray(j_gm._upsample_flow_convex(params, jnp.asarray(flow), jnp.asarray(feature)))
    want_c = np.asarray(j_gm.global_correlation_softmax(jnp.asarray(feature), jnp.asarray(feature[::-1])))
    with torch.no_grad():
        got_p = model.feature_flow_attn(T(feature), T(flow)).numpy()
        got_u = t_gm.upsample_flow_convex(model.upsampler, T(flow), T(feature)).numpy()
        got_c = t_gm.global_correlation_softmax(T(feature), T(feature[::-1].copy())).numpy()
    assert got_u.shape == want_u.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got_p, want_p, atol=1e-4 * np.abs(want_p).max())
    np.testing.assert_allclose(got_u, want_u, atol=1e-4 * np.abs(want_u).max())
    np.testing.assert_allclose(got_c, want_c, atol=1e-4)


@pytest.mark.parametrize("shape", [(32, 48), (64, 96)])
def test_gmflow_matches_jax(weights, shape):
    params, model = weights
    img0, img1 = _images(5, shape)
    want = np.asarray(j_gm.gmflow_forward(params, jnp.asarray(img0), jnp.asarray(img1)))
    with torch.no_grad():
        got = model(T(img0), T(img1))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, *shape, 2)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=1e-3)


def test_gmflow_bfloat16_runs_and_stays_near_float32(weights):
    """The bfloat16 net (parameters cast, activations rounded) returns a
    finite float32 flow near the float32 net's on a 32x48 pair: with random
    weights single pixels move by a few pixels, the mean by a fraction of
    one (flows up to ~10 px)."""
    _, model = weights
    img0, img1 = _images(6, (32, 48))
    half = t_gm.GMFlow().eval().requires_grad_(False)
    half.load_state_dict(model.state_dict())
    half = half.to(torch.bfloat16)
    assert half.compute_dtype == torch.bfloat16
    with torch.no_grad():
        want, got = model(T(img0), T(img1)), half(T(img0), T(img1))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().mean()) < 1.0


def test_load_params_round_trip(weights, tmp_path):
    """`.npz` (JAX layout) -> the port's state dict -> `.pth` -> the port's
    and the JAX package's loaders: the same weights everywhere."""
    params, model = weights
    np.savez(tmp_path / "gmflow.npz", **{k: np.asarray(v) for k, v in params.items()})
    from_npz = t_gm.load_params(tmp_path / "gmflow.npz")
    for name, value in model.state_dict().items():
        assert torch.equal(from_npz[name], value), name
    # The public checkpoint keeps its weights under "model".
    torch.save({"model": from_npz}, tmp_path / "gmflow.pth")
    from_pth = t_gm.load_params(tmp_path / "gmflow.pth")
    assert set(from_pth) == set(from_npz)
    assert all(torch.equal(from_pth[k], from_npz[k]) for k in from_npz)
    back = j_gm.load_params(tmp_path / "gmflow.pth")
    for name, value in params.items():
        np.testing.assert_array_equal(np.asarray(back[name]), np.asarray(value))


def test_predictor_chunks_and_random_init():
    """A ragged last chunk gives the flows of one whole batch; random weights
    come from the seed; the predictor's net is frozen."""
    from flowmap_tpu_torch.flow.predictors import FlowPredictorGMFlowCfg

    rng = np.random.default_rng(8)
    videos = T(rng.uniform(size=(1, 4, 3, 32, 48)))
    whole = t_gm.GMFlowPredictor(FlowPredictorGMFlowCfg(max_batch_size=8), "cpu", seed=3)
    ragged = t_gm.GMFlowPredictor(FlowPredictorGMFlowCfg(max_batch_size=2), "cpu", seed=3)
    other = t_gm.GMFlowPredictor(FlowPredictorGMFlowCfg(), "cpu", seed=4)
    assert not any(p.requires_grad for p in whole.model.parameters())
    a, b, c = whole(videos), ragged(videos), other(videos)
    assert a.shape == (1, 3, 32, 48, 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert float((a - c).abs().max()) > 1e-4
