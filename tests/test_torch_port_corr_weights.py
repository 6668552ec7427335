"""Full-resolution correspondence weights (kernel H) of the port vs
flowmap_tpu (CPU).

The port's plain version (`ops/kernels/corr_weights.py:corr_weights_plain`)
against the JAX package's `corr_weights_ref`, the XLA composition that
`corr_weights` runs off the TPU and that `tests/test_corr_weights.py` holds
the Pallas kernel to (its interpret mode is not rerun here). Inputs and MLP
parameters come from NumPy and go through both; the port takes the MLP as
three `nn.Linear` layers. Tolerances are the JAX package's: forward 2e-5,
gradients 5e-4 absolute and 1e-3 relative, bf16 0.03.

Beyond the radius the two differ by design: the JAX oracle warps through
`warp_bilinear_matmul`, which clamps a far corner to the window's edge, and
the port drops it, as kernel E and its plain version do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import flowmap_tpu.ops.pallas.corr_weights as jcw
from flowmap_tpu_torch.ops.kernels import corr_weights as tcw

torch.set_num_threads(1)


def _scene(rng, f, hn, wn, max_disp_px=2.5):
    h, w = 2 * hn, 2 * wn
    feats = rng.normal(size=(f, hn, wn, 64)).astype(np.float32)
    xs = (np.arange(w) + 0.5) / w
    ys = (np.arange(h) + 0.5) / h
    base = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)[None]
    flow = (rng.uniform(size=(f - 1, h, w, 2)) - 0.5) * 2 * max_disp_px / np.asarray([w, h])
    return feats, ((base + flow) * 2 - 1).astype(np.float32)


def _mlp(rng):
    def lin(din, dout):
        return {"kernel": rng.normal(size=(din, dout)).astype(np.float32) / din**0.5,
                "bias": rng.normal(size=(dout,)).astype(np.float32) * 0.1}

    return [lin(128, 128), lin(128, 64), lin(64, 1)]


def _layers(mlp):
    layers = nn.ModuleList()
    for layer in mlp:
        din, dout = layer["kernel"].shape
        lin = nn.Linear(din, dout)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor(layer["kernel"].T))
            lin.bias.copy_(torch.tensor(layer["bias"]))
        layers.append(lin)
    return layers


def _port(feats, grid, layers, radius, dtype=torch.float32):
    return tcw.corr_weights(torch.tensor(feats).to(dtype), torch.tensor(grid),
                            *tcw.prepare_params(layers, dtype), radius)


def _jax(feats, grid, mlp, radius, dtype=jnp.float32):
    mlp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), mlp)
    return np.asarray(jcw.corr_weights_ref(jnp.asarray(feats, dtype), jnp.asarray(grid), mlp,
                                           radius))


@pytest.mark.parametrize("shape,disp,radius", [((3, 16, 24), 2.5, 3), ((2, 16, 24), 4.5, 5)])
def test_plain_forward_matches_oracle(shape, disp, radius):
    """Displacements within the radius; the second case also pushes the top
    rows' samples off the image (zeros padding)."""
    rng = np.random.default_rng(0)
    feats, grid = _scene(rng, *shape, max_disp_px=disp)
    if shape[0] == 2:
        grid[:, :4, :, 1] -= 0.5
    mlp = _mlp(rng)
    got = _port(feats, grid, _layers(mlp), radius)
    want = _jax(feats, grid, mlp, radius)
    assert got.shape == want.shape == (shape[0] - 1, 32, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)


def test_plain_gradients_match_oracle():
    rng = np.random.default_rng(4)
    feats, grid = _scene(rng, 3, 16, 24)
    mlp = _mlp(rng)

    def j_loss(f, m):
        return jnp.sum(jcw.corr_weights_ref(f, jnp.asarray(grid), m, 3) ** 2)

    j_feats, j_mlp = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(feats), mlp)
    layers = _layers(mlp)
    t_feats = torch.tensor(feats, requires_grad=True)
    out = tcw.corr_weights(t_feats, torch.tensor(grid), *tcw.prepare_params(layers, torch.float32), 3)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(t_feats.grad.numpy(), np.asarray(j_feats), atol=5e-4)
    for lin, j_layer in zip(layers, j_mlp):
        np.testing.assert_allclose(lin.weight.grad.numpy(), np.asarray(j_layer["kernel"]).T,
                                   atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(j_layer["bias"]),
                                   atol=5e-4, rtol=1e-3)


def test_grid_cotangent_is_zero():
    rng = np.random.default_rng(5)
    feats, grid = _scene(rng, 2, 16, 24)
    t_grid = torch.tensor(grid, requires_grad=True)
    out = tcw.corr_weights(torch.tensor(feats, requires_grad=True), t_grid,
                           *tcw.prepare_params(_layers(_mlp(rng)), torch.float32), 3)
    (d_grid,) = torch.autograd.grad(out.sum(), t_grid, allow_unused=True)
    assert d_grid is None or not torch.any(d_grid)


def test_plain_bf16_close_to_oracle():
    rng = np.random.default_rng(2)
    feats, grid = _scene(rng, 2, 16, 24)
    mlp = _mlp(rng)
    got = _port(feats, grid, _layers(mlp), 3, torch.bfloat16)
    want = _jax(feats, grid, mlp, 3, jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=0.03)


def test_beyond_the_radius_the_port_drops_where_the_oracle_clamps():
    """Vertical displacements of up to 4.5 px against a radius of 1: equal
    at every pixel whose corners all lie within [y - 1, y + 2], different
    elsewhere; the port's weights there are those of the earlier branch
    with the far corners dropped."""
    rng = np.random.default_rng(6)
    feats, grid = _scene(rng, 2, 16, 24, max_disp_px=4.5)
    mlp = _mlp(rng)
    got = _port(feats, grid, _layers(mlp), 1).detach().numpy()
    want = _jax(feats, grid, mlp, 1)
    h = grid.shape[1]
    y = ((grid[..., 1] + 1) * h - 1) * 0.5
    y0 = np.floor(y)
    rows = np.arange(h)[None, :, None]
    inside = (y0 - rows >= -1) & (y0 + 1 - rows <= 2)
    np.testing.assert_allclose(got[inside], want[inside], atol=2e-5)
    assert np.abs(got[~inside] - want[~inside]).max() > 1e-3


def test_wrapper_takes_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version at any radius (the card's kernel
    stops at 6); nothing is launched."""
    rng = np.random.default_rng(7)
    feats, grid = _scene(rng, 2, 16, 24)
    layers = _layers(_mlp(rng))
    before = dict(tcw.LAUNCHES)
    params = tcw.prepare_params(layers, torch.float32)
    got = tcw.corr_weights(torch.tensor(feats), torch.tensor(grid), *params, 8)
    want = tcw.corr_weights_plain(torch.tensor(feats), torch.tensor(grid), *params, 8)
    assert torch.equal(got, want) and tcw.LAUNCHES == before
