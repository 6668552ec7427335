"""The fused weight-MLP (kernel I) of the port vs flowmap_tpu (CPU).

The port's plain version (`ops/kernels/weight_mlp.py:weight_mlp_plain`, a
forward and a backward written out with the TPU kernel's rounding points)
against the JAX package's `weight_mlp`, both off the TPU (its XLA
formulation) and with the Pallas kernel in interpret mode, as
`tests/test_weight_mlp_kernel.py` runs it. The same NumPy inputs and
parameters go through both; the port takes the parameters in `nn.Linear`'s
(out, in) layout. Tolerances are the JAX package's: forward 2e-5, gradients
5e-4 absolute and 1e-3 relative, bf16 0.03.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.ops.pallas import runtime
from flowmap_tpu.ops.pallas import weight_mlp as jwm
from flowmap_tpu_torch.ops.kernels import weight_mlp as twm

torch.set_num_threads(1)

P = 1500  # not a multiple of the card's 64- or 32-pixel tiles


def _case(p=P, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    wa, la = mk(p, 64), mk(p, 64)
    params = ((mk(64, 128), mk(64, 128), mk(128)), (mk(128, 64), mk(64)), (mk(64, 1), mk(1)))
    return wa, la, params


def _torch_params(params, dtype=torch.float32):
    """((W0a, W0b, b0), (W1, b1), (W2, b2)) in JAX's (in, out) layout ->
    (w0, b0, w1, b1, w2, b2) in nn.Linear's, weights in `dtype`."""
    (w0a, w0b, b0), (w1, b1), (w2, b2) = params

    def weight(a):
        return torch.tensor(np.ascontiguousarray(a.T)).to(dtype).requires_grad_()

    def bias(a):
        return torch.tensor(a).to(dtype).float().requires_grad_()

    return (weight(np.concatenate([w0a, w0b], 0)), bias(b0), weight(w1), bias(b1),
            weight(w2), bias(b2))


def _jax_mode(mode):
    return runtime.pallas_mode("force") if mode == "interpret" else contextlib.nullcontext()


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_plain_forward_matches_jax(mode):
    wa, la, params = _case()
    with _jax_mode(mode):
        want = np.asarray(jwm.weight_mlp(jnp.asarray(wa), jnp.asarray(la), params))
    got = twm.weight_mlp_plain(torch.tensor(wa), torch.tensor(la), *_torch_params(params))
    assert got.shape == (P,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_plain_gradients_match_jax(mode):
    wa, la, params = _case(p=900, seed=1)
    weights = np.linspace(0.5, 1.5, 900).astype(np.float32)

    def j_loss(wa, la, params):
        return jnp.sum(jnp.sin(jwm.weight_mlp(wa, la, params)) * weights)

    with _jax_mode(mode):
        g_wa, g_la, g_params = jax.grad(j_loss, argnums=(0, 1, 2))(
            jnp.asarray(wa), jnp.asarray(la), params)
    t_wa = torch.tensor(wa, requires_grad=True)
    t_la = torch.tensor(la, requires_grad=True)
    t_params = _torch_params(params)
    y = twm.weight_mlp_plain(t_wa, t_la, *t_params)
    (torch.sin(y) * torch.tensor(weights)).sum().backward()
    (gw0a, gw0b, gb0), (gw1, gb1), (gw2, gb2) = g_params
    want = [g_wa, g_la, np.concatenate([gw0a, gw0b], 0).T, gb0, np.asarray(gw1).T, gb1,
            np.asarray(gw2).T, gb2]
    got = [t_wa.grad, t_la.grad] + [t.grad for t in t_params]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3)


def test_plain_bf16_close_to_jax():
    """bf16 inputs and weights against the Pallas kernel in interpret mode,
    which rounds where the port does: within 0.03 (the JAX package's bf16
    tolerance) on logits of magnitude ~7."""
    wa, la, params = _case(seed=2)
    j_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    with runtime.pallas_mode("force"):
        want = np.asarray(jwm.weight_mlp(jnp.asarray(wa, jnp.bfloat16),
                                         jnp.asarray(la, jnp.bfloat16), j_params))
    got = twm.weight_mlp_plain(torch.tensor(wa).bfloat16(), torch.tensor(la).bfloat16(),
                               *_torch_params(params, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=0.03)


def test_plain_backward_rounds_where_the_kernel_does():
    """In bf16 the plain backward rounds dz1 and dz0 before their products
    and returns bf16 weight gradients with f32 bias sums; in f32 it is the
    exact gradient (autograd of the forward)."""
    wa, la, params = _case(p=300, seed=3)
    for dtype in (torch.bfloat16, torch.float32):
        t_params = _torch_params(params, dtype)
        y = twm.weight_mlp_plain(torch.tensor(wa).to(dtype), torch.tensor(la).to(dtype),
                                 *t_params)
        y.sum().backward()
        assert [t.grad.dtype for t in t_params] == [dtype, torch.float32] * 3
    x = torch.tensor(np.concatenate([wa, la], 1), requires_grad=True)
    t_params = _torch_params(params)
    y_auto, _, _ = twm.mlp_forward_plain(x, *t_params)
    dy = torch.tensor(np.random.default_rng(4).normal(size=300).astype(np.float32))
    auto = torch.autograd.grad(y_auto, [x] + list(t_params), dy)
    w0, _, w1, _, w2, _ = t_params
    y, x0, x1 = twm.mlp_forward_plain(x, *t_params)
    manual = twm.mlp_backward_plain(x.detach(), w0.detach(), w1.detach(), w2.detach(),
                                    x0.detach(), x1.detach(), dy)
    for a, m in zip(auto, manual):
        np.testing.assert_allclose(m.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu():
    wa, la, params = _case(p=200, seed=5)
    before = dict(twm.LAUNCHES)
    got = twm.weight_mlp(torch.tensor(wa), torch.tensor(la), *_torch_params(params))
    want = twm.weight_mlp_plain(torch.tensor(wa), torch.tensor(la), *_torch_params(params))
    assert torch.equal(got, want)
    assert twm.LAUNCHES == before
