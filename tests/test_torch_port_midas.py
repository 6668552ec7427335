"""MiDaS-small and the MiDaS backbone of the port vs flowmap_tpu (CPU, f32).

Weights are initialised by the JAX package and carried across with
`utils/params.py:from_jax_params`; the same NumPy inputs go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmap_tpu.model import ExtrinsicsProcrustesCfg, IntrinsicsSoftminCfg, ModelCfg
from flowmap_tpu.model.backbone.backbone_midas import BackboneMidasCfg as JCfg
from flowmap_tpu.model.backbone.backbone_midas import apply_midas, init_midas
from flowmap_tpu.model.backbone.midas_net import MidasSmall as JMidas
from flowmap_tpu.model.backbone.midas_net import midas_small_init
from flowmap_tpu.training.overfit import _autosize_warp_radius as j_autosize
from flowmap_tpu.utils.synthetic import SyntheticSceneCfg as JSceneCfg
from flowmap_tpu.utils.synthetic import make_scene as j_make_scene
from flowmap_tpu_torch.model.backbone.backbone_midas import BackboneMidas, BackboneMidasCfg
from flowmap_tpu_torch.model.backbone.midas_net import MidasSmall
from flowmap_tpu_torch.types import Batch, Flows
from flowmap_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("bn", ["folded", "batch"])
def test_midas_small_forward(bn):
    """Head output and decoder features within 2e-4 of their max (f32
    round-off through ~50 layers; batch-stat BN amplifies it)."""
    params = midas_small_init(jax.random.PRNGKey(0), fold_bn=bn == "folded")
    x = np.random.default_rng(0).normal(size=(2, 3, 64, 96)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        y_j, f_j = JMidas.apply_split(params, jnp.asarray(x), mapping="exp")
    model = MidasSmall(fold_bn=bn == "folded")
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        y_t, f_t = model(torch.from_numpy(x), mapping="exp")
    assert y_t.shape == (2, 64, 96) and f_t.shape == (2, 64, 32, 48)
    assert rel(y_t, y_j) < 2e-4
    assert rel(f_t, f_j) < 2e-4


def test_midas_small_original_mapping_relu():
    params = midas_small_init(jax.random.PRNGKey(1), fold_bn=True)
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        y_j, _ = JMidas.apply_split(params, jnp.asarray(x), mapping="original")
    model = MidasSmall(fold_bn=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        y_t, _ = model(torch.from_numpy(x), mapping="original")
    assert float(y_t.min()) >= 0.0
    assert rel(y_t, y_j) < 2e-4


def test_backbone_midas_native_weights():
    """Depths and the native-resolution correspondence weights (shift warp,
    split MLP, sigmoid and clip, upsample) within 2e-4 of their max."""
    # The first three frames of a 20-frame scene: small inter-frame flow.
    batch_j, flows_j, _ = j_make_scene(JSceneCfg(num_frames=20, image_shape=(64, 64)))
    batch_j = batch_j.replace(videos=batch_j.videos[:, :3], indices=batch_j.indices[:, :3])
    flows_j = jax.tree_util.tree_map(lambda a: a[:, :2], flows_j)
    j_cfg = JCfg(pretrained=False, mapping="exp", bn="folded", compute_dtype="float32")
    j_model_cfg = j_autosize(
        ModelCfg(backbone=j_cfg, intrinsics=IntrinsicsSoftminCfg(),
                 extrinsics=ExtrinsicsProcrustesCfg()),
        flows_j, 64,
    )
    j_cfg = j_model_cfg.backbone
    params = init_midas(j_cfg, 3, (64, 64), jax.random.PRNGKey(2))
    with jax.default_matmul_precision("highest"):
        out_j = apply_midas(j_cfg, params, batch_j, flows_j)

    t_cfg = BackboneMidasCfg(
        mapping="exp", bn="folded", compute_dtype="float32",
        warp_radius=j_cfg.warp_radius, warp_radius_x=j_cfg.warp_radius_x,
        warp_radius_half=j_cfg.warp_radius_half,
        warp_radius_half_x=j_cfg.warp_radius_half_x,
    )
    backbone = BackboneMidas(t_cfg)
    backbone.load_state_dict(from_jax_params(params), strict=True)
    batch = Batch(videos=torch.tensor(np.asarray(batch_j.videos)),
                  indices=torch.tensor(np.asarray(batch_j.indices)))
    flows = Flows(*(torch.tensor(np.asarray(a)) for a in (
        flows_j.forward, flows_j.backward, flows_j.forward_mask, flows_j.backward_mask)))
    with torch.no_grad():
        out_t = backbone(batch, flows)
    assert rel(out_t.depths, out_j.depths) < 2e-4
    assert rel(out_t.weights, out_j.weights) < 2e-4


def test_unported_branches_raise():
    backbone = BackboneMidas(BackboneMidasCfg(
        compute_dtype="float32", weights_resolution="full"))
    batch = Batch(videos=torch.zeros(1, 2, 3, 32, 32), indices=torch.arange(2)[None])
    flows = Flows(torch.zeros(1, 1, 32, 32, 2), torch.zeros(1, 1, 32, 32, 2),
                  torch.ones(1, 1, 32, 32), torch.ones(1, 1, 32, 32))
    with pytest.raises(NotImplementedError):
        backbone(batch, flows)
    wide = BackboneMidas(BackboneMidasCfg(compute_dtype="float32", warp_radius_half=8,
                                          warp_radius_half_x=8))
    with pytest.raises(NotImplementedError):
        wide(batch, flows)
