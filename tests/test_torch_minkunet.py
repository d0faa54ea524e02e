"""The port's MinkUNet encoder (plan + 21 sparse convs + eval batch norms up
to ``feat_bottleneck``) against the reference with its weights carried
across. float32, atol 1e-4: the same products summed in another order
through 21 convs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation3d_tpu.sparse.minkunet import MinkUNet as JMinkUNet
from situation3d_tpu.sparse.minkunet import build_unet_plan as jax_build_unet_plan
from situation3d_tpu.sparse.tensor import SparseVoxels as JSparseVoxels
from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables
from situation3d_tpu_torch.ops.cuda import fused_conv
from situation3d_tpu_torch.sparse.minkunet import MinkUNet, build_unet_plan
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

from torch_port_util import (randomize_variables, scene_batch, t2n, tiny_cfgs,
                             to_numpy_tree)

torch.set_num_threads(1)
ATOL = 1e-4
DECODER = ("convtr4p16s2", "bntr4", "block5", "convtr5p8s2", "bntr5", "block6",
           "convtr6p4s2", "bntr6", "block7", "convtr7p2s2", "bntr7", "block8", "final")


def _run(extra, seed, B, n_vox):
    jcfg, tcfg = tiny_cfgs(extra)
    rng = np.random.RandomState(seed)
    b = scene_batch(rng, tcfg, B, n_vox=n_vox)
    js, ts = jcfg.sparse, tcfg.sparse

    def jforward(v, coords, mask, feats):
        plan = jax_build_unet_plan(
            coords, mask, js.capacities, js.dense_lookup, js.grid_extent,
            need_k5=True, dense_downsample=js.dense_downsample,
            pallas_map=js.pallas_map, pallas_map_bits=js.pallas_map_bits)
        x = JSparseVoxels(coords=coords, feats=feats, mask=mask, stride=1)
        out = JMinkUNet(js).apply(v, x, plan, train=False)["feat_bottleneck"]
        return out.feats, out.coords, out.mask

    args = (jnp.asarray(b["voxel_coords"]), jnp.asarray(b["voxel_mask"]),
            jnp.asarray(b["voxel_feats"]))
    def jinit(coords, mask, feats):
        plan = jax_build_unet_plan(coords, mask, js.capacities, True,
                                   js.grid_extent, need_k5=True,
                                   dense_downsample=True)
        x = JSparseVoxels(coords=coords, feats=feats, mask=mask, stride=1)
        return JMinkUNet(js).init(jax.random.PRNGKey(0), x, plan, train=False)

    shapes = jax.eval_shape(jinit, *args)
    v = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.randn(*s.shape) / np.sqrt(max(np.prod(s.shape[:-1]), 1))
                               ).astype(np.float32)), shapes)
    v = randomize_variables(v, rng)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jforward)(v, *args)

    net = MinkUNet(ts)
    unused = load_jax_variables(net, to_numpy_tree(v["params"]),
                                to_numpy_tree(v["batch_stats"]))
    plan = build_unet_plan(b["voxel_coords"], b["voxel_mask"], ts.capacities,
                           ts.grid_extent, pallas_map=ts.pallas_map,
                           pallas_map_bits=ts.pallas_map_bits, device="cpu")
    x = SparseVoxels(torch.from_numpy(b["voxel_coords"]),
                     torch.from_numpy(b["voxel_feats"]),
                     torch.from_numpy(b["voxel_mask"]), 1)
    fused_conv.launches = 0
    with torch.no_grad():
        got = net.eval()(x, plan)["feat_bottleneck"]
    return got, want, unused


@pytest.mark.parametrize("extra,seed,B,n_vox", [
    ((), 0, 2, 300),                                 # reference on its XLA conv path
    (("sparse.pallas_map=force", "sparse.conv_flat_gather=false",
      "sparse.capacities=256,128,64,32,16"), 1, 1, 200),
], ids=["xla_convs", "pallas_interpret_maps"])
def test_minkunet_feat_bottleneck(extra, seed, B, n_vox):
    """Second case: the reference builds its k3 maps with the Pallas kernel
    in interpret mode and gathers with batched ``take_along_axis``. (Its fused
    conv kernel is held against the port's plain version op by op in
    ``test_torch_sparse_conv.py``: a whole encoder of interpret-mode convs
    takes minutes to trace.)"""
    got, (wf, wc, wm), unused = _run(extra, seed, B, n_vox)
    assert got.stride == 16 and got.feats.dtype == torch.float32
    np.testing.assert_array_equal(t2n(got.coords), np.asarray(wc))
    np.testing.assert_array_equal(t2n(got.mask), np.asarray(wm))
    assert float(np.abs(np.asarray(wf)).max()) > 1e-2      # not a comparison of zeros
    np.testing.assert_allclose(t2n(got.feats), np.asarray(wf), atol=ATOL, rtol=0)
    assert fused_conv.launches == 0                        # CPU: plain version only
    # what the converter left over is exactly the reference's decoder
    assert unused and all(u.split("/")[1] in DECODER for u in unused), unused
    assert {u.split("/")[1] for u in unused} == {
        "convtr4p16s2", "bntr4", "block5", "convtr5p8s2", "bntr5", "block6"}


def test_minkunet_refuses_unported_options():
    _, tcfg = tiny_cfgs(("sparse.final_result=true",))
    with pytest.raises(NotImplementedError):
        MinkUNet(tcfg.sparse)
